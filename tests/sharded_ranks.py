"""What each rank of the port's sharded-serving tests runs
(tests/test_torch_sharded_serving.py on the CPU, tests/test_torch_cuda.py
on the card).  It imports the port and numpy and nothing of JAX, so a
rank spawned with ``repro_torch.launch.mesh.spawn`` never loads it.

The configs and the trace are the twins of tests/test_sharding.py's
``_serving_cfg`` and ``_trace``: reduced fp32 configs whose KV heads
divide a 4-way model axis, six requests of a seeded generator."""
import os

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.config import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.scheduler import PreemptiveScheduler
from repro_torch.tree import tree_leaves

F32 = dict(param_dtype="float32", activation_dtype="float32")
ENGINE_KW = dict(n_slots=3, max_seq=64, page_size=8, prefill_budget_tokens=16)
PREEMPT_KW = dict(n_slots=2, max_seq=64, page_size=8, prefill_budget_tokens=4)
PREEMPT_PROMPT = np.arange(1, 15, dtype=np.int32)
# the archs of the sweep, each with its trace's request count
SWEEP = (("smollm-360m", 6), ("qwen3-moe-30b-a3b", 4),
         ("deepseek-v3-671b", 4))


def serving_cfg(arch: str):
    """The reference test's ``_serving_cfg``: fp32; smollm at 8/4 heads
    of 32, qwen3-moe with 4 KV heads, deepseek-v3 as reduced."""
    over = dict(F32)
    if arch == "smollm-360m":
        over.update(n_heads=8, n_kv_heads=4, head_dim=32)
    elif arch == "qwen3-moe-30b-a3b":
        over.update(n_kv_heads=4)
    return get_reduced_config(arch).with_(**over)


def replicated_cfg():
    """Reduced smollm at the published model's 15/5 heads (of 16): no
    head count divides a 2-way axis, so attention and the pool
    replicate while the vocab and d_ff split."""
    return get_reduced_config("smollm-360m").with_(n_heads=15, n_kv_heads=5,
                                                   head_dim=16, **F32)


def trace(cfg, n=6):
    r = np.random.default_rng(3)
    lens = [5, 17, 9, 30, 12, 3][:n]
    news = [8, 6, 12, 4, 10, 16][:n]
    return [Request(prompt=r.integers(0, cfg.vocab_size,
                                      size=s).astype(np.int32),
                    max_new=m, rid=i, arrival_t=float(i // 2))
            for i, (s, m) in enumerate(zip(lens, news))]


def local_bytes(eng) -> int:
    """The bytes of the rank's pool leaves, measured on the tensors."""
    return int(sum(t.numel() * t.element_size()
                   for t in tree_leaves(eng.slots.cache)))


def _drained(eng) -> bool:
    a = eng.slots.allocator
    return a.in_use == 0 and a.reserved == 0 and len(a._free) == a.n_pages


def numpy_tree(tree) -> dict:
    """A params tree with numpy leaves (what ``params_from_numpy``
    takes, and what pickles to a spawned rank)."""
    return {k: numpy_tree(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _params(np_tree, cfg, device):
    return params_from_numpy(np_tree, cfg, device=device)


def serve(mesh, arch, np_tree, n, device="cpu") -> dict:
    """The reference test's ``_sweep`` trace on a ``mesh`` engine."""
    cfg = serving_cfg(arch)
    eng = ContinuousEngine(cfg, _params(np_tree, cfg, device), mesh=mesh,
                           **ENGINE_KW)
    ops.reset_launches()
    res = eng.run(trace(cfg, n))
    return dict(tokens={rid: r.tokens for rid, r in res.items()},
                stats=eng.kv_cache_stats(), local_bytes=local_bytes(eng),
                overflows=list(eng.moe_overflows), drained=_drained(eng),
                launches=ops.launch_counts(),
                decode_steps=eng.decode_steps_total)


def preempt_and_checkpoint(mesh, np_tree, ckpt: str, device="cpu") -> dict:
    """The reference test's preempt -> spill -> resume round trip and
    mid-flight checkpoint on a ``mesh`` engine: a probe preempted after
    its first chunks while a filler recycles its pages, then the probe
    alone, checkpointed after 4 ticks (written to ``ckpt``) and restored
    into ``clone_fresh()``."""
    cfg = serving_cfg("smollm-360m")
    params = _params(np_tree, cfg, device)
    eng = ContinuousEngine(cfg, params, mesh=mesh, **PREEMPT_KW)
    sched = PreemptiveScheduler(eng)
    probe = Request(prompt=PREEMPT_PROMPT.copy(), max_new=6)
    sched.submit(probe)
    sched.step()
    sched.step()
    (slot,) = [s for s in eng.slots.active_slots()
               if eng.slots.states[s].request.rid == probe.rid]
    sched.preempt(slot)
    sched.submit(Request(prompt=PREEMPT_PROMPT[:5].copy(), max_new=3))
    sched.step()
    sched.step()
    res = sched.run()
    out = dict(preempted=res[probe.rid].tokens,
               n_preemptions=res[probe.rid].n_preemptions,
               preempt_drained=_drained(eng))
    eng2 = ContinuousEngine(cfg, params, mesh=mesh, **PREEMPT_KW)
    sched2 = PreemptiveScheduler(eng2)
    p2 = Request(prompt=PREEMPT_PROMPT.copy(), max_new=6)
    sched2.submit(p2)
    for _ in range(4):
        sched2.step()
    out["ckpt_bytes"] = sched2.checkpoint(ckpt)
    fresh = eng2.clone_fresh()
    out["clone_keeps_mesh"] = fresh.mesh is mesh
    sched3 = PreemptiveScheduler(fresh)
    sched3.restore(ckpt)
    out["restored"] = sched3.run()[p2.rid].tokens
    return out


def run_world(mesh, trees: dict, replicated_tree, tmp: str) -> dict:
    """Every scenario of the CPU test in one world: the three sweeps,
    the preempt/checkpoint round trips (checkpoint written under
    ``tmp``), then a 2-rank mesh of the world's first two ranks on
    ``replicated_cfg``."""
    torch.manual_seed(0)
    out = {"rank": mesh.rank, "size": mesh.size}
    for arch, n in SWEEP:
        out[arch] = serve(mesh, arch, trees[arch], n)
    out["preempt"] = preempt_and_checkpoint(
        mesh, trees["smollm-360m"], os.path.join(tmp, "sharded.ckpt"))
    from repro_torch.launch.mesh import make_serving_mesh
    pair = make_serving_mesh(2)           # every rank takes part
    if pair is not None:
        cfg = replicated_cfg()
        eng = ContinuousEngine(cfg, _params(replicated_tree, cfg, "cpu"),
                               mesh=pair, **ENGINE_KW)
        res = eng.run(trace(cfg))
        out["pair"] = dict(tokens={rid: r.tokens for rid, r in res.items()},
                           stats=eng.kv_cache_stats(),
                           local_bytes=local_bytes(eng))
    return out


def two_rank_cuda(mesh, np_tree) -> dict:
    """The card's 2-rank check: the dense sweep on cuda ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return serve(mesh, "smollm-360m", np_tree, 6, device="cuda")

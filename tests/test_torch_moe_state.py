"""The scheduler surface of the port on the moe family's KV trees: two
stacks (``blocks_dense``, ``blocks_moe``) and, for deepseek-v3, MLA's
latent leaves ``ckv``/``krope`` in place of ``k``/``v``.  Reduced
qwen3-moe and deepseek-v3 in fp32 on the CPU.

On the port, as tests/test_scheduler.py and tests/test_constellation.py
hold the reference to it (their moe/MLA sweeps): preempt and resume at
several decode steps (spill, resident), token-exact against an
uninterrupted run; a re-preemption ships only a KV delta; a checkpoint
mid-run restores into a fresh engine token-exactly; a paged snapshot
relocated to other pages comes back bit-exact.  Against the reference:
a handover file packed by either package grafts in the other and
resumes to the same tokens (params made by the port and handed to JAX
as numpy leaves)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro_torch.config import get_reduced_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.serving.scheduler import PreemptiveScheduler  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v3-671b"]
F32 = dict(param_dtype="float32", activation_dtype="float32")
MAX_SEQ, PAGE, POOL = 64, 8, 12
KW = dict(n_slots=2, max_seq=MAX_SEQ, page_size=PAGE, pool_pages=POOL,
          prefill_budget_tokens=16)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread for this file (the suite runs
    files in parallel workers), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = get_reduced_config(arch).with_(**F32)
        _MODELS[arch] = cfg, T.init_params(cfg, seed=0, device="cpu")
    return _MODELS[arch]


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 512, n).astype(np.int32)


def _solo(cfg, params, prompt, max_new, **kw):
    eng = ContinuousEngine(cfg, params, **{**KW, **kw})
    res = eng.run([Request(prompt=prompt.copy(), max_new=max_new)])
    return list(res.values())[0].tokens


def _assert_drained(eng):
    alloc = getattr(eng.slots, "allocator", None)
    if alloc is not None:
        assert alloc.in_use == 0 and alloc.reserved == 0
        assert len(alloc._free) == alloc.n_pages


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,layout", [("spill", "paged"),
                                         ("resident", "paged"),
                                         ("spill", "contiguous")])
def test_preempt_resume_token_exact(arch, mode, layout):
    cfg, params = _model(arch)
    max_new = 6
    prompt, filler = _prompt(19, 1), _prompt(5, 2)
    want = _solo(cfg, params, prompt, max_new, kv_layout=layout)
    eng = ContinuousEngine(cfg, params, **{**KW, "kv_layout": layout})
    sched = PreemptiveScheduler(eng, preempt_mode=mode)
    for k in (0, 3):
        probe = Request(prompt=prompt.copy(), max_new=max_new)
        sched.submit(probe)
        sched.step(decode=False)
        sched._admit_by_priority()
        for _ in range(k):
            sched.step()
        (slot,) = [s for s in eng.slots.active_slots()
                   if eng.slots.states[s].request.rid == probe.rid]
        sched.preempt(slot)
        assert sched.swapped[probe.rid].spilled == (mode == "spill")
        sched.submit(Request(prompt=filler.copy(), max_new=3))
        sched.step()
        sched.step()
        res = sched.run()
        np.testing.assert_array_equal(res[probe.rid].tokens, want)
        assert res[probe.rid].n_preemptions == 1
        _assert_drained(eng)


@pytest.mark.parametrize("arch", ARCHS)
def test_re_preemption_ships_only_the_delta(arch):
    cfg, params = _model(arch)
    prompt = _prompt(30, 3)
    want = _solo(cfg, params, prompt, 20, n_slots=1, pool_pages=None)
    eng = ContinuousEngine(cfg, params, **{**KW, "n_slots": 1,
                                           "pool_pages": None})
    sched = PreemptiveScheduler(eng)
    req = Request(prompt=prompt.copy(), max_new=20)
    sched.submit(req)
    for _ in range(6):
        sched.step()
    sched.preempt(0)
    first = sched.store.bytes_spilled
    for _ in range(4):
        sched.step()
    sched.preempt(0)
    assert sched.store.n_delta_spills == 1
    assert sched.store.bytes_spilled - first < first
    res = sched.run()
    np.testing.assert_array_equal(res[req.rid].tokens, want)
    _assert_drained(eng)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restore_into_fresh_engine(arch, tmp_path):
    cfg, params = _model(arch)
    rng = np.random.default_rng(5)
    trace = [Request(prompt=_prompt(int(rng.integers(4, 20)), 10 + i),
                     max_new=int(rng.integers(3, 8)), arrival_t=float(i))
             for i in range(4)]
    want = ContinuousEngine(cfg, params, **KW).run(
        [r.clone() for r in trace])
    want = [want[k].tokens for k in sorted(want)]
    eng = ContinuousEngine(cfg, params, **KW)
    sched = PreemptiveScheduler(eng)
    reqs = [r.clone() for r in trace]
    for r in reqs:
        sched.submit(r)
    for t in range(5):
        sched.step()
        if t == 2:
            sched.preempt(eng.slots.active_slots()[0], "spill")
    path = str(tmp_path / "s.ckpt")
    assert sched.checkpoint(path) > 0
    fresh = PreemptiveScheduler(eng.clone_fresh())
    fresh.restore(path)
    res = fresh.run()
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(res[r.rid].tokens, w)
    _assert_drained(fresh.engine)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_snapshot_relocates_bit_exact(arch):
    cfg, params = _model(arch)
    eng = ContinuousEngine(cfg, params, **{**KW, "n_slots": 1})
    eng.submit(Request(prompt=_prompt(13, 6), max_new=4))
    eng.step()
    (slot,) = eng.slots.active_slots()
    src = eng.slots.states[slot].pages
    snap = T.extract_paged_cache(eng.slots.cache, src)
    assert sorted(snap) == [n for n, _ in T.attn_stacks(cfg)]
    dst = [p + 4 for p in src]
    T.graft_paged_cache(eng.slots.cache, snap, dst)
    back = T.extract_paged_cache(eng.slots.cache, dst)
    for a, b in zip(tree_leaves(snap), tree_leaves(back)):
        assert torch.equal(a, b)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_handover_file_crosses_packages(arch, writer, tmp_path):
    """A sequence spilled mid-decode and packed by one package grafts on
    the other's peer and finishes with the solo run's tokens."""
    from repro.serving import batching as jB, constellation as jC
    from repro.serving import engine as jE, scheduler as jS
    from repro_torch.serving import batching as tB, constellation as tC
    from repro_torch.serving import engine as tE, scheduler as tS
    cfg, tp = _model(arch)
    jcfg = j_reduced(arch).with_(**F32)
    jp = jax.tree.map(jnp.asarray, _numpy(tp))
    sides = {"jax": (jE, jB, jS, jC, jcfg, jp),
             "port": (tE, tB, tS, tC, cfg, tp)}
    prompt = _prompt(11, 8)
    E, B, S, C, c, p = sides[writer]
    eng = E.ContinuousEngine(c, p, kv_layout="paged", **KW)
    src = S.PreemptiveScheduler(eng)
    rid = src.submit(B.Request(prompt=prompt.copy(), max_new=8))
    for _ in range(4):
        src.step()
    src.preempt(eng.slots.active_slots()[0], "spill")
    entry = src.swapped.pop(rid)
    kv = src.store.snapshot(rid)
    path = str(tmp_path / "seq.ckpt")
    C.pack_sequence(path, entry, kv, entry.preempted_step)
    src.store.drop(rid)
    want = _solo(cfg, tp, prompt, 8)
    E, B, S, C, c, p = sides["port" if writer == "jax" else "jax"]
    dst = S.PreemptiveScheduler(E.ContinuousEngine(c, p, kv_layout="paged",
                                                   **KW))
    assert C.graft_sequence(dst, path) == rid
    while dst.has_work():
        dst.step()
    np.testing.assert_array_equal(np.asarray(dst.results[rid].tokens), want)

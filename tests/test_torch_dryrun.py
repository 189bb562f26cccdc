"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's rules and launchers: rank 0's slices of the params, both AdamW
moments and the decode cache of the FULL configs on a (16, 16) mesh,
built on the meta device, have the shapes of the reference's rule
functions on an ``AbstractMesh`` (``params_pspecs``, ``cache_pspecs``),
but where ``tests/test_torch_pspec.py::_departure`` says why not (the
cache under ``baseline``, ``infer-tp`` and ``infer-tp2`` with none), and
their bytes are those shapes' (the moments bf16 above 1e11 params, as
the reference's ``_moment_dtype``); ``--all`` writes a result for a
pair the port builds (every pair of every family since the xLSTM cut)
and a skipped row naming why for one the reference does not support;
``--multi-pod`` builds rank 0's step on the reference's (2, 16, 16) mesh
of axes ("pod", "data", "model"); both launchers' ``--dry-run`` run;
the prefill and serve steps and the MoE dispatch threaded through
them.
(The reference's own ``dryrun_one`` raises on jax 0.9.0, ROADMAP Queue
3 item 8, so its rules stand in for it.)"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_config as j_config  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro_torch.config import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from test_sharding import _abstract_mesh  # noqa: E402
from test_torch_pspec import (_departure, _reference_leaves,  # noqa: E402
                              _reference_slice)

torch.set_num_threads(1)
MESH = (16, 16)
PAIRS = [("smollm-360m", "baseline"), ("smollm-360m", "dp"),
         ("qwen3-moe-30b-a3b", "baseline"), ("deepseek-v3-671b", "baseline"),
         ("granite-20b", "baseline"), ("qwen1.5-4b", "baseline"),
         ("qwen3-moe-30b-a3b", "ep"), ("deepseek-v3-671b", "ep"),
         ("qwen3-moe-30b-a3b", "dp"), ("deepseek-v3-671b", "dp")]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@pytest.mark.parametrize("arch,preset", PAIRS)
def test_rank0_params_and_moments_follow_the_reference_rules(arch, preset):
    jcfg, cfg = j_config(arch), get_config(arch)
    shape = INPUT_SHAPES["train_4k"]
    built = D.build_step(cfg, shape, sharding=preset, mesh=MESH)
    params, state, batch = built["args"]
    jm = _abstract_mesh(MESH, ("data", "model"))
    lm = JSH.SHARDING_PRESETS[preset]
    want = _reference_leaves(JSP.params_specs(jcfg, max_seq=shape.seq_len))
    moment = torch.bfloat16 if JD._moment_dtype(jcfg) == "bfloat16" \
        else torch.float32
    assert D._moment_dtype(cfg) == JD._moment_dtype(jcfg)
    kept = 0
    for (path, p), (_, mu), (_, nu) in zip(
            tree_leaves_with_path(params), tree_leaves_with_path(state["mu"]),
            tree_leaves_with_path(state["nu"])):
        assert p.is_meta and mu.shape == nu.shape == p.shape, path
        assert mu.dtype == nu.dtype == moment
        ref = _reference_slice(jm, lm, *want[path])
        if tuple(p.shape) != ref:
            assert _departure(cfg, path, MESH[1]) is not None, (path, ref)
        else:
            kept += _nbytes(p)
    assert kept > 0
    assert built["param_bytes"] == sum(_nbytes(t) for _, t in
                                       tree_leaves_with_path(params))
    assert built["moment_bytes"] == 2 * sum(
        t.numel() for _, t in tree_leaves_with_path(params)) \
        * moment.itemsize
    # each rank's rows of the 256-row batch: 16 over "data" (dp: 1 each
    # over both axes)
    assert batch["tokens"].shape == (256 // (256 if preset == "dp" else 16),
                                     4096)
    assert batch["tokens"].dtype == torch.int32


@pytest.mark.parametrize("preset", ["baseline", "infer-tp", "infer-tp2"])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b", "qwen1.5-4b",
                                  "granite-20b"])
def test_rank0_cache_follows_the_reference_rules(arch, preset):
    """Every leaf of rank 0's decode_32k cache has the shape of the
    reference's ``cache_logical_axes`` slice under the preset, with no
    departure: the positions of a cache whose KV heads do not divide 16
    cut 16 ways over "model" under ``baseline`` and ``infer-tp``, and
    kept whole under ``infer-tp2`` (its "seq" maps to no axis, its batch
    to the absent "pod")."""
    jcfg, cfg = j_config(arch), get_config(arch)
    shape = INPUT_SHAPES["decode_32k"]
    built = D.build_step(cfg, shape, mesh=MESH, sharding=preset)
    cache = built["args"][1]
    jm = _abstract_mesh(MESH, ("data", "model"))
    want = _reference_leaves(JSP.decode_specs(jcfg, shape)["cache"])
    rows = 128 if preset == "infer-tp2" else 128 // 16
    for path, leaf in tree_leaves_with_path(cache):
        jpath, jleaf = want[path]
        specs = _cache_specs(jm, jcfg, jleaf, jpath,
                             JSH.SHARDING_PRESETS[preset])
        ref = tuple(s // _size(jm, e) for s, e in zip(jleaf.shape, specs))
        assert leaf.shape[1] == ref[1] == rows, path     # the batch
        assert tuple(leaf.shape) == ref, (path, ref)
        if path[-1] in ("k", "v") and preset != "infer-tp2":
            assert leaf.shape[2] == shape.seq_len // 16, path
    assert built["cache_bytes"] == sum(_nbytes(t) for _, t in
                                       tree_leaves_with_path(cache))


def _cache_specs(jm, jcfg, jleaf, jpath, lm=None) -> tuple:
    from repro.models import pspec as JPS
    with JPS.mesh_rules(jm, lm):
        return tuple(JPS.pspec_for(jleaf.shape, JSH.cache_logical_axes(
            jcfg, jpath, jleaf)))


def _size(jm, entry) -> int:
    if entry is None:
        return 1
    return int(np.prod([jm.shape[a] for a in (
        entry if isinstance(entry, tuple) else (entry,))]))


def test_all_writes_results_and_names_what_is_not_ported(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(D, "ARCH_IDS", ("smollm-360m", "zamba2-7b",
                                        "whisper-tiny"))
    monkeypatch.setattr(D, "INPUT_SHAPES", {
        k: INPUT_SHAPES[k] for k in ("decode_32k", "long_500k")})
    with pytest.raises(SystemExit) as e:
        D.main(["--all", "--json", str(tmp_path)])
    assert e.value.code == 0
    rows = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert len(rows) == 6
    layers = {"smollm": 32, "zamba2": 13, "whisper": 8}  # decode launches
    for name, r in rows.items():
        if name != "whisper-tiny__long_500k__single.json":
            assert r["mesh"] == "16x16" and r["n_devices"] == 256
            assert r["kernels"] == {"decode_attention":
                                    layers[name.split("-")[0]]}, name
            assert r["memory"]["generated_code_bytes"] is None
            assert set(r["collectives_by_axis"]) == {"data", "model",
                                                     "mesh"}
            assert r["collectives"]["total_link_bytes"] > 0
        else:          # whisper has no long_500k pair, as the reference
            assert r["skipped"], name
            assert "unsupported" in r["reason"]
    # long_500k's one row replicates over "data" and reads a 4096 ring
    assert rows["smollm-360m__long_500k__single.json"]["batch_rows"] == 1
    assert rows["smollm-360m__long_500k__single.json"][
        "sliding_window"] == 4096
    # the presets the exchange opened build train_4k: qwen3-moe under dp
    # exchanges over "model" six times a layer (its 128 experts 8 a rank,
    # the tokens one row a rank); smollm under ep is baseline's step, and
    # under infer-tp gathers no weight over "data" (no FSDP)
    moe = get_config("qwen3-moe-30b-a3b")
    for arch, preset in (("qwen3-moe-30b-a3b", "dp"), ("smollm-360m", "ep"),
                         ("smollm-360m", "infer-tp")):
        r = D.dryrun_one(arch, INPUT_SHAPES["train_4k"], sharding=preset,
                         verbose=False)
        n_layers = get_config(arch).n_layers
        assert r["kernels"] == {"flash_attention": 2 * n_layers}, arch
        a2a = {a: k["all-to-all"]["count"]
               for a, k in r["collectives_by_axis"].items()}
        want = 6 * moe.n_layers if arch == moe.name else 0
        assert a2a == {"data": 0, "model": want, "mesh": 0}, (arch, a2a)
        gathers = r["collectives_by_axis"]["data"]["all-gather"]["count"]
        assert (gathers > 0) == (preset != "infer-tp"), (preset, gathers)
    # --multi-pod: the (2, 16, 16) mesh, as the reference's result names it
    res = D.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                  "--multi-pod"])
    assert res["mesh"] == "2x16x16" and res["n_devices"] == 512
    assert res["batch_rows"] == 128 // 32


def test_multi_pod_counts_the_pod_collectives_at_the_network_rate():
    """``dryrun_one(..., multi_pod=True)``: rank 0's train_4k step of
    qwen3-moe-30b-a3b on (2, 16, 16) under ``baseline`` gathers its
    FSDP-cut weights and sums their gradients over ("pod", "data") (32
    ranks, "pod,data"), as often as a rank of the (16, 16) mesh over
    "data" and gathering as many bytes, from slices half as large (its
    param bytes fewer); its rows are 256 / 32; the roofline charges the group, which
    crosses nodes, at the network's rate.  xlstm-1.3b's decode_32k step
    gathers its FSDP-cut weights there too, and its cache (the xLSTM
    state on whole heads, which its 4 heads leave whole over "model")
    is a rank's 64-row cut over ("pod", "data")."""
    from repro_torch.analysis import roofline as R
    from repro_torch.launch import mesh as MESH
    r = D.dryrun_one("qwen3-moe-30b-a3b", "train_4k", multi_pod=True,
                     verbose=False)
    one = D.dryrun_one("qwen3-moe-30b-a3b", "train_4k", verbose=False)
    assert r["mesh"] == "2x16x16" and r["batch_rows"] == 256 // 32
    pod = r["collectives_by_axis"]["pod,data"]
    assert pod["all-gather"]["count"] == \
        one["collectives_by_axis"]["data"]["all-gather"]["count"] > 0
    assert pod["all-gather"]["bytes"] == \
        one["collectives_by_axis"]["data"]["all-gather"]["bytes"]
    assert r["param_bytes"] < one["param_bytes"]
    assert not R.axis_in_node("2x16x16", "pod,data")
    assert R.link_bandwidth("2x16x16", "pod") == MESH.NETWORK_BYTES_PER_S
    by_axis = r["collectives_by_axis"]
    assert R.collective_s(r) == pytest.approx(sum(
        k["link_bytes"] / R.link_bandwidth("2x16x16", a)
        for a, k in by_axis.items() if k["link_bytes"]), rel=1e-12)
    x = D.dryrun_one("xlstm-1.3b", "decode_32k", multi_pod=True,
                     verbose=False)
    assert x["collectives_by_axis"]["pod,data"]["all-gather"]["count"] > 0
    assert x["batch_rows"] == 128 // 32
    assert x["cache_bytes"] > x["rule_cache_bytes"]


def test_launchers_dry_run(capsys):
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    from repro_torch.config import get_reduced_config
    cfg = get_reduced_config("smollm-360m")
    res = LT.main(["--reduced", "--dry-run", "--mesh", "2x2"])
    assert res["kind"] == "train" and res["mesh"] == "2x2"
    assert res["kernels"] == {"flash_attention": 2 * cfg.n_layers}
    assert res["collectives_by_axis"]["data"]["all-gather"]["count"] > 0
    res = LS.main(["--reduced", "--dry-run"])
    assert res["kind"] == "decode" and res["mesh"] == "16x16"
    assert res["kernels"] == {"decode_attention": cfg.n_layers}
    res = LS.main(["--reduced", "--dry-run", "--shape", "prefill_32k"])
    assert res["kind"] == "prefill"
    assert res["kernels"] == {"flash_attention": cfg.n_layers}
    assert '"flops_per_device"' in capsys.readouterr().out


def test_prefill_and_serve_steps_and_the_moe_dispatch():
    """One rank on the CPU: ``make_prefill_step`` is ``prefill`` (the
    einsum and scatter dispatches agree), ``make_serve_step`` is
    ``decode_step``, and the train step takes the dispatch too."""
    from repro_torch.config import get_reduced_config
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.training import optim
    cfg = get_reduced_config("qwen3-moe-30b-a3b").with_(
        param_dtype="float32", activation_dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu", max_seq=32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    outs = {d: ST.make_prefill_step(cfg, moe_dispatch=d)(params,
                                                        {"tokens": toks})
            for d in ("einsum", "scatter")}
    want = T.prefill(params, cfg, {"tokens": toks})
    torch.testing.assert_close(outs["einsum"][0], want[0], atol=0, rtol=0)
    torch.testing.assert_close(outs["scatter"][0], want[0], atol=1e-5,
                               rtol=1e-5)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    got, _ = ST.make_serve_step(cfg)(params, cache, toks[:, :1], 3)
    cache2 = T.init_cache(cfg, 2, 32, device="cpu")
    again, _ = T.decode_step(params, cfg, cache2, toks[:, :1], 3)
    torch.testing.assert_close(got, again, atol=0, rtol=0)
    opt = optim.OptimConfig()
    st = optim.adamw_init(params, opt)
    m = {d: ST.make_train_step(cfg, opt, moe_dispatch=d)(
        params, st, {"tokens": toks})[2]["loss"] for d in ("einsum",
                                                           "scatter")}
    torch.testing.assert_close(m["einsum"], m["scatter"], atol=1e-5,
                               rtol=1e-5)


def test_all_builds_the_serving_presets_and_names_what_stays(tmp_path,
                                                            monkeypatch):
    """``--all --sharding infer-tp`` and ``infer-tp2`` build the
    training, decode and long-context rows of a dense config; ``ep`` and
    ``dp`` with experts build decode_32k (under ``ep`` qwen3-moe's 128
    experts take "data" alone, 8 a rank, and the tokens exchange over it
    there and back a layer; under ``dp`` its 128 rows cut over "data"
    alone, so the experts' "model" cuts no token and nothing is
    exchanged); under ``baseline``
    qwen1.5-4b's ``decode_32k`` reads its cache cut 16 ways over
    "model" (6.7 GB of it a rank, the peak under 10 GB; 107.7 GB with
    the cache whole on each "model" rank), one gather of the partials a
    layer on that axis."""
    monkeypatch.setattr(D, "ARCH_IDS", ("smollm-360m",))
    monkeypatch.setattr(D, "INPUT_SHAPES", {
        k: INPUT_SHAPES[k] for k in ("train_4k", "decode_32k",
                                     "long_500k")})
    for preset in ("infer-tp", "infer-tp2"):
        with pytest.raises(SystemExit) as e:
            D.main(["--all", "--sharding", preset, "--json",
                    str(tmp_path / preset)])
        assert e.value.code == 0
        rows = {p.name: json.loads(p.read_text())
                for p in (tmp_path / preset).glob("*.json")}
        assert len(rows) == 3
        for name, r in rows.items():
            assert name.endswith(f"__{preset}.json")
            assert r["sharding"] == preset
            if "train_4k" in name:
                assert r["kernels"] == {"flash_attention": 64}
            else:
                assert r["kernels"] == {"decode_attention": 32}
    moe = get_config("qwen3-moe-30b-a3b")
    for preset, a2a in (("ep", 2 * moe.n_layers), ("dp", 0)):
        r = D.dryrun_one(moe.name, "decode_32k", sharding=preset,
                         verbose=False)
        assert r["kernels"] == {"decode_attention": moe.n_layers}
        got = {a: k["all-to-all"]["count"]
               for a, k in r["collectives_by_axis"].items()}
        assert got == {"data": a2a, "model": 0, "mesh": 0}, (preset, got)
        assert r["batch_rows"] == 128 // 16
    r = D.dryrun_one("qwen1.5-4b", "decode_32k", verbose=False)
    cfg = get_config("qwen1.5-4b")
    whole = (2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads
             * cfg.resolved_head_dim * 2)
    assert r["cache_bytes"] == whole // 16 // 16        # rows, positions
    assert r["peak_bytes"] < 10e9
    gathers = r["collectives_by_axis"]["model"]["all-gather"]["count"]
    assert gathers == cfg.n_layers + 1                 # + the logits


def test_serve_dry_run_takes_the_serving_presets():
    from repro_torch.launch import serve as LS
    from repro_torch.config import get_reduced_config
    cfg = get_reduced_config("qwen3-moe-30b-a3b")
    for preset in ("infer-tp", "infer-tp2"):
        res = LS.main(["--arch", "qwen3-moe-30b-a3b", "--reduced",
                       "--dry-run", "--sharding", preset, "--mesh", "2x2"])
        assert res["sharding"] == preset and res["mesh"] == "2x2"
        assert res["kernels"] == {"decode_attention": cfg.n_layers}
    # infer-tp2: the experts and heads over both axes, every collective
    # of the layers over the whole mesh; infer-tp: over "model"
    assert res["collectives_by_axis"]["mesh"]["all-reduce"]["count"] > 0
    # ep on (2, 2): the reduced config's 4 experts one a rank, its decode
    # rows over "data", exchanged there and back a layer
    res = LS.main(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--dry-run",
                   "--sharding", "ep", "--mesh", "2x2"])
    assert res["kernels"] == {"decode_attention": cfg.n_layers}
    assert res["collectives_by_axis"]["data"]["all-to-all"]["count"] \
        == 2 * cfg.n_layers

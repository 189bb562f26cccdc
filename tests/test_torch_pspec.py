"""The port's sharding rules (``repro_torch.models.pspec``,
``repro_torch.launch.sharding``) against the reference's, in process:
the reference's functions run on ``AbstractMesh``es without devices, as
tests/test_sharding.py runs them, the port's on a ``MeshShape`` of the
same axes and sizes, under the same logical maps (the default, every
preset and the serving map).  Held equal: ``pspec_for`` (its
divisibility fallback and duplicate-axis guard), ``shard_count``,
``param_logical_axes`` and the specs of every leaf of the reduced
dense, moe, MLA and GELU param trees, ``cache_logical_axes`` on every
contiguous-cache leaf and ``paged_cache_logical_axes`` on every pool
leaf, with the pool's per-rank shapes; the per-device pool ledger
(a twin of ``test_per_device_pool_accounting_matches_ledger``); and
under the training presets ``baseline``, ``dp`` and ``ep`` on (2, 2), (4, 1)
and (1, 4) meshes, each rank's slices of the params, the AdamW moments
and the batch against the reference's ``params_pspecs`` and
``batch_pspecs``, with each place where the port's cut departs from the
reference's listed (``_departure``); under the serving presets
``infer-tp`` and ``infer-tp2`` each rank's slices of the params and of
a whole contiguous cache (``shard_cache``) against the reference's
``params_pspecs`` and ``cache_pspecs``, the cache with no departure but
the Mamba2 conv window and the xLSTM state (``_cache_departure``); on
the reference's multi-pod (2, 16, 16) ``AbstractMesh`` of axes ("pod",
"data", "model"), every arch's full config under every preset, rank
0's slices of the params and of a whole cache against the same rules,
with the same departures; and the reference's cache rule on an sLSTM
state (ROADMAP Queue 3 item 9), which the port does not copy."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.launch.specs import params_specs  # noqa: E402
from repro.models import pspec as JPS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.config import get_reduced_config  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.models import pspec as PS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.paging import (BlockAllocator,  # noqa: E402
                                        per_device_pool_stats)
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from test_sharding import _abstract_mesh  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((1, 4), ("data", "model")),
          ((1, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((4, 1), ("data", "model"))]
TRAIN_MESHES = [(2, 2), (4, 1), (1, 4)]
MAPS = {"default": None, "serving": JSH.SERVING_LOGICAL_MAP,
        "guard": {"a": ("data", "model"), "b": ("data",)},
        **{f"preset-{k}": v for k, v in JSH.SHARDING_PRESETS.items()}}
PARAM_ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
               "granite-20b"]
CACHE_ARCHS = PARAM_ARCHS + ["zamba2-7b", "xlstm-1.3b", "whisper-tiny"]
PAGED_ARCHS = PARAM_ARCHS[:3] + ["qwen1.5-4b"]
TRAIN_ARCHS = PARAM_ARCHS + ["qwen1.5-4b"]
# the hybrid, audio and vlm families, on a mesh since the Mamba2 cut, and
# the ssm family, since the xLSTM cut on whole heads
FAMILY_ARCHS = ["zamba2-7b", "whisper-tiny", "qwen2-vl-2b", "xlstm-1.3b"]
POD_MESH = ((2, 16, 16), ("pod", "data", "model"))
NAMES = [None, "batch", "fsdp", "model", "expert", "seq", "a", "b", "data"]
SIZES = [1, 2, 3, 4, 5, 8, 15, 16, 20, 32, 48, 64, 128, 256, 512, 4096]


def _meshes(shape, names):
    return _abstract_mesh(shape, names), PS.MeshShape(names, shape)


def _spec(spec) -> tuple:
    return tuple(spec)


def _cases(n=300, seed=0):
    rng = np.random.default_rng(seed)
    out = [((16, 15), (None, "model")), ((4, 15), (None, "model")),
           ((4, 32), (None, "model")), ((4, 4), ("a", "b"))]
    for _ in range(n):
        nd = int(rng.integers(1, 5))
        out.append((tuple(int(rng.choice(SIZES)) for _ in range(nd)),
                    tuple(NAMES[int(rng.integers(len(NAMES)))]
                          for _ in range(nd))))
    return out


def test_maps_and_presets_are_the_reference_ones():
    assert PS.DEFAULT_LOGICAL_MAP == JPS.DEFAULT_LOGICAL_MAP
    assert SH.SHARDING_PRESETS == JSH.SHARDING_PRESETS
    assert SH.SERVING_LOGICAL_MAP == JSH.SERVING_LOGICAL_MAP


@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("map_name", list(MAPS))
def test_pspec_for_and_shard_count_match(mesh_shape, names, map_name):
    jm, tm = _meshes(mesh_shape, names)
    lm = MAPS[map_name]
    cases = _cases()
    with JPS.mesh_rules(jm, lm):
        want = [_spec(JPS.pspec_for(s, l)) for s, l in cases]
        counts = [JPS.shard_count(n, s) for n in NAMES for s in SIZES]
    with PS.mesh_rules(tm, lm):
        assert [PS.pspec_for(s, l) for s, l in cases] == want
        assert [PS.shard_count(n, s) for n in NAMES for s in SIZES] == counts
    assert PS.pspec_for((4, 4), (None, None)) is None     # no rules
    assert PS.shard_count("model", 16) == 1


@pytest.mark.parametrize("mesh_shape,names", MESHES)
def test_batch_specs_match(mesh_shape, names):
    jm, tm = _meshes(mesh_shape, names)
    batch = {"tokens": (8, 64), "frames": (3, 1500, 384), "pos": (16,)}
    for lm in MAPS.values():
        with JPS.mesh_rules(jm, lm):
            want = {k: _spec(JPS.pspec_for(
                s, ["batch"] + [None] * (len(s) - 1)))
                    for k, s in batch.items()}
        assert SH.batch_pspecs(tm, batch, lm) == want


def test_fallback_and_duplicate_guard():
    """The reference test's two rules, on the port."""
    with PS.mesh_rules(PS.MeshShape(("data", "model"), (1, 16))):
        assert PS.pspec_for((4, 15), [None, "model"]) == (None, None)
        assert PS.pspec_for((4, 32), [None, "model"]) == (None, "model")
    with PS.mesh_rules(PS.MeshShape(("data", "model"), (2, 2)),
                       {"a": ("data", "model"), "b": ("data",)}):
        assert PS.pspec_for((4, 4), ["a", "b"]) == (("data", "model"), None)


def _reference_leaves(tree) -> dict:
    return {tuple(JSH._path_names(p)): (p, leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> list:
    return tree_leaves_with_path(tree)


def _specs(tree, path=()) -> dict:
    """path -> spec of a specs tree (its leaves are tuples)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _specs(sub, path + (k,)).items()}
    return {path: tree}


@pytest.mark.parametrize("arch", PARAM_ARCHS)
def test_param_rules_on_every_leaf(arch):
    jcfg, tcfg = j_reduced(arch), get_reduced_config(arch)
    want = _reference_leaves(params_specs(jcfg, max_seq=64))
    params = T.init_params(tcfg, seed=0, device="cpu", max_seq=64)
    got = _port_leaves(params)
    assert {p for p, _ in got} == set(want)
    for path, leaf in got:
        jpath, jleaf = want[path]
        assert tuple(leaf.shape) == tuple(jleaf.shape), path
        assert SH.param_logical_axes(path, leaf) == \
            JSH.param_logical_axes(jpath, jleaf), path
    for mesh_shape, names in MESHES:
        jm, tm = _meshes(mesh_shape, names)
        for lm in MAPS.values():
            specs = _specs(SH.params_pspecs(tm, params, lm))
            with JPS.mesh_rules(jm, lm):
                for path, (jpath, jleaf) in want.items():
                    assert specs[path] == _spec(JPS.pspec_for(
                        jleaf.shape, JSH.param_logical_axes(jpath, jleaf))), \
                        (path, mesh_shape, lm)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_rules_on_every_leaf(arch):
    jcfg, tcfg = j_reduced(arch), get_reduced_config(arch)
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 64))
    want = _reference_leaves(jcache)
    got = _port_leaves(T.init_cache(tcfg, 2, 64, device="cpu"))
    assert {p for p, _ in got} == set(want)
    for mesh_shape, names in MESHES:
        jm, tm = _meshes(mesh_shape, names)
        for lm in MAPS.values():
            specs = _specs(SH.cache_pspecs(
                tm, tcfg, T.init_cache(tcfg, 2, 64, device="cpu"), lm))
            with JPS.mesh_rules(jm, lm):
                for path, leaf in got:
                    jpath, jleaf = want[path]
                    axes = JSH.cache_logical_axes(jcfg, jpath, jleaf)
                    assert SH.cache_logical_axes(tcfg, path, leaf) == axes
                    assert specs[path] == _spec(
                        JPS.pspec_for(jleaf.shape, axes)), path


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_pool_rules_and_rank_shapes(arch):
    """Every pool leaf: the same logical axes and specs, and each rank's
    leaf shape (``pool_cut``) is the reference's shard shape."""
    jcfg, tcfg = j_reduced(arch), get_reduced_config(arch)
    want = _reference_leaves(jax.eval_shape(
        lambda: JT.init_paged_cache(jcfg, 9, 8)))
    shapes = T.paged_cache_shapes(tcfg, 9, 8)
    got = [((n, k), s) for n, sub in shapes.items() for k, s in sub.items()]
    assert {p for p, _ in got} == set(want)
    for mesh_shape, names in MESHES:
        jm, tm = _meshes(mesh_shape, names)
        for lm in MAPS.values():
            with JPS.mesh_rules(jm, lm):
                jspecs = {p: JPS.pspec_for(leaf.shape,
                                           JSH.paged_cache_logical_axes(
                                               jcfg, jp, leaf))
                          for p, (jp, leaf) in want.items()}
            with PS.mesh_rules(tm, lm):
                for path, shape in got:
                    axes = SH.paged_cache_logical_axes(tcfg, path, shape)
                    assert axes == JSH.paged_cache_logical_axes(
                        jcfg, want[path][0], want[path][1])
                    spec = jspecs[path]
                    assert PS.pspec_for(shape, axes) == _spec(spec)
                    rank = tuple(
                        s // (int(np.prod([jm.shape[a] for a in (
                            e if isinstance(e, tuple) else (e,))]))
                              if e is not None else 1)
                        for s, e in zip(shape, spec))
                    assert SH.local_shape(
                        shape, SH.pool_cut(tcfg, path, shape)) == rank


def test_per_device_pool_accounting_matches_ledger():
    """Twin of the reference's hypothesis invariant: the per-device pool
    view agrees with the global ledger (identical page counts, bytes
    that multiply back to the global total when the head dim
    divides)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(st.integers(1, 8), st.integers(1, 64), st.data())
    @settings(max_examples=40, deadline=None)
    def run(n_shards, unit, data):
        a = BlockAllocator(24)
        live = []
        for _ in range(data.draw(st.integers(0, 40))):
            if a.available() > 0 and data.draw(st.booleans()):
                a.reserve(1)
                live.extend(a.alloc(1))
            elif live:
                i = data.draw(st.integers(0, len(live) - 1))
                a.release([live.pop(i)])
        page_bytes = unit * n_shards
        per_dev = a.n_pages * page_bytes // n_shards
        s = per_device_pool_stats(a, n_shards=n_shards,
                                  kv_bytes_per_device=per_dev)
        assert s["kv_bytes_per_device"] * n_shards == a.n_pages * page_bytes
        assert s["pages_in_use_per_device"] == a.in_use
        assert s["peak_pages_in_use_per_device"] == a.peak_in_use
        assert a.in_use == a.n_pages - len(a._free)
        assert a.peak_in_use >= a.in_use

    run()


def test_weights_follow_whole_heads():
    """The port's cuts (``param_cut``) follow whole heads: qwen1.5-4b's
    20/20 heads of 128 split 5/5 a rank over 4; smollm's 5 KV heads of
    64 do not divide 4, so its attention replicates, where the
    reference's generic rule cuts ``w_k``'s 320 columns into 80, inside
    a head.  The MLP, vocab, experts and MLA's latent rank split; a
    rank's slices of a tree are its share, and cutting them again
    changes nothing."""
    from repro_torch.config import get_config
    from repro_torch.launch.mesh import ServingMesh
    mesh = PS.MeshShape(("data", "model"), (1, 4))
    q4, sm = get_config("qwen1.5-4b"), get_config("smollm-360m")
    ds, qm = get_config("deepseek-v3-671b"), get_config("qwen3-moe-30b-a3b")
    with PS.mesh_rules(mesh, SH.SERVING_LOGICAL_MAP):
        assert SH.param_cut(q4, ("blocks", "attn", "w_q")) == (-1, 4, 2560)
        assert SH.param_cut(q4, ("blocks", "attn", "b_k")) == (-1, 4, 2560)
        assert SH.param_cut(q4, ("blocks", "attn", "w_o")) == (-2, 4, 2560)
        assert SH.param_cut(q4, ("blocks", "mlp", "w_down")) == (-2, 4, 6912)
        assert SH.param_cut(q4, ("embed",)) == (0, 4, 151936)
        assert SH.param_cut(sm, ("blocks", "attn", "w_k")) is None
        assert PS.pspec_for((32, 960, 320), SH.param_logical_axes(
            ("blocks", "attn", "w_k"), (32, 960, 320))) == (None, None,
                                                            "model")
        assert SH.param_cut(qm, ("blocks_moe", "moe", "w_up")) == \
            (-3, 4, 128)
        assert SH.param_cut(qm, ("blocks_moe", "moe", "router")) is None
        assert SH.param_cut(ds, ("blocks_moe", "attn", "w_uk")) == \
            (-2, 4, 512)
        assert SH.param_cut(ds, ("blocks_moe", "attn", "w_o")) is None
        assert SH.param_cut(ds, ("blocks_moe", "moe", "shared", "w_gate")) \
            == (-1, 4, 2048)
        assert SH.pool_cut(ds, ("blocks_moe", "krope"), (58, 9, 16, 64)) \
            == (3, 4, 64)
    cfg = get_reduced_config("qwen1.5-4b").with_(param_dtype="float32",
                                                 activation_dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    rank = ServingMesh(rank=2, size=4)
    local = SH.shard_params(cfg, params, rank)
    hd = cfg.resolved_head_dim
    w_q = params["blocks"]["attn"]["w_q"]
    assert torch.equal(local["blocks"]["attn"]["w_q"],
                       w_q[..., 2 * hd:3 * hd])          # head 2 of 4
    assert torch.equal(local["embed"], params["embed"][256:384])
    assert local["final_norm"]["scale"] is params["final_norm"]["scale"]
    again = SH.shard_params(cfg, local, rank)
    assert all(a is b for (_, a), (_, b) in zip(
        tree_leaves_with_path(again), tree_leaves_with_path(local)))


def _departure(cfg, path: tuple, model: int):
    """Why the port's slice of the param at ``path`` may differ from the
    reference's on a mesh with ``model`` ranks on "model", or None.  The
    reference's rules cut by size, and GSPMD may cut anywhere; the port
    computes each rank's whole heads, widths and experts itself."""
    last, names = path[-1], set(path)
    if cfg.mla is not None and "attn" in names:
        return ("MLA: w_uk and w_uv cut on the latent rank over 'model' "
                "(their FSDP on the other dim), the query and latent "
                "down-projections, w_uq and w_o replicated over 'model'")
    if last in ("w_q", "w_k", "w_v", "w_o") and cfg.n_kv_heads % model:
        return ("whole heads: the KV heads do not divide 'model', so "
                "attention replicates over it")
    if last in ("b_q", "b_k", "b_v", "b_up"):
        return "a bias cut with its weight's heads or d_ff"
    if "shared" in names:
        return ("the shared expert cut on its d_ff over 'model' (the "
                "reference's rule puts 'expert' on its layer axis)")
    if path == ("mtp", "proj"):
        return "the MTP projection replicated over 'model'"
    if path[0] in SH.MAMBA_STACKS and last == "in_proj":
        return ("Mamba2 in_proj: z, x and dt cut by whole SSM heads, B and "
                "C whole on every rank (the reference cuts its packed "
                "z | x | B | C | dt columns evenly, across the parts)")
    if path[0] in SH.MAMBA_STACKS and last == "out_proj":
        return ("Mamba2 out_proj on whole SSM heads: the heads' count "
                "decides the cut's ways (under infer-tp2 on (2, 16, 16) "
                "112 heads over 'data' alone, where the rule cuts its "
                "7168 rows over both axes)")
    if path == ("shared_adapters",):
        return ("zamba2's shared-block adapters replicated over 'model' "
                "(the reference cuts their output columns)")
    if path[0] in SH.XLSTM_STACKS:
        return {
            "w_up": "mLSTM w_up: main and z cut by whole heads (the "
                    "reference cuts its packed columns evenly, across the "
                    "parts)",
            "w_gates": "sLSTM w_gates: z, i, f and o cut by whole heads "
                       "(the reference cuts the packed columns evenly)",
            "w_q": "mLSTM q, k, v projections cut on their head dim (the "
                   "reference cuts their output dim)",
            "w_if": "mLSTM w_if row-parallel on the rank's heads' "
                    "channels, FSDP on its gate columns (the reference: "
                    "FSDP on its rows, 'model' on its 2 nh columns)",
            "w_down": "mLSTM w_down on its heads' rows: whole heads "
                      "replicate where the heads do not divide 'model'",
        }.get("w_q" if last in ("w_k", "w_v") else last)
    return None


def _cache_departure(path: tuple):
    """Why the port's slice of a contiguous-cache leaf may differ from the
    reference rule's, or None."""
    if path[0] in SH.MAMBA_STACKS and path[-1] == "conv":
        return ("the Mamba2 conv window's channels x | B | C cut as "
                "conv_w is read: the rank's heads' x channels, B and C "
                "whole (the reference cuts them evenly, across the parts)")
    if path[0] in SH.XLSTM_STACKS and path[-1] != "conv_win":
        return ("the xLSTM state on whole heads: C, n, m, c the rank's "
                "heads, mLSTM's conv and sLSTM's h its heads' channels, "
                "every leaf's rows over 'batch' on its row dim (the "
                "reference cuts C and n on their key dim, sLSTM's n on "
                "its head dim, and puts 'batch' on sLSTM's m's heads)")
    return None


def _xlstm_cache_shape(cfg, path: tuple, leaf_shape, jm) -> list:
    """An xLSTM state leaf's shape on a rank by the port's departure
    (``_cache_departure``), from the reference's rules installed on
    ``jm``: its rows over the "batch" axes on its row dim, its heads (or
    its heads' channels: mLSTM's ``conv``, sLSTM's ``h``) over the axes
    the rules would cut the heads' count over, where those are not the
    rows'; sLSTM's ``conv_win`` its rows only."""
    row = 2 if path[0] == "mlstm_units" else 1
    got = list(leaf_shape)
    rows = JPS.pspec_for((leaf_shape[row],), ["batch"])[0]
    heads = JPS.pspec_for((cfg.n_heads,), ["model"])[0]
    got[row] //= _ways(jm, rows)
    if path[-1] != "conv_win" and not _flat(rows) & _flat(heads):
        dim = len(got) - 1 if path[-1] in ("conv", "h") else row + 1
        got[dim] //= _ways(jm, heads)
    return got


def _flat(entry) -> set:
    return set() if entry is None else set(
        entry if isinstance(entry, tuple) else (entry,))


def _ways(jm, entry) -> int:
    return int(np.prod([jm.shape[a] for a in _flat(entry)]))


def _reference_slice(jm, lm, jpath, jleaf) -> tuple:
    with JPS.mesh_rules(jm, lm):
        spec = JPS.pspec_for(jleaf.shape,
                             JSH.param_logical_axes(jpath, jleaf))
    return tuple(s // int(np.prod([jm.shape[a] for a in (
        e if isinstance(e, tuple) else (e,))])) if e is not None else s
        for s, e in zip(jleaf.shape, spec))


@pytest.mark.parametrize("arch,preset", [
    (a, p) for a in TRAIN_ARCHS + FAMILY_ARCHS
    for p in ("baseline", "dp", "ep")])
def test_training_slices_match_the_reference_rules(arch, preset):
    """Every rank's slices of every param and of both AdamW moments
    (``shard_params`` and ``adamw_init`` on a rank of the mesh) have the
    shape of the reference's ``params_pspecs`` slice, but where
    ``_departure`` says why not; the rule's plan (``param_plan``) gives
    the same shapes; each rank's batch rows are the reference's
    ``batch_pspecs`` block, in rank order over the batch axes."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training import optim
    jcfg, tcfg = j_reduced(arch), get_reduced_config(arch)
    want = _reference_leaves(params_specs(jcfg, max_seq=64))
    params = T.init_params(tcfg, seed=0, device="cpu", max_seq=64)
    lm = JSH.SHARDING_PRESETS[preset]
    lmap = SH.train_map(preset)
    tokens = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    departed = set()
    for shape in TRAIN_MESHES:
        jm = _abstract_mesh(shape, ("data", "model"))
        plan = SH.param_plan(tcfg, params, PS.MeshShape(("data", "model"),
                                                        shape), lmap)
        b_spec = JSH.batch_pspecs(jm, {"tokens": jax.ShapeDtypeStruct(
            tokens.shape, np.int32)}, lm)["tokens"].spec
        n_b = int(np.prod([jm.shape[a] for a in (
            b_spec[0] if isinstance(b_spec[0], tuple) else (b_spec[0],))])
            ) if b_spec and b_spec[0] is not None else 1
        for rank in range(shape[0] * shape[1]):
            mesh = Mesh(rank=rank, size=shape[0] * shape[1], data=shape[0])
            local = SH.shard_params(tcfg, params, mesh, lmap)
            mu = optim.adamw_init(local, optim.OptimConfig())["mu"]
            for (path, leaf), (_, m) in zip(_port_leaves(local),
                                            _port_leaves(mu)):
                got = tuple(leaf.shape)
                assert tuple(m.shape) == got
                assert SH.local_shape(params_leaf(params, path).shape,
                                      *plan[path]) == got
                ref = _reference_slice(jm, lm, *want[path])
                if got != ref:
                    why = _departure(tcfg, path, shape[1])
                    assert why is not None, (path, shape, got, ref)
                    departed.add((path, why))
            rows = SH.shard_batch({"tokens": tokens}, mesh, lmap)["tokens"]
            k = 8 // n_b
            i = rank if n_b == shape[0] * shape[1] else (
                rank // shape[1] if n_b == shape[0] else 0)
            assert np.array_equal(rows, tokens[i * k:(i + 1) * k])
    if (arch, preset) == ("smollm-360m", "baseline"):  # one KV head
        assert any("whole heads" in why for _, why in departed)


def params_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch,preset", [
    (a, p) for a in TRAIN_ARCHS + FAMILY_ARCHS
    for p in ("infer-tp", "infer-tp2")])
def test_serving_preset_slices_match_the_reference_rules(arch, preset):
    """Every rank's slices of every param (``shard_params`` under the
    preset) have the shape of the reference's ``params_pspecs`` slice but
    where ``_departure`` says why not (the heads' ways: the axes "model"
    maps to), and of every leaf of a whole contiguous cache
    (``shard_cache``) exactly the reference's ``cache_pspecs`` slice but
    the Mamba2 conv window (``_cache_departure``): ``infer-tp2`` cuts
    over both axes, or "data" alone where the count does not divide
    both."""
    from repro_torch.launch.mesh import Mesh
    jcfg, tcfg = j_reduced(arch), get_reduced_config(arch)
    want = _reference_leaves(params_specs(jcfg, max_seq=64))
    params = T.init_params(tcfg, seed=0, device="cpu", max_seq=64)
    cache = T.init_cache(tcfg, 8, 64, device="cpu")
    jcache = _reference_leaves(jax.eval_shape(
        lambda: JT.init_cache(jcfg, 8, 64)))
    lm = JSH.SHARDING_PRESETS[preset]
    for shape in TRAIN_MESHES:
        jm = _abstract_mesh(shape, ("data", "model"))
        ways = int(np.prod([jm.shape[a] for a in lm["model"]]))
        for rank in range(shape[0] * shape[1]):
            mesh = Mesh(rank=rank, size=shape[0] * shape[1], data=shape[0])
            local = SH.shard_params(tcfg, params, mesh, lm)
            for path, leaf in _port_leaves(local):
                ref = _reference_slice(jm, lm, *want[path])
                if tuple(leaf.shape) != ref:
                    assert _departure(tcfg, path, ways) is not None, \
                        (path, shape, tuple(leaf.shape), ref)
            for path, leaf in _port_leaves(SH.shard_cache(tcfg, cache, mesh,
                                                          lm)):
                jpath, jleaf = jcache[path]
                with JPS.mesh_rules(jm, lm):
                    spec = JPS.pspec_for(jleaf.shape, JSH.cache_logical_axes(
                        jcfg, jpath, jleaf))
                ref = tuple(s // (int(np.prod([jm.shape[a] for a in (
                    e if isinstance(e, tuple) else (e,))]))
                    if e is not None else 1) for s, e in zip(jleaf.shape,
                                                             spec))
                if _cache_departure(path) is None:
                    assert tuple(leaf.shape) == ref, (path, shape, preset)
                elif path[0] in SH.XLSTM_STACKS:
                    with JPS.mesh_rules(jm, lm):
                        port = _xlstm_cache_shape(jcfg, path, jleaf.shape,
                                                  jm)
                    assert list(leaf.shape) == port, (path, shape, preset)
                else:
                    assert tuple(leaf.shape)[:-1] == ref[:-1], (path, shape)


def test_mamba2_blocks_follow_whole_heads():
    """zamba2-7b's Mamba2 blocks on a (2, 2) mesh under ``baseline``: its
    112 SSM heads of 64 split 56 a rank over "model".  ``in_proj`` holds
    the rank's heads' z, x and dt columns and B and C whole (a
    ``PackedCut``: 2 x 3584 + 2 x 64 + 56 of its 14576 columns),
    FSDP-cut on its rows; ``out_proj`` its heads' rows.  The vectors the
    block reads as the rank's heads' share (``conv_w``, ``conv_b``,
    ``A_log``, ``D``, ``dt_bias``, the norm's scale) replicate, as the
    reference's rule has them (``_REPLICATED``, and the "scale" leaf),
    and so do the shared block's adapters over "model" (FSDP-cut over
    "data").  The ``ssm`` state follows the heads; the ``conv`` window's
    channels x | B | C follow ``conv_w``'s reading: 3584 + 128 of 7296 a
    rank (``_cache_departure``), where the reference would cut 3648; a
    reduced rank's ``in_proj`` holds exactly its heads' columns."""
    from repro_torch.config import get_config
    from repro_torch.launch.mesh import Mesh
    cfg = get_config("zamba2-7b")
    mesh = PS.MeshShape(("data", "model"), (2, 2))
    lmap = SH.train_map("baseline")
    with PS.mesh_rules(mesh, lmap):
        cut = SH.param_cut(cfg, ("mamba_units", "in_proj"))
        assert isinstance(cut, SH.PackedCut) and cut == (-1, 2, 14576)
        assert cut.local() == 2 * 3584 + 2 * 64 + 56
        assert SH.param_cut(cfg, ("mamba_tail", "out_proj")) == \
            (-2, 2, 7168)
        assert SH.fsdp_cut(cfg, ("mamba_units", "in_proj"),
                           (13, 6, 3584, 14576)) == (-2, 2, 3584)
        for leaf in (("conv_w",), ("conv_b",), ("A_log",), ("D",),
                     ("dt_bias",), ("norm", "scale")):
            path = ("mamba_units",) + leaf
            assert SH.param_cut(cfg, path) is None, path
            assert SH.param_logical_axes(path, (13, 6, 4, 7296)) == \
                [None] * 4
        assert SH.param_cut(cfg, ("shared_adapters",)) is None
        assert SH.fsdp_cut(cfg, ("shared_adapters",), (13, 3584, 3584)) \
            == (-2, 2, 3584)
        cuts = SH._cache_cuts(cfg, ("mamba_units", "conv"),
                              (13, 6, 8, 3, 7296))
        assert [(d, e) for d, e, _ in cuts] == [(2, "data"), (4, "model")]
        assert SH.local_shape((13, 6, 8, 3, 7296), SH.PackedCut(
            4, 2, 7296, cuts[1][2])) == (13, 6, 8, 3, 3584 + 128)
        assert [(d, e) for d, e, _ in SH._cache_cuts(
            cfg, ("mamba_units", "ssm"), (13, 6, 8, 112, 64, 64))] == [
            (2, "data"), (3, "model")]
    assert _cache_departure(("mamba_units", "conv")) is not None
    # reduced zamba2 (16 heads of 32, d_inner 512, B and C 16 wide): the
    # rank at (data 0, model 1) holds heads 8..15 of the tail's in_proj,
    # z | x | B | C | dt, the first half of its rows (FSDP over "data")
    small = get_reduced_config("zamba2-7b").with_(n_layers=3)
    params = T.init_params(small, seed=0, device="cpu")
    local = SH.shard_params(small, params, Mesh(rank=1, size=4, data=2),
                            lmap)
    w = params["mamba_tail"]["in_proj"][..., :128, :]
    got = local["mamba_tail"]["in_proj"]
    assert tuple(got.shape) == (1, 128, 552)
    assert torch.equal(got[..., :256], w[..., 256:512])           # z
    assert torch.equal(got[..., 256:512], w[..., 768:1024])       # x
    assert torch.equal(got[..., 512:544], w[..., 1024:1056])      # B, C
    assert torch.equal(got[..., 544:], w[..., 1064:1072])         # dt


def _pod_cases() -> list:
    from repro_torch.config import ARCH_IDS
    return [(a, p) for a in ARCH_IDS for p in JSH.SHARDING_PRESETS]


@pytest.mark.parametrize("arch,preset", _pod_cases())
def test_multi_pod_slices_follow_the_reference_rules(arch, preset):
    """Rank 0 of the reference's multi-pod (2, 16, 16) mesh of axes
    ("pod", "data", "model"), every arch's FULL config: each param's
    slice (``param_plan``: its "model" cut and its FSDP cut over the
    "fsdp" entry, ("pod", "data") under ``baseline``) has the shape of
    the reference's ``params_pspecs`` slice, but where ``_departure``
    says why not; each leaf of a whole 64-row contiguous cache
    (``shard_cache``) the reference's ``cache_pspecs`` slice, but the
    Mamba2 conv window and the xLSTM state (``_cache_departure``)."""
    from repro.config import get_config as j_config
    from repro_torch.config import get_config
    from repro_torch.launch.mesh import Mesh
    jcfg, tcfg = j_config(arch), get_config(arch)
    shape, names = POD_MESH
    jm = _abstract_mesh(shape, names)
    lm = JSH.SHARDING_PRESETS[preset]
    lmap = SH.train_map(preset)
    want = _reference_leaves(params_specs(jcfg, max_seq=1024))
    whole = T.param_shapes(tcfg, max_seq=1024)
    plan = SH.param_plan(tcfg, whole, PS.MeshShape(names, shape), lmap)
    ways = int(np.prod([jm.shape[a] for a in lm["model"]])) if lm \
        else jm.shape["model"]
    for path, leaf in _port_leaves(whole):
        got = SH.local_shape(tuple(leaf.shape), *plan[path])
        ref = _reference_slice(jm, lm, *want[path])
        if got != ref:
            assert _departure(tcfg, path, ways) is not None, \
                (path, got, ref)
    if tcfg.family == "audio":
        cache = T.init_cache(tcfg, 64, 448, device="meta")
        jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 64, 448))
    else:
        cache = T.init_cache(tcfg, 64, 1024, device="meta")
        jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 64, 1024))
    jleaves = _reference_leaves(jcache)
    mesh = Mesh(rank=0, size=512, data=16, pod=2)
    local = SH.shard_cache(tcfg, cache, mesh, lmap)
    with JPS.mesh_rules(jm, lm):
        for path, leaf in _port_leaves(local):
            jpath, jleaf = jleaves[path]
            spec = JPS.pspec_for(jleaf.shape, JSH.cache_logical_axes(
                jcfg, jpath, jleaf))
            ref = tuple(s // _ways(jm, e) for s, e in zip(jleaf.shape, spec))
            if _cache_departure(path) is None:
                assert tuple(leaf.shape) == ref, (path, preset)
            elif path[0] in SH.XLSTM_STACKS:
                assert list(leaf.shape) == _xlstm_cache_shape(
                    jcfg, path, jleaf.shape, jm), (path, preset)
            else:
                assert tuple(leaf.shape)[:-1] == ref[:-1], (path, preset)
    assert plan and local


def test_xlstm_blocks_follow_whole_heads():
    """xlstm-1.3b on (2, 2) under ``baseline``: its 4 heads split 2 a
    rank over "model".  mLSTM's ``w_up`` holds its heads' main and z
    columns (a ``PackedCut``, 2 x 2048 of its 8192), ``w_q`` its 2 heads,
    ``w_if`` and ``w_down`` its heads' 2048 channels' rows (``w_if``
    FSDP-cut on its 8 gate columns); sLSTM's ``w_gates`` its heads' 4 x
    1024 columns, its SwiGLU ``up`` cut on its 2730-wide d_ff, 1365 a
    rank.  On (16, 16) the 4 heads do not divide 16: every block
    replicates over "model", while the rule's ``up`` drops "model" too
    (2730 does not divide 16).  The state follows the heads: each
    leaf's rows over "data", ``C`` and sLSTM's ``h`` its heads."""
    from repro_torch.config import get_config
    cfg = get_config("xlstm-1.3b")
    lmap = SH.train_map("baseline")
    with PS.mesh_rules(PS.MeshShape(("data", "model"), (2, 2)), lmap):
        cut = SH.param_cut(cfg, ("mlstm_units", "w_up"))
        assert isinstance(cut, SH.PackedCut) and cut == (-1, 2, 8192)
        assert cut.local() == 4096
        assert SH.param_cut(cfg, ("mlstm_units", "w_q")) == (-3, 2, 4)
        assert SH.param_cut(cfg, ("mlstm_units", "w_if")) == (-2, 2, 4096)
        assert SH.fsdp_cut(cfg, ("mlstm_units", "w_if"),
                           (6, 7, 4096, 8)) == (-1, 2, 8)
        assert SH.param_cut(cfg, ("mlstm_units", "w_down")) == \
            (-2, 2, 4096)
        assert SH.param_cut(cfg, ("slstm_units", "w_gates")).local() == \
            4096
        assert SH.param_cut(cfg, ("slstm_units", "up", "w_up")) == \
            (-1, 2, 2730)
        for leaf in ("conv_w", "conv_b", "skip", "b_if", "r_gates",
                     "b_gates"):
            assert SH.param_cut(cfg, ("mlstm_units", leaf)) is None
            assert SH.param_cut(cfg, ("slstm_units", leaf)) is None
        assert [(d, e) for d, e, _ in SH._cache_cuts(
            cfg, ("mlstm_units", "C"), (6, 7, 8, 4, 1024, 1024))] == [
                (2, "data"), (3, "model")]
        assert [(d, e) for d, e, _ in SH._cache_cuts(
            cfg, ("slstm_units", "h"), (6, 8, 2048))] == [
                (1, "data"), (2, "model")]
        assert [(d, e) for d, e, _ in SH._cache_cuts(
            cfg, ("slstm_units", "conv_win"), (6, 8, 3, 2048))] == [
                (1, "data")]
    with PS.mesh_rules(PS.MeshShape(("data", "model"), (16, 16)), lmap):
        for path in (("mlstm_units", "w_up"), ("mlstm_units", "w_down"),
                     ("slstm_units", "w_gates"),
                     ("slstm_units", "up", "w_gate")):
            assert SH.param_cut(cfg, path) is None, path


def test_the_reference_slstm_state_rule_cuts_heads_where_it_means_rows():
    """ROADMAP Queue 3 item 9: the reference's ``cache_logical_axes``
    matches cache leaves by name (``src/repro/launch/sharding.py``), so
    sLSTM's ``m`` (units, B, nh, dh) takes the ("m", "h") rule's
    [.., "batch", None] on its last two dims: on (2, 2) xlstm-1.3b's 4
    heads divide "data", and the rule cuts the heads where it means the
    rows, leaving the rows whole; sLSTM's ``n`` takes mLSTM's rule and
    cuts its head dim over "model" while its partner ``c`` stays whole.
    The port cuts every leaf's rows on its row dim and its heads with
    the block's weights (``shard_cache``)."""
    from repro.config import get_config as j_config
    from repro_torch.config import get_config
    from repro_torch.launch.mesh import Mesh
    jcfg, tcfg = j_config("xlstm-1.3b").with_(n_layers=8), \
        get_config("xlstm-1.3b").with_(n_layers=8)
    jm = _abstract_mesh((2, 2), ("data", "model"))
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 8, 64))
    specs = {p: tuple(s.spec) for p, s in _specs(
        JSH.cache_pspecs(jm, jcfg, jcache)).items()}
    assert specs[("slstm_units", "m")] == (None, None, "data", None)
    assert specs[("slstm_units", "n")] == (None, "data", None, "model")
    assert specs[("slstm_units", "c")] == (None, "data", None, None)
    cache = T.init_cache(tcfg, 8, 64, device="meta")
    local = SH.shard_cache(tcfg, cache, Mesh(rank=0, size=4, data=2),
                           SH.train_map("baseline"))
    for leaf in ("m", "n", "c"):
        assert tuple(local["slstm_units"][leaf].shape) == (1, 4, 2, 512)

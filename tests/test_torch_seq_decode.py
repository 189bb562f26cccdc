"""Decode over a contiguous cache cut on its positions, on the CPU.

The reference cuts a contiguous KV cache over its sequence wherever the
KV heads do not divide 16 (``repro.launch.sharding.cache_logical_axes``:
"seq", which its default map and ``infer-tp`` send to "model") and reads
it through ``chunked_attention`` under GSPMD.  The port runs the
contiguous decode kernel's plain version on each rank's slice of the
positions with its log-sum-exp and merges the ranks' partials after one
exact gather (``repro_torch.models.attention.attention_decode``).

Held here:
  * the plain decode with its lse (``kernels.ops.decode_attention``,
    ``return_lse=True``) against the reference's Pallas decode kernel in
    interpret mode and a numpy log-sum-exp, with valid lengths 0, 1, S
    and others; a row with none gives out 0 and lse -1e30 (the Pallas
    kernel gives such a row the mean of v, which a merge would weigh
    wrongly), and ``merge_partials`` of two halves gives the whole;
  * a 4-rank gloo world (tests/seq_decode_ranks.py, no JAX) on a (2, 2)
    mesh: ``make_prefill_step`` then DECODE_STEPS greedy
    ``make_serve_step`` steps under ``baseline`` and ``infer-tp`` (the
    sequence cut over "model") and ``infer-tp2`` (heads and experts
    over both axes, the cache whole) for dense (qwen1.5-4b reduced: its
    heads cut and its positions cut over the same axis), MQA (granite-20b
    reduced: one KV head), moe (qwen3-moe reduced: under infer-tp2 its 2
    KV heads cut over "data" alone) and MLA (deepseek-v3 reduced), and a
    sliding window whose ring wraps (a 10-token prompt in 8 slots, 4 a
    rank), against the reference's UNSHARDED ``prefill`` and
    ``decode_step`` on the same weights (``bridge``): fp32 logits within
    atol LOGITS_ATOL, greedy tokens identical, every rank's bits equal
    to those of the ranks holding the same rows, and every cache leaf's
    shape the reference's rule's slice (``cache_pspecs`` on an
    ``AbstractMesh`` under the preset)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import seq_decode_ranks as R  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention_kernel as j_decode  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.attention import merge_partials  # noqa: E402
from test_sharding import _abstract_mesh  # noqa: E402
from test_torch_pspec import _reference_leaves  # noqa: E402

N_RANKS = 4
LOGITS_ATOL = 1e-4
LSE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _positions(a: np.ndarray, S_cache: int) -> np.ndarray:
    """The reference prefill's (L, B, S, ...) leaf as a cache of S_cache
    slots: zeros after the prompt, or a ring holding the last S_cache
    positions at slot pos % S_cache."""
    S = a.shape[2]
    if S <= S_cache:
        pad = [(0, 0)] * a.ndim
        pad[2] = (0, S_cache - S)
        return np.pad(a, pad)
    return np.roll(a[:, :, S - S_cache:], (S - S_cache) % S_cache, axis=2)


@pytest.fixture(scope="module")
def reference():
    """Per (arch, window): the reference's params (numpy) and, for the
    unsharded prefill then DECODE_STEPS greedy decode steps on its cache
    laid out for MAX_SEQ positions, the logits of each and the tokens."""
    out, by_arch = {}, {}
    for _, arch, _, window in R.CASES:
        if (arch, window) in out:
            continue
        cfg = R.config(arch, window)
        if arch not in by_arch:         # a window leaves the params as they are
            by_arch[arch] = jax.jit(lambda k: JT.init_params(
                k, cfg, max_seq=64))(jax.random.PRNGKey(0))
        params = by_arch[arch]
        logits, cache = jax.jit(lambda p, t: JT.prefill(
            p, cfg, {"tokens": t}))(params, jnp.asarray(R.prompts(cfg)))
        S_cache = min(R.MAX_SEQ, window) if window else R.MAX_SEQ
        cache = jax.tree_util.tree_map(
            lambda a: jnp.asarray(_positions(np.asarray(a), S_cache)), cache)
        step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
        rows = [np.asarray(logits[:, 0])]
        tokens = []
        for t in range(R.DECODE_STEPS):
            nxt = np.asarray(jnp.argmax(logits[:, 0], -1)).astype(np.int32)
            tokens.append(nxt)
            logits, cache = step(params, cache, jnp.asarray(nxt[:, None]),
                                 jnp.int32(R.PROMPT + t))
            rows.append(np.asarray(logits[:, 0]))
        out[(arch, window)] = dict(params=_np(params), logits=rows,
                                   tokens=tokens, cfg=cfg)
    return out


@pytest.fixture(scope="module")
def world(reference):
    trees = {k: v["params"] for k, v in reference.items()}
    return spawn(R.run_world, N_RANKS, trees, device="cpu", threads=1)


def test_plain_decode_lse_matches_the_reference_kernel_and_numpy():
    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 5, 48, 6, 2, 32
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lens = np.array([0, 1, S, 17, 40], np.int32)
    o, lse = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(lens), return_lse=True)
    assert o.shape == (B, H, D) and lse.shape == (B, H)
    assert lse.dtype == torch.float32
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lens),
                               block_k=16, interpret=True))
    some = lens > 0
    np.testing.assert_allclose(o.numpy()[some], want[some], atol=1e-5,
                               rtol=1e-5)
    assert np.all(o.numpy()[~some] == 0)
    assert np.all(lse.numpy()[~some] == -1e30)
    g = H // Hkv
    s = np.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, g, D) * D ** -0.5,
                  k).reshape(B, H, S)
    for b in np.flatnonzero(some):
        x = s[b, :, :lens[b]].astype(np.float64)
        m = x.max(-1, keepdims=True)
        ref = (m + np.log(np.exp(x - m).sum(-1, keepdims=True)))[:, 0]
        np.testing.assert_allclose(lse.numpy()[b], ref, atol=LSE_TOL,
                                   rtol=LSE_TOL)
    # without the lse: the same output
    again = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens))
    assert torch.equal(again, o)


class _TwoParts:
    """A stand-in mesh whose gather returns two ranks' parts."""

    def __init__(self, parts):
        self.parts = parts

    def gather(self, local, dim, axes):
        return torch.cat(self.parts, dim)


def test_merge_of_two_halves_is_the_whole():
    """Positions cut in two at 24: rows 0 and 3 wholly in the first half
    (the second holds none of theirs: out 0, lse -1e30), rows 1 and 2
    across both; the merge of the halves' partials is the whole cache's
    attention."""
    g = torch.Generator().manual_seed(1)
    B, S, H, Hkv, D = 4, 48, 4, 1, 16
    q = torch.randn((B, H, D), generator=g)
    k = torch.randn((B, S, Hkv, D), generator=g)
    v = torch.randn((B, S, Hkv, D), generator=g)
    lens = torch.tensor([20, 48, 30, 1], dtype=torch.int32)
    want = ops.decode_attention(q, k, v, lens)
    parts = []
    for i in range(2):
        n = torch.clamp(lens - 24 * i, 0, 24).to(torch.int32)
        o, lse = ops.decode_attention(q, k[:, 24 * i:24 * (i + 1)].clone(),
                                      v[:, 24 * i:24 * (i + 1)].clone(), n,
                                      return_lse=True)
        parts.append(torch.cat([o, lse[..., None]], -1)[None])
    # the second half holds no position of rows 0 and 3
    assert torch.all(parts[1][0, [0, 3], :, -1] == -1e30)
    got = merge_partials(parts[0][0, ..., :-1], parts[0][0, ..., -1],
                         _TwoParts(parts), None)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def _rule_shapes(cfg, preset: str) -> dict:
    """Each cache leaf's shape on a rank under the reference's rule on a
    (2, 2) ``AbstractMesh`` (every rank's is the same)."""
    from repro.models import pspec as JPS
    jm = _abstract_mesh(R.MESH, ("data", "model"))
    S_cache = (min(R.MAX_SEQ, cfg.sliding_window) if cfg.sliding_window
               else R.MAX_SEQ)
    cache = jax.eval_shape(lambda: JT.init_cache(cfg, R.BATCH, R.MAX_SEQ))
    out = {}
    with JPS.mesh_rules(jm, JSH.SHARDING_PRESETS[preset]):
        for path, (jpath, leaf) in _reference_leaves(cache).items():
            spec = JPS.pspec_for(leaf.shape, JSH.cache_logical_axes(
                cfg, jpath, leaf))
            out["/".join(path)] = tuple(
                s // int(np.prod([jm.shape[a] for a in (
                    e if isinstance(e, tuple) else (e,))]))
                if e is not None else s for s, e in zip(leaf.shape, spec))
            assert out["/".join(path)][2] in (S_cache, S_cache // 2)
    return out


@pytest.mark.parametrize("name,arch,preset,window", R.CASES)
def test_mesh_prefill_and_decode_match_the_unsharded_reference(
        world, reference, name, arch, preset, window):
    ref = reference[(arch, window)]
    rows = [r[name] for r in world]
    want_shapes = _rule_shapes(ref["cfg"], preset)
    for r in rows:
        assert r["cache_shapes"] == want_shapes, (r["coord"], want_shapes)
        assert r["after_shapes"] == want_shapes
        a, n = r["rows"]
        for s, (got, want) in enumerate(zip(r["logits"], ref["logits"])):
            np.testing.assert_allclose(got, want[a:a + n], atol=LOGITS_ATOL,
                                       rtol=0, err_msg=f"{name} step {s}")
        for got, want in zip(r["tokens"], ref["tokens"]):
            assert np.array_equal(got, want[a:a + n]), name
        for other in rows:                    # the same rows, the same bits
            if other["rows"] == r["rows"]:
                assert all(np.array_equal(x, y) for x, y in
                           zip(r["logits"], other["logits"])), name
    # every rank's rows cover the batch
    assert sorted({r["rows"] for r in rows}) == [
        (i, rows[0]["rows"][1]) for i in range(0, R.BATCH,
                                               rows[0]["rows"][1])]


def test_the_sequence_cut_adds_one_gather_a_layer(world):
    """granite reduced (one KV head, so its attention replicates): a
    decode step's collectives are one MLP all-reduce a layer, the vocab
    lookup's and the logits' joins, and under ``baseline`` and
    ``infer-tp``, whose rule cuts its cache's positions over "model",
    one gather a layer of the partials, on that axis; ``infer-tp2``
    keeps the cache whole (its "seq" maps to no axis), so nothing more,
    every one over both axes.  ``baseline`` also gathers each layer's
    FSDP-cut weights over "data"."""
    L = R.config("granite-20b").n_layers
    for r in world:
        for name, model, mesh in (("mqa_baseline", 2 * L + 2, 0),
                                  ("mqa_infer_tp", 2 * L + 2, 0),
                                  ("mqa_infer_tp2", 0, L + 2)):
            for c in r[name]["collectives"]:
                assert (c["model"], c["mesh"]) == (model, mesh), (name, c)
                assert (c["data"] > 0) == (name == "mqa_baseline"), (name, c)


@pytest.mark.parametrize("preset,batch,ok", [
    ("baseline", ("pod", "data"), True),
    ("baseline", ("data",), True),        # the dry-run's trimmed map
    ("baseline", (), True),               # one row: replicated
    ("baseline", ("model",), False),
    ("baseline", ("data", "model"), False),
    ("infer-tp", ("model",), False),
    ("dp", ("data",), True),
    ("dp", ("model",), False),
])
def test_a_preset_takes_only_its_own_batch_cut(preset, batch, ok):
    """A map is a preset's only where its "batch" axes are the preset's
    or a leading part of them (what ``dryrun._batch_map`` leaves where
    the rows do not divide): a batch cut over "model", the axis of the
    TP sums and the experts, is refused, in serving and in training,
    naming the presets it takes."""
    from repro_torch.config import get_reduced_config
    from repro_torch.launch import sharding as SH
    cfg = get_reduced_config("qwen1.5-4b")
    lmap = dict(SH.train_map(preset), batch=batch)
    checks = [SH.check_serve] + ([SH.check_train] if preset != "infer-tp"
                                 else [])
    for check in checks:
        if ok:
            assert check(cfg, lmap) == lmap
        else:
            with pytest.raises(NotImplementedError, match="presets"):
                check(cfg, lmap)

"""Inputs shared by the port's kernel tests (tests/test_torch_kernels.py
on the CPU, tests/test_torch_cuda.py on the card).  numpy only."""
import numpy as np

PS = 16


def paged_inputs(B, H, Hkv, D, max_bt, seed):
    """(q, k_pages, v_pages, block_tables, kv_len) as float32/int32 numpy
    arrays: shuffled block tables over pages of 16 positions, kv_len
    values that end mid-page (and 1), an idle all-scratch row, table
    entries past each length on the scratch page 0, and garbage there."""
    rng = np.random.default_rng(seed)
    n_pages = B * max_bt + 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, PS, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, Hkv, D)).astype(np.float32)
    kp[0] *= 50.0
    vp[0] = 1e3
    bt = rng.permutation(np.arange(1, n_pages)).reshape(B, max_bt)
    lens = rng.integers(1, max_bt * PS + 1, B)
    lens[0] = 1
    lens[1] = 2 * PS + 5
    for b in range(B):
        bt[b, -(-lens[b] // PS):] = 0
    bt[-1] = 0
    lens[-1] = 1
    return (q, kp, vp, bt.astype(np.int32), lens.astype(np.int32))


def paged_lengths_inputs(lens, H, Hkv, D, ps, seed, max_pages=None):
    """(q, k_pages, v_pages, block_tables, kv_len) as float32/int32 numpy
    arrays for sequences of the given lengths over pages of ``ps``
    positions: each sequence on shuffled pages of its own, the table as
    wide as the longest (or ``max_pages``, if wider), entries past each
    length on the scratch page 0, and 1e4 planted there and in every
    page's rows past its sequence's length (a read past kv_len would
    show)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    need = -(-lens // ps)
    max_pages = max(int(need.max()), max_pages or 0)
    n_pages = int(need.sum()) + 1
    q = rng.standard_normal((len(lens), H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    kp[0] = vp[0] = 1e4
    pages = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(lens), max_pages), np.int32)
    i = 0
    for b, n in enumerate(need):
        bt[b, :n] = pages[i:i + n]
        tail = lens[b] - (n - 1) * ps
        kp[pages[i + n - 1], tail:] = vp[pages[i + n - 1], tail:] = 1e4
        i += n
    return q, kp, vp, bt, lens


def shared_paged_inputs(lens, H, Hkv, D, ps, n_shared, seed):
    """(q, k_pages, v_pages, block_tables, kv_len) as float32/int32 numpy
    arrays for block tables after prefix-cache hits: every row's first
    ``n_shared`` entries name the same physical pages (one indexed run),
    except row 1, whose last shared page is a forked copy (a
    copy-on-write: the same bits up to mid-page, then its own writes);
    each row's pages past the run are its own, the table as wide as the
    longest, entries past each length on the scratch page 0, and 1e4
    planted there and past each sequence's length.  Every length must
    reach into its last shared page."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    assert lens.min() > (n_shared - 1) * ps and len(lens) > 1
    need = -(-lens // ps)
    private = np.maximum(need - n_shared, 0)
    n_pages = 1 + n_shared + 1 + int(private.sum())
    q = rng.standard_normal((len(lens), H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    kp[0] = vp[0] = 1e4
    ids = rng.permutation(np.arange(1, n_pages))
    shared, fork, rest = ids[:n_shared], ids[n_shared], ids[n_shared + 1:]
    half = ps // 2
    kp[fork, :half], vp[fork, :half] = kp[shared[-1], :half], \
        vp[shared[-1], :half]
    bt = np.zeros((len(lens), int(need.max())), np.int32)
    i = 0
    for b, n in enumerate(need):
        row = list(shared[:min(n, n_shared)])
        if b == 1:
            row[-1] = fork
        row += list(rest[i:i + private[b]])
        i += private[b]
        bt[b, :n] = row
        if private[b]:                      # past the length on its own page
            tail = lens[b] - (n - 1) * ps
            kp[row[-1], tail:] = vp[row[-1], tail:] = 1e4
    return q, kp, vp, bt, lens


def attention_inputs(B, S, H, Hkv, D, seed):
    """(q (B,S,H,D), k, v (B,S,Hkv,D)) float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def ssm_inputs(B, S, H, P, N, G, seed, strong=False):
    """(x (B,S,H,P), dt (B,S,H) post-softplus, A (H,) < 0, Bm, Cm
    (B,S,G,N)) as float32 numpy arrays.  ``strong``: A = -16 and dt
    around 6, so l_t - l_s reaches ~1e4 in the masked half of the decay
    matrix and exp of it overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, H)).astype(np.float32)
    if strong:
        A[:] = -16.0
        dt = (4.0 * dt + 4.0).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


# block tables after prefix-cache hits: (H, Hkv, D) of smollm-360m and the
# tiansuan pair's ONBOARD tier, the shared run's pages, and kv_len values
# (page 16) from inside the last shared page to past the run
SHARED_HEADS = [(15, 5, 64), (4, 2, 48)]
SHARED_RUN, SHARED_LENS = 4, [49, 64, 65, 100, 80, 57, 200, 63]
# and a run of 16 pages (a 256-token system header, as chip_smoke.py's
# shared_prefix phase serves) with lengths up to header + tail + new
# tokens: (run, lengths) pairs
SHARED_CASES = [(SHARED_RUN, SHARED_LENS),
                (16, [241, 256, 257, 280, 300, 330, 352, 264])]

# one sequence (B = 1, as the speculative decoder's one-slot engines
# decode) at the tiansuan pair's heads (D = 48): lengths from 1 to a 64-token prompt plus 64 new and 8 drafted tokens
# and two more, in a table of the draft engine's width (138 positions,
# 9 pages of 16); a handful of (sequence, KV head) pairs takes the
# kernel's largest cluster
SINGLE_LENS = [1, 2, 5, 15, 16, 17, 33, 48, 64, 96, 127, 128, 129, 137,
               138]
SINGLE_PAGES = 9

# (H, Hkv, D) at which the decode kernels' tile and cluster edges are
# checked: smollm-360m, granite's 48 query heads over one KV head at
# D = 128, a group of 16 at D = 128, zamba2-7b's 32/32 at D = 112; and
# the page sizes of the paged kernel's edges
EDGE_HEADS = [(15, 5, 64), (48, 1, 128), (16, 1, 128), (32, 32, 112)]
EDGE_PAGE_SIZES = [16, 128]


def edge_lengths(C, tile):
    """kv_len 1, tile - 1, tile, tile + 1 and C*tile - 1, C*tile,
    C*tile + 1 (and one tile more) for a decode kernel's cut of C CTAs a
    cluster and ``tile`` positions a tile: a CTA's range ending just
    before, at and just past a tile, and the cluster's CTAs each getting
    one tile, less or more."""
    return [1, tile - 1, tile, tile + 1, C * tile - 1, C * tile,
            C * tile + 1, C * tile + tile]


# the JAX package's int8 kernel test's shapes (tests/test_kernels.py), then
# odd shapes the Pallas kernel's row blocks would refuse
INT8_SHAPES = [(256, 128), (512, 384), (128, 2048)]
INT8_ODD = [(333, 1000), (1, 3072)]


def int8_inputs(N, D, seed):
    """(N, D) float32: scaled normal rows and, for N >= 4, a zero row (row
    1) and rows of planted exact .5 ties (rows 2 and 3): absmax 127
    (scale 1) and 254 (scale 2) make x / scale land on k + .5, which
    half-to-even rounding sends to the even neighbour."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, D)) * 3.0).astype(np.float32)
    if N < 4:
        return x
    x[1] = 0.0
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                    np.float32)
    for r, amax in ((2, 127.0), (3, 254.0)):
        x[r] = 0.0
        x[r, 0] = amax
        k = min(len(ties), D - 1)
        x[r, 1:1 + k] = ties[:k] * (amax / 127.0)
    return x

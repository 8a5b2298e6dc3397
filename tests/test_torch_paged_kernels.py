"""The paged attention kernels of the PyTorch port against the JAX reference.

The port's plain versions (``repro_torch.kernels.ref``, what the kernel
wrappers run for CPU tensors) are held against the reference's jnp
oracles over the case tables of ``tests/test_kernels.py`` (``PD_CASES``,
``FT_CASES``, ``PP_CASES``) on the same inputs made with numpy, and
against its Pallas kernels in interpret mode on one case each.
Tolerances as there: 2e-5 in f32 (summation order), 2e-2 in bf16 (bf16
rounding of inputs and outputs), 3e-5 / 3e-2 for the fused tail, whose
projection sums H*hd products.  A slot whose table is all unbound, and a
padded query row, have no visible key: their output is unspecified (the
plain versions give the mean of the values, the kernels 0) and is not
compared.  The CUDA cases hold each Hopper kernel against its plain
version on the card and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

PD_CASES = [
    # b, h, hkv, hd, bs, entries, window
    (1, 4, 4, 32, 8, 4, 0),
    (2, 8, 2, 64, 16, 6, 0),
    (3, 8, 1, 80, 8, 5, 16),           # MQA + window + non-128 hd
    (2, 4, 2, 128, 32, 3, 48),
]
FT_CASES = [
    # b, h, hkv, hd, bs, entries, window, d_model
    (1, 4, 4, 32, 8, 4, 0, 48),
    (2, 8, 2, 64, 16, 6, 0, 128),
    (3, 8, 1, 80, 8, 5, 16, 56),
    (2, 4, 2, 128, 32, 3, 48, 96),
]
PP_CASES = [
    # b, c, h, hkv, hd, bs, entries, window
    (1, 8, 4, 4, 32, 8, 4, 0),
    (2, 5, 8, 2, 64, 16, 6, 0),
    (3, 16, 8, 1, 80, 8, 5, 16),
    (2, 3, 4, 2, 128, 32, 3, 48),
]
DTYPES = [("float32", jnp.float32, torch.float32, 2e-5),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, 2e-2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def paged_case(rng, b, hkv, hd, bs, entries):
    """Pool, tables and t as ``tests/test_kernels.py::_paged_case``:
    partial last blocks, unbound tails, the last slot empty when b > 1."""
    n_pool = b * entries + 2
    kp = rng.normal(size=(n_pool, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pool, bs, hkv, hd)).astype(np.float32)
    tables = np.full((b, entries), -1, np.int32)
    t = np.zeros((b,), np.int32)
    perm = rng.permutation(n_pool)
    nxt = 0
    for i in range(b):
        if b > 1 and i == b - 1:
            continue
        nb = int(rng.integers(1, entries + 1))
        tables[i, :nb] = perm[nxt:nxt + nb]
        nxt += nb
        t[i] = int(rng.integers((nb - 1) * bs, nb * bs))
    return kp, vp, tables, t


def span_positions(t, c):
    """A span of c queries ending at each slot's t (-1 before position 0)."""
    q_pos = t[:, None] - np.arange(c)[::-1][None, :]
    return np.where(q_pos >= 0, q_pos, -1).astype(np.int32)


def decode_inputs(seed, b, h, hkv, hd, bs, entries, d=None):
    rng = np.random.default_rng(seed)
    kp, vp, tables, t = paged_case(rng, b, hkv, hd, bs, entries)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    wo = None if d is None else (rng.normal(size=(h * hd, d)) * hd ** -0.5).astype(np.float32)
    return q, kp, vp, tables, t, wo


def both(arrays, jdt, tdt):
    """Float arrays as (jax, torch) pairs of the working dtype; int arrays
    as int32."""
    out = []
    for a in arrays:
        if a.dtype == np.int32:
            out.append((jnp.asarray(a), torch.from_numpy(a)))
        else:
            out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


@pytest.mark.parametrize("b,h,hkv,hd,bs,entries,window", PD_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_paged_decode_plain_vs_reference(b, h, hkv, hd, bs, entries, window,
                                         dname, jdt, tdt, tol):
    q, kp, vp, tables, t, _ = decode_inputs(hd + bs, b, h, hkv, hd, bs, entries)
    (jq, tq), (jk, tk), (jv, tv), (jtab, ttab), (jt, tt) = both((q, kp, vp, tables, t), jdt, tdt)
    got = ops.paged_decode_attention(tq, tk, tv, ttab, tt, window=window)
    want = jref.paged_decode_attention(jq, jk, jv, jtab, jt, window=window)
    assert got.dtype == tdt and got.shape == (b, h, hd)
    act = tables.max(axis=1) >= 0
    np.testing.assert_allclose(_np(got)[act], _np(want)[act], atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,hkv,hd,bs,entries,window,d", FT_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_fused_decode_tail_plain_vs_reference(b, h, hkv, hd, bs, entries, window, d,
                                              dname, jdt, tdt, tol):
    q, kp, vp, tables, t, wo = decode_inputs(hd + d, b, h, hkv, hd, bs, entries, d)
    (jq, tq), (jk, tk), (jv, tv), (jw, tw), (jtab, ttab), (jt, tt) = \
        both((q, kp, vp, wo, tables, t), jdt, tdt)
    got = ops.fused_decode_tail(tq, tk, tv, tw, ttab, tt, window=window)
    want = jref.fused_decode_tail(jq, jk, jv, jw, jtab, jt, window=window)
    assert got.dtype == tdt and got.shape == (b, d)
    act = tables.max(axis=1) >= 0
    tol = 1.5 * tol
    np.testing.assert_allclose(_np(got)[act], _np(want)[act], atol=tol, rtol=tol)


@pytest.mark.parametrize("b,c,h,hkv,hd,bs,entries,window", PP_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_paged_prefill_plain_vs_reference(b, c, h, hkv, hd, bs, entries, window,
                                          dname, jdt, tdt, tol):
    rng = np.random.default_rng(hd + c)
    kp, vp, tables, t = paged_case(rng, b, hkv, hd, bs, entries)
    q = rng.normal(size=(b, c, h, hd)).astype(np.float32)
    q_pos = span_positions(t, c)
    (jq, tq), (jk, tk), (jv, tv), (jtab, ttab), (jp, tp) = \
        both((q, kp, vp, tables, q_pos), jdt, tdt)
    got = ops.paged_prefill_attention(tq, tk, tv, ttab, tp, window=window)
    want = jref.paged_prefill_attention(jq, jk, jv, jtab, jp, window=window)
    assert got.dtype == tdt and got.shape == (b, c, h, hd)
    ok = (q_pos >= 0) & (tables.max(axis=1) >= 0)[:, None]
    np.testing.assert_allclose(_np(got)[ok], _np(want)[ok], atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [0, 6])
def test_chunked_prefill_plain_vs_reference(window):
    rng = np.random.default_rng(window)
    b, c, s, h, hkv, hd = 2, 5, 24, 4, 2, 32
    q = rng.normal(size=(b, c, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    key_pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    key_pos[rng.random((b, s)) < 0.2] = -1
    q_pos = np.array([[10, 11, 12, 13, -1], [19, 20, 21, 22, 23]], np.int32)
    got = ref.chunked_prefill_attention(*map(torch.from_numpy, (q, k, v, key_pos, q_pos)),
                                        window=window)
    want = jref.chunked_prefill_attention(*map(jnp.asarray, (q, k, v, key_pos, q_pos)),
                                          window=window)
    ok = q_pos >= 0
    np.testing.assert_allclose(_np(got)[ok], _np(want)[ok], atol=2e-5, rtol=2e-5)


def test_plain_versions_vs_pallas_interpret():
    """One case of each kernel against the reference's Pallas kernel run
    in interpret mode, as ``tests/test_kernels.py`` runs it."""
    q, kp, vp, tables, t, wo = decode_inputs(0, *FT_CASES[1][:6], d=FT_CASES[1][7])
    window = FT_CASES[1][6]
    act = tables.max(axis=1) >= 0
    tq, tk, tv, tw, ttab, tt = map(torch.from_numpy, (q, kp, vp, wo, tables, t))
    jq, jk, jv, jw, jtab, jt = map(jnp.asarray, (q, kp, vp, wo, tables, t))
    pairs = [
        (ops.paged_decode_attention(tq, tk, tv, ttab, tt, window=window),
         jops.paged_decode_attention(jq, jk, jv, jtab, jt, window=window,
                                     backend="pallas_interpret"), act, 2e-5),
        (ops.fused_decode_tail(tq, tk, tv, tw, ttab, tt, window=window),
         jops.fused_decode_tail(jq, jk, jv, jw, jtab, jt, window=window,
                                backend="pallas_interpret"), act, 3e-5),
    ]
    b, c, h, hkv, hd, bs, entries, window = PP_CASES[2]
    rng = np.random.default_rng(5)
    kp, vp, tables, t = paged_case(rng, b, hkv, hd, bs, entries)
    q = rng.normal(size=(b, c, h, hd)).astype(np.float32)
    q_pos = span_positions(t, c)
    pairs.append((ops.paged_prefill_attention(*map(torch.from_numpy, (q, kp, vp, tables, q_pos)),
                                              window=window),
                  jops.paged_prefill_attention(*map(jnp.asarray, (q, kp, vp, tables, q_pos)),
                                               window=window, backend="pallas_interpret"),
                  (q_pos >= 0) & (tables.max(axis=1) >= 0)[:, None], 2e-5))
    for got, want, ok, tol in pairs:
        np.testing.assert_allclose(_np(got)[ok], _np(want)[ok], atol=tol, rtol=tol)


def poisoned_case(seed=0):
    """One slot holding blocks 2 and 1, at t = bs + 2: the last three
    rows of block 1 and beyond lie past t."""
    rng = np.random.default_rng(seed)
    b, h, hkv, hd, bs, d = 1, 2, 2, 16, 8, 24
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kp = rng.normal(size=(4, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(4, bs, hkv, hd)).astype(np.float32)
    wo = rng.normal(size=(h * hd, d)).astype(np.float32)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[1, 4:] = 1e3
    vp2[1, 4:] = -1e3
    tables = np.array([[2, 1]], np.int32)
    t = np.array([bs + 2], np.int32)
    return [torch.from_numpy(x) for x in (q, kp, vp, kp2, vp2, wo, tables, t)]


def test_paged_decode_partial_block_masks_future():
    q, kp, vp, kp2, vp2, _, tables, t = poisoned_case()
    base = ops.paged_decode_attention(q, kp, vp, tables, t)
    np.testing.assert_allclose(_np(ops.paged_decode_attention(q, kp2, vp2, tables, t)),
                               _np(base), atol=2e-5, rtol=2e-5)


def test_fused_decode_tail_partial_block_masks_future():
    q, kp, vp, kp2, vp2, wo, tables, t = poisoned_case(1)
    base = ops.fused_decode_tail(q, kp, vp, wo, tables, t)
    np.testing.assert_allclose(_np(ops.fused_decode_tail(q, kp2, vp2, wo, tables, t)),
                               _np(base), atol=2e-5, rtol=2e-5)


def test_fused_tail_is_attention_then_projection():
    """The plain fused tail is the unfused path's composition exactly."""
    q, kp, vp, tables, t, wo = decode_inputs(3, 2, 4, 2, 32, 8, 4, d=48)
    tq, tk, tv, tw, ttab, tt = map(torch.from_numpy, (q, kp, vp, wo, tables, t))
    attn = ref.paged_decode_attention(tq, tk, tv, ttab, tt)
    assert torch.equal(ref.fused_decode_tail(tq, tk, tv, tw, ttab, tt),
                       torch.matmul(attn.reshape(2, -1), tw))


def test_cpu_tensors_never_launch_a_paged_kernel():
    ops.reset_launches()
    q, kp, vp, kp2, vp2, wo, tables, t = poisoned_case()
    ops.paged_decode_attention(q, kp, vp, tables, t)
    ops.fused_decode_tail(q, kp, vp, wo, tables, t)
    ops.paged_prefill_attention(q[:, None], kp, vp, tables, t[:, None])
    assert set(ops.LAUNCHES.values()) == {0}


# b, hkv, entries, bs, capacity: the paged engine's shapes on each kernel's
# resident grid (paged decode, fused tail), one entry, a ragged E * bs
# (not a whole number of tiles), block sizes 8, 16 and 32, B * Hkv of 8
# and 16, and B = 64 with E * bs = 32768
PAGED_PLAN_GRID = [
    (8, 2, 48, 16, 396), (8, 2, 48, 16, 264), (1, 1, 1, 16, 264), (3, 2, 7, 8, 396),
    (4, 2, 64, 8, 264), (8, 2, 32, 32, 396), (8, 1, 48, 16, 264), (2, 4, 100, 8, 396),
    (64, 8, 2048, 16, 264), (64, 1, 1024, 32, 396)]


def _check_paged_plan(b, hkv, entries, bs, capacity, min_tiles):
    """The split plan of the paged kernels: whole 16-key tiles covering
    [0, E * bs) in order, no empty split, none shorter than min_tiles tiles
    when there is more than one, at most two blocks per SM of an H100
    unless each (slot, kv head) takes one split, within the resident grid;
    returns n_split."""
    from repro_torch.kernels.decode_attention import TILE, split_ranges
    from repro_torch.kernels.paged_decode_attention import split_plan
    n_sm, bh, positions = 132, b * hkv, entries * bs
    n_split = split_plan(b, hkv, positions, n_sm, capacity, min_tiles)
    tiles = -(-positions // TILE)
    assert 1 <= n_split <= tiles
    assert n_split == 1 or bh * n_split <= min(capacity, 2 * n_sm + bh)
    ranges = split_ranges(positions, n_split)
    assert ranges[0][0] == 0 and ranges[-1][1] == positions
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(positions, None)]):
        assert lo % TILE == 0 and lo < hi == nxt
    if n_split > 1:
        assert min(hi - lo for lo, hi in ranges) >= min(min_tiles * TILE, positions)
    return n_split


@pytest.mark.parametrize("b,hkv,entries,bs,capacity", PAGED_PLAN_GRID)
def test_decode_split_plan_covers_the_table(b, hkv, entries, bs, capacity):
    from repro_torch.kernels.paged_decode_attention import SPLIT_TILES
    n_split = _check_paged_plan(b, hkv, entries, bs, capacity, SPLIT_TILES)
    if (b, hkv, entries, bs) == (8, 2, 48, 16):     # the paged engine: 12 splits of 64 keys
        assert n_split == 12


@pytest.mark.parametrize("b,hkv,entries,bs,capacity", PAGED_PLAN_GRID)
def test_fused_tail_split_rows_cover_the_positions(b, hkv, entries, bs, capacity):
    """The fused tail splits as paged decode does, into splits of at
    least its own SPLIT_TILES tiles; its grid takes every split item at
    once (the splits of a (slot, kv head) wait for each
    other) and one block per projection tile where the resident grid
    allows."""
    from repro_torch.kernels.fused_decode_tail import SPLIT_TILES, TN, launch_grid
    n_split = _check_paged_plan(b, hkv, entries, bs, capacity, SPLIT_TILES)
    if (b, hkv, entries, bs, capacity) == (8, 2, 48, 16, 264):   # the engine: 16 of 48 keys
        assert n_split == 16
    for d in (64, 1536, 4096):
        grid = launch_grid(b, hkv, n_split, d, capacity)
        assert 1 <= grid <= capacity
        assert n_split == 1 or grid >= b * hkv * n_split
        assert grid >= min(capacity, -(-d // TN))


def _paged_split_merge(q, kp, vp, tables, t, n_split, window=0):
    """Both paged kernels' attention in plain PyTorch: each slot's
    positions [0, E * bs) in the splits of ``split_ranges``, each cut to
    the positions a key may be visible at ([t - window + 1 with a window,
    t]) and possibly empty; per split the partial state (m, l, acc) of
    every head over its visible keys (m = -1e30, l = 0, acc = 0 with
    none); per head M = the splits' largest m, l and acc weighed by exp(m
    - M) and added in split order, and the max(l, 1e-30) clamp.  In f64."""
    from repro_torch.kernels.decode_attention import split_ranges
    b, h, hd = q.shape
    hkv = kp.shape[2]
    kg, vg, kpos = ref.gather_pool(kp, vp, tables)
    out = torch.zeros(b, h, hd, dtype=torch.float64)
    for s in range(b):
        tb = int(t[s])
        qg = q[s].reshape(hkv, h // hkv, hd).double()
        states = []
        for lo, hi in split_ranges(kg.shape[1], n_split):
            lo, hi = max(lo, tb - window + 1 if window > 0 else 0), min(hi, tb + 1)
            keys = torch.arange(lo, max(lo, hi))
            p = kpos[s, keys]
            valid = (p >= 0) & (p <= tb)
            if window > 0:
                valid &= p > tb - window
            sc = torch.einsum("ngd,knd->ngk", qg, kg[s, keys].double()) * hd ** -0.5
            sc = torch.where(valid, sc, torch.full_like(sc, ref.NEG_INF))
            m = sc.max(dim=-1, keepdim=True).values if len(keys) else \
                torch.full((hkv, h // hkv, 1), ref.NEG_INF, dtype=torch.float64)
            e = torch.where(valid, torch.exp(sc - m), torch.zeros_like(sc))
            states.append((m, e.sum(-1, keepdim=True),
                           torch.einsum("ngk,knd->ngd", e, vg[s, keys].double())))
        big_m = torch.stack([m for m, _, _ in states]).max(dim=0).values
        big_l, big_a = torch.zeros_like(big_m), torch.zeros_like(qg)
        for m, l, acc in states:
            c = torch.exp(m - big_m)
            big_l, big_a = big_l + l * c, big_a + acc * c
        out[s] = (big_a / big_l.clamp_min(1e-30)).reshape(h, hd)
    return out


# b, h, hkv, hd, bs, entries, window, n_split: slots whose later splits lie
# past t (every key masked), the last slot unbound (no visible key), a
# window opening inside a tile, hd 40, B = 20 (two row tiles of the fused
# tail's projection)
PAGED_MERGE_CASES = [
    (3, 8, 2, 32, 8, 12, 0, 4), (3, 12, 2, 40, 16, 8, 37, 5), (20, 4, 2, 16, 16, 6, 0, 3),
    (4, 6, 1, 64, 32, 4, 0, 8), (2, 16, 1, 64, 8, 20, 24, 20)]


@pytest.mark.parametrize("b,h,hkv,hd,bs,entries,window,n_split", PAGED_MERGE_CASES)
def test_paged_decode_split_merge_matches_plain(b, h, hkv, hd, bs, entries, window, n_split):
    """The one-launch merge of paged decode attention, mirrored on the
    CPU, equals the plain version; a slot with no visible key gives 0."""
    q, kp, vp, tables, t, _ = decode_inputs(b + hd, b, h, hkv, hd, bs, entries)
    tq, tk, tv, ttab, tt = map(torch.from_numpy, (q, kp, vp, tables, t))
    got = _paged_split_merge(tq, tk, tv, ttab, tt, n_split, window)
    want = ref.paged_decode_attention(tq, tk, tv, ttab, tt, window=window)
    act = tables.max(axis=1) >= 0
    assert (~act).any() and (t < (entries - 2) * bs).any()   # an empty slot, a masked split
    np.testing.assert_allclose(_np(got)[act], _np(want)[act], atol=1e-5, rtol=1e-5)
    assert torch.all(got[torch.from_numpy(~act)] == 0)


@pytest.mark.parametrize("b,h,hkv,hd,bs,entries,window,n_split", PAGED_MERGE_CASES)
def test_fused_tail_merge_then_project_matches_plain(b, h, hkv, hd, bs, entries, window,
                                                     n_split):
    """The fused tail's algebra on the CPU: the merged contexts rounded to
    the working dtype, then projected in f32 by row tiles of 16 slots, each
    of the kernel's four warps adding the k pairs (32 contexts) w, w + 4,
    ... and the warps' parts added in order; equals the plain version."""
    d = 40
    q, kp, vp, tables, t, wo = decode_inputs(b + d, b, h, hkv, hd, bs, entries, d)
    tq, tk, tv, tw, ttab, tt = map(torch.from_numpy, (q, kp, vp, wo, tables, t))
    ctx = _paged_split_merge(tq, tk, tv, ttab, tt, n_split, window).to(tq.dtype).float()
    ctx = ctx.reshape(b, h * hd)
    got = torch.zeros(b, d)
    n_pairs = -(-h * hd // 32)
    for r0 in range(0, b, 16):
        rows = slice(r0, r0 + 16)
        for w in range(4):
            part = torch.zeros(min(16, b - r0), d)
            for p in range(w, n_pairs, 4):
                part += ctx[rows, 32 * p:32 * p + 32] @ tw[32 * p:32 * p + 32].float()
            got[rows] += part
    want = ref.fused_decode_tail(tq, tk, tv, tw, ttab, tt, window=window)
    act = tables.max(axis=1) >= 0
    np.testing.assert_allclose(_np(got)[act], _np(want)[act], atol=1e-5, rtol=1e-5)
    assert torch.all(got[torch.from_numpy(~act)] == 0)


PLAN_GRID = [   # c, start, window, entries, bs, n_sm
    (128, 384, 0, 48, 16, 132),      # the chunked engine's span
    (128, 0, 0, 48, 16, 132), (128, 512, 0, 48, 16, 132), (128, 40, 0, 48, 16, 132),
    (5, 93, 0, 8, 16, 132), (300, 1000, 0, 128, 16, 132), (128, 700, 256, 64, 16, 132),
    (77, 24, 48, 20, 32, 16), (200, 100, 0, 60, 8, 1), (1, 0, 0, 1, 1, 132),
    (64, 4090, 100, 256, 16, 264),
]


def _tile_positions(c, start, block_q):
    """Each q tile's (lowest, highest) position of a span [start, start + c)."""
    return [(start + q0, start + min(q0 + block_q, c) - 1) for q0 in range(0, c, block_q)]


@pytest.mark.parametrize("c,start,window,entries,bs,n_sm", PLAN_GRID)
def test_paged_prefill_split_plan_covers_the_tiles(c, start, window, entries, bs, n_sm):
    from repro_torch.kernels import paged_prefill_attention as pp
    n_split = pp.split_plan(1, c, 12, entries, bs, n_sm)
    max_tiles = -(-entries * bs // pp.BLOCK_K)
    assert 1 <= n_split <= max_tiles
    for qmin, qmax in _tile_positions(c, start, pp.BLOCK_Q):
        begin, end = pp.visible_tiles(qmin, qmax, window, entries, bs)
        # the tiles that hold a key some query of the tile can see
        keys = [k for k in range(entries * bs) if any(
            k <= p and (window <= 0 or k > p - window) for p in (qmin, qmax))
            or qmin <= k <= qmax]
        assert set(range(begin, end)) == {k // pp.BLOCK_K for k in keys}
        ranges = pp.split_ranges(begin, end, n_split)
        assert len(ranges) <= max(1, end - begin) and len(ranges) <= n_split
        covered = [kt for lo, hi in ranges for kt in range(lo, hi)]
        assert covered == list(range(begin, end))          # each tile once, in order
        if end > begin:
            assert all(hi > lo for lo, hi in ranges)       # no split is empty


def _merged_split_attention(q, kp, vp, tables, q_pos, window, n_split, block_q):
    """The kernel's algebra on the CPU: per (slot, head, q tile), each
    split's partial (m, l, acc) over its key tiles in the log2 domain,
    then the merge in split order, acc / max(l, 1e-30)."""
    from repro_torch.kernels import paged_prefill_attention as pp
    b, c, h, hd = q.shape
    e, bs = tables.shape[1], kp.shape[1]
    kg, vg, kpos = ref.gather_pool(kp, vp, tables)
    group = h // kp.shape[2]
    scale_log2 = hd ** -0.5 * 1.4426950408889634
    out = torch.zeros_like(q)
    for s in range(b):
        for q0 in range(0, c, block_q):
            rows = range(q0, min(q0 + block_q, c))
            pos = q_pos[s, q0:q0 + block_q]
            real = pos[pos >= 0]
            if real.numel() == 0:
                continue
            begin, end = pp.visible_tiles(int(real.min()), int(real.max()), window, e, bs)
            for hh in range(h):
                parts = []
                for lo, hi in pp.split_ranges(begin, end, n_split):
                    keys = torch.arange(lo * pp.BLOCK_K, min(hi * pp.BLOCK_K, e * bs))
                    kp_ = kpos[s, keys]
                    vis = (kp_[None] >= 0) & (kp_[None] <= pos[:, None]) & (pos[:, None] >= 0)
                    if window > 0:
                        vis &= kp_[None] > pos[:, None] - window
                    x = q[s, q0:q0 + block_q, hh] @ kg[s, keys, hh // group].T * scale_log2
                    x = torch.where(vis, x, torch.full_like(x, -1e30))
                    m = x.max(dim=1).values
                    p = torch.where(vis, torch.exp2(x - m[:, None]), torch.zeros_like(x))
                    parts.append((m, p.sum(dim=1), p @ vg[s, keys, hh // group]))
                mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                l = sum(l_ * torch.exp2(m - mx) for m, l_, _ in parts)
                acc = sum(a * torch.exp2(m - mx)[:, None] for m, _, a in parts)
                out[s, q0:q0 + block_q, hh] = acc / l.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("c,start,window,entries,bs,n_split", [
    (128, 384, 0, 48, 16, 8), (128, 0, 0, 48, 16, 3), (128, 512, 0, 48, 16, 4),
    (70, 50, 40, 16, 8, 2), (20, 5, 0, 4, 16, 5)])
def test_paged_prefill_split_merge_matches_plain(c, start, window, entries, bs, n_split):
    rng = np.random.default_rng(c + start)
    b, h, hkv, hd = 2, 4, 2, 32
    n_pool = b * entries
    kp = torch.from_numpy(rng.normal(size=(n_pool, bs, hkv, hd)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(n_pool, bs, hkv, hd)).astype(np.float32))
    perm = rng.permutation(n_pool)
    tables = np.full((b, entries), -1, np.int32)
    q_pos = np.full((b, c), -1, np.int32)
    for s in range(b):
        end = start + c - 3 * s                 # the second slot's span ends earlier
        nb = -(-end // bs)
        tables[s, :nb] = perm[s * entries:s * entries + nb]
        q_pos[s] = np.arange(end - c, end)
    q_pos[q_pos < 0] = -1
    tables, q_pos = torch.from_numpy(tables), torch.from_numpy(q_pos)
    q = torch.from_numpy(rng.normal(size=(b, c, h, hd)).astype(np.float32))
    from repro_torch.kernels.paged_prefill_attention import BLOCK_Q
    got = _merged_split_attention(q, kp, vp, tables, q_pos, window, n_split, BLOCK_Q)
    want = ref.paged_prefill_attention(q, kp, vp, tables, q_pos, window=window)
    ok = q_pos >= 0
    np.testing.assert_allclose(_np(got[ok]), _np(want[ok]), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, tdt, *arrays):
    return [torch.from_numpy(a).to(dev) if a.dtype == np.int32
            else torch.from_numpy(a).to(dev, tdt) for a in arrays]


# the case table, then: hd 40 (not a multiple of 16), block sizes 8, 16
# and 32, a slot whose table is all unbound ("unbound"), a window opening
# inside a tile, and B = 20 slots at D = 1536 (two row tiles of the fused
# tail's projection); every call at forced split plans 1, 2 and the most
# the resident grid takes, twice, bitwise equal
KERNEL_CASES = [case + (None,) for case in FT_CASES] + [
    # b, h, hkv, hd, bs, entries, window, d, variant
    (3, 8, 2, 40, 16, 10, 0, 64, None), (4, 12, 2, 128, 8, 64, 0, 256, None),
    (4, 12, 2, 128, 16, 32, 0, 256, None), (4, 12, 2, 128, 32, 16, 0, 256, None),
    (3, 12, 2, 128, 16, 20, 0, 128, "unbound"), (3, 12, 2, 128, 16, 20, 37, 128, None),
    (20, 12, 2, 128, 16, 48, 0, 1536, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,hd,bs,entries,window,d,variant", KERNEL_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_paged_decode_kernels_vs_plain(cuda, b, h, hkv, hd, bs, entries, window, d, variant,
                                       dname, jdt, tdt, tol):
    from repro_torch.kernels import fused_decode_tail as ft
    from repro_torch.kernels import paged_decode_attention as pd
    q, kp, vp, tables, t, wo = decode_inputs(hd, b, h, hkv, hd, bs, entries, d)
    if variant == "unbound":
        tables[0] = -1
    q, kp, vp, wo, tables, t = _on(cuda, tdt, q, kp, vp, wo, tables, t)
    act = tables.max(dim=1).values >= 0
    before = dict(ops.LAUNCHES)
    got = ops.paged_decode_attention(q, kp, vp, tables, t, window=window)
    fused = ops.fused_decode_tail(q, kp, vp, wo, tables, t, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == before["paged_decode_attention"] + 1
    assert ops.LAUNCHES["fused_decode_tail"] == before["fused_decode_tail"] + 1
    want = ref.paged_decode_attention(q, kp, vp, tables, t, window=window)
    wantf = ref.fused_decode_tail(q, kp, vp, wo, tables, t, window=window)[act].float()
    code = 1 if tdt == torch.bfloat16 else 0
    cap = min(pd._capacity(code, hd, q.device), ft._capacity(code, h, hkv, hd, q.device))
    most = min(-(-entries * bs // 16), cap // (b * hkv))
    for n_split in (None, 1, 2, most):
        for name, call in (
                ("paged", lambda: pd.paged_decode_attention_split(q, kp, vp, tables, t, n_split,
                                                                  window=window)),
                ("fused", lambda: ft.fused_decode_tail_split(q, kp, vp, wo, tables, t, n_split,
                                                             window=window))):
            if n_split == 2 and most < 2:
                continue
            out, again = call(), call()
            torch.cuda.synchronize()
            assert torch.equal(out, again), f"{name} n_split={n_split}: two calls differ"
            assert torch.all(out[~act] == 0), f"{name}: a slot with no visible key is not 0"
            if name == "paged":
                np.testing.assert_allclose(_np(out[act]), _np(want[act]), atol=tol, rtol=tol)
            else:   # relative to the output's largest magnitude: H * hd products a value
                err = (out[act].float() - wantf).abs().max().item()
                assert err <= tol * wantf.abs().max().item(), f"n_split={n_split}"
    assert torch.equal(got, pd.paged_decode_attention_cuda(q, kp, vp, tables, t, window=window))
    assert torch.equal(fused, ft.fused_decode_tail_cuda(q, kp, vp, wo, tables, t, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, 2, 3, None])
def test_fused_tail_split_plans_agree(cuda, n_split):
    # every split plan, not only the one the wrapper picks for a shape,
    # computes the same function: f32, against the plain version
    from repro_torch.kernels.fused_decode_tail import fused_decode_tail_split
    b, h, hkv, hd, bs, entries, window, d = FT_CASES[2]
    q, kp, vp, tables, t, wo = decode_inputs(n_split or 0, b, h, hkv, hd, bs, entries, d)
    q, kp, vp, wo, tables, t = _on(cuda, torch.float32, q, kp, vp, wo, tables, t)
    got = fused_decode_tail_split(q, kp, vp, wo, tables, t, n_split, window=window)
    want = ref.fused_decode_tail(q, kp, vp, wo, tables, t, window=window)
    act = tables.max(dim=1).values >= 0
    np.testing.assert_allclose(_np(got[act]), _np(want[act]), atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_paged_kernels_replay_from_a_cuda_graph(cuda):
    """One call of each paged kernel captured in a CUDA graph (a
    cooperative launch whose barriers read their base from their counts
    when they run) replays to the bits of the eager call, twice."""
    from repro_torch.kernels.fused_decode_tail import fused_decode_tail_cuda
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
    q, kp, vp, tables, t, wo = decode_inputs(7, 8, 12, 2, 128, 16, 48, 1536)
    q, kp, vp, wo, tables, t = _on(cuda, torch.bfloat16, q, kp, vp, wo, tables, t)
    for call in (lambda: paged_decode_attention_cuda(q, kp, vp, tables, t),
                 lambda: fused_decode_tail_cuda(q, kp, vp, wo, tables, t)):
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


def span_case(rng, b, c, hkv, hd, bs, entries, start):
    """Pool and tables whose slot s holds a span of c queries ending at
    start + c - 1 - s (positions before 0 padded), every entry up to it
    bound and the rest unbound."""
    n_pool = b * entries + 2
    kp = rng.normal(size=(n_pool, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pool, bs, hkv, hd)).astype(np.float32)
    perm = rng.permutation(n_pool)
    tables = np.full((b, entries), -1, np.int32)
    t = np.zeros((b,), np.int32)
    for s in range(b):
        t[s] = start + c - 1 - s
        nb = t[s] // bs + 1
        tables[s, :nb] = perm[s * entries:s * entries + nb]
    return kp, vp, tables, t


# paged_case spans (start None), then spans at fixed starts: at position 0,
# mid-block, the chunked engine's [384, 512) and a re-ingest's [512, 640),
# with forced split plans (n_split None: the wrapper's own plan)
PP_KERNEL_CASES = [case + (None, None) for case in PP_CASES] + [
    # b, c, h, hkv, hd, bs, entries, window, start, n_split
    (1, 128, 12, 2, 128, 16, 48, 0, 0, None), (2, 100, 8, 2, 64, 16, 12, 0, 7, None),
    (1, 128, 12, 2, 128, 16, 48, 0, 384, None), (1, 128, 12, 2, 128, 16, 48, 0, 512, None),
    (1, 128, 12, 2, 128, 16, 48, 0, 384, 1), (1, 128, 12, 2, 128, 16, 48, 0, 384, 2),
    (1, 128, 12, 2, 128, 16, 48, 0, 384, 8), (2, 128, 12, 2, 128, 16, 48, 0, 512, 10),
    (3, 70, 8, 1, 80, 8, 40, 48, 200, 2), (2, 150, 4, 2, 32, 16, 20, 0, 140, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,hkv,hd,bs,entries,window,start,n_split", PP_KERNEL_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_paged_prefill_kernel_vs_plain(cuda, b, c, h, hkv, hd, bs, entries, window, start,
                                       n_split, dname, jdt, tdt, tol):
    from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda
    rng = np.random.default_rng(c)
    if start is None:
        kp, vp, tables, t = paged_case(rng, b, hkv, hd, bs, entries)
    else:
        kp, vp, tables, t = span_case(rng, b, c, hkv, hd, bs, entries, start)
    q = rng.normal(size=(b, c, h, hd)).astype(np.float32)
    q, kp, vp, tables, q_pos = _on(cuda, tdt, q, kp, vp, tables, span_positions(t, c))
    if n_split is None:
        got = ops.paged_prefill_attention(q, kp, vp, tables, q_pos, window=window)
    elif tdt == torch.float32 and n_split > 1:      # the f32 kernel does not split
        with pytest.raises(ValueError, match="n_split"):
            paged_prefill_attention_cuda(q, kp, vp, tables, q_pos, window=window,
                                         n_split=n_split)
        got = paged_prefill_attention_cuda(q, kp, vp, tables, q_pos, window=window, n_split=1)
    else:
        got = paged_prefill_attention_cuda(q, kp, vp, tables, q_pos, window=window,
                                           n_split=n_split)
        again = paged_prefill_attention_cuda(q, kp, vp, tables, q_pos, window=window,
                                             n_split=n_split)
        assert torch.equal(got, again)       # the merge's order is fixed
    want = ref.paged_prefill_attention(q, kp, vp, tables, q_pos, window=window)
    torch.cuda.synchronize()
    ok = (q_pos >= 0) & (tables.max(dim=1).values >= 0)[:, None]
    np.testing.assert_allclose(_np(got[ok]), _np(want[ok]), atol=tol, rtol=tol)
    assert torch.all(got[q_pos < 0] == 0)


@pytest.mark.cuda
def test_paged_kernels_mask_a_poisoned_partial_block(cuda):
    q, kp, vp, kp2, vp2, wo, tables, t = [x.to(cuda) for x in poisoned_case()]
    np.testing.assert_allclose(_np(ops.paged_decode_attention(q, kp2, vp2, tables, t)),
                               _np(ref.paged_decode_attention(q, kp, vp, tables, t)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(ops.fused_decode_tail(q, kp2, vp2, wo, tables, t)),
                               _np(ref.fused_decode_tail(q, kp, vp, wo, tables, t)),
                               atol=2e-5, rtol=2e-5)

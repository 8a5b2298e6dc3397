"""Attention kernels of the PyTorch port against the JAX reference.

The port's plain versions (``repro_torch.kernels.ref``, what the kernel
wrappers run for CPU tensors) are held against the reference's Pallas
kernels in interpret mode and its jnp oracles, on the same inputs made
with numpy, over the case tables of ``tests/test_kernels.py``.
Tolerances as there: 2e-5 in f32 (summation order), 2e-2 in bf16
(bf16 rounding of inputs and outputs).  The CUDA cases hold each Hopper
kernel against its plain version on the card and skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

FA_CASES = [
    # b, s, h, hkv, hd, window, segs
    (1, 64, 4, 4, 32, 0, False),
    (2, 128, 4, 2, 64, 0, True),
    (1, 96, 8, 1, 80, 32, False),     # MQA + SWA + non-128 hd
    (2, 256, 2, 2, 128, 0, True),
    (1, 128, 4, 2, 16, 16, True),
]

DA_CASES = [
    # b, h, hkv, hd, w, window
    (1, 4, 4, 32, 64, 0),
    (2, 8, 2, 64, 128, 0),
    (3, 8, 1, 80, 96, 16),             # MQA, window, ragged W
    (1, 16, 4, 128, 256, 64),
]

DTYPES = [("float32", jnp.float32, torch.float32, 2e-5),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, 2e-2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread each, so this file does not
    crowd the processes that other test files run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, jdt, tdt):
    """The same values as a jax array and a torch tensor."""
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _fa_inputs(rng, b, s, h, hkv, hd, segs):
    """segs: False (no segment ids), True (packed segments 0..3) or
    "pad" (rows right-padded with segment -1, as a prefill batch)."""
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    seg = None
    if segs == "pad":
        lengths = rng.integers(s // 2, s + 1, size=b)
        seg = np.where(np.arange(s)[None] < lengths[:, None], 0, -1).astype(np.int32)
    elif segs:
        seg = np.sort(rng.integers(0, 4, size=(b, s)), axis=1).astype(np.int32)
    return q, k, v, seg


def _sees_a_key(pos, t, window):
    """(B,) bool: whether a slot sees at least one key, some ring entry
    with 0 <= pos <= t (and pos > t - window when window > 0)."""
    tb = t[:, None]
    valid = (pos >= 0) & (pos <= tb)
    if window > 0:
        valid &= pos > tb - window
    return valid.any(axis=1)


def _da_inputs(rng, b, h, hkv, hd, w):
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kc = rng.normal(size=(b, w, hkv, hd)).astype(np.float32)
    vc = rng.normal(size=(b, w, hkv, hd)).astype(np.float32)
    pos = np.tile(np.arange(w), (b, 1))
    pos[rng.random((b, w)) < 0.3] = -1                  # empty ring slots
    t = rng.integers(w // 2, w, size=(b,))
    return q, kc, vc, pos.astype(np.int32), t.astype(np.int32)


@pytest.mark.parametrize("b,s,h,hkv,hd,window,segs", FA_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_plain_vs_reference(b, s, h, hkv, hd, window, segs,
                                            dname, jdt, tdt, tol):
    q, k, v, seg = _fa_inputs(np.random.default_rng(s + hd), b, s, h, hkv, hd, segs)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, jdt, tdt), _pair(k, jdt, tdt), _pair(v, jdt, tdt)
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    got = ops.flash_attention(tq, tk, tv, tseg, window=window)
    assert got.dtype == tdt and got.shape == (b, s, h, hd)
    for backend in ("jnp", "pallas_interpret"):
        want = jops.flash_attention(jq, jk, jv, jseg, window=window, backend=backend)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=backend)


@pytest.mark.parametrize("b,h,hkv,hd,w,window", DA_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_decode_attention_plain_vs_reference(b, h, hkv, hd, w, window, dname, jdt, tdt, tol):
    q, kc, vc, pos, t = _da_inputs(np.random.default_rng(w + hd), b, h, hkv, hd, w)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, jdt, tdt), _pair(kc, jdt, tdt), _pair(vc, jdt, tdt)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(t),
                               window=window)
    assert got.dtype == tdt and got.shape == (b, h, hd)
    for backend in ("jnp", "pallas_interpret"):
        want = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(t),
                                     window=window, backend=backend)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=backend)


def test_plain_decode_casts_probabilities_like_reference():
    """bf16: the probabilities are rounded to q's dtype before the PV
    product, as ``repro/kernels/ref.py`` does.  With the same rounding the
    port's bf16 output equals the jnp oracle's bit for bit here; with f32
    probabilities about a third of the elements differ by one bf16 step."""
    q, kc, vc, pos, t = _da_inputs(np.random.default_rng(5), 2, 8, 2, 64, 128)
    (jq, tq), (jk, tk), (jv, tv) = [_pair(x, jnp.bfloat16, torch.bfloat16) for x in (q, kc, vc)]
    got = ref.decode_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(t))
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(t))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_cross_attention_raises():
    q = torch.zeros(1, 4, 2, 64)
    k = torch.zeros(1, 6, 2, 64)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, k)


def test_cpu_tensors_never_launch_a_kernel():
    ops.reset_launches()
    q, k, v, seg = _fa_inputs(np.random.default_rng(0), 1, 16, 2, 1, 64, True)
    tq = torch.from_numpy(q).requires_grad_(True)      # and its backward
    ops.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(seg)).sum().backward()
    q, kc, vc, pos, t = _da_inputs(np.random.default_rng(0), 1, 2, 1, 64, 32)
    ops.decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc, pos, t)))
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                            "decode_attention": 0, "paged_decode_attention": 0,
                            "paged_prefill_attention": 0, "fused_decode_tail": 0,
                            "linear_scan": 0}


@pytest.mark.parametrize("capacity", [264, 396])     # 2 or 3 resident blocks per SM
@pytest.mark.parametrize("b,hkv,w", [(1, 1, 1), (8, 2, 1), (3, 2, 17), (2, 1, 100),
                                      (8, 2, 768), (8, 1, 768), (16, 1, 1000), (4, 2, 2048),
                                      (5, 1, 4096), (64, 8, 32), (8, 2, 32768), (8, 1, 32768),
                                      (64, 8, 32768)])
def test_decode_split_plan_fills_the_card(b, hkv, w, capacity):
    """Whole 16-key tiles, no empty split, the splits covering [0, W) in
    order, and at least two blocks per SM of an H100 where the tiles and
    the resident grid allow it, never more than that grid."""
    from repro_torch.kernels.decode_attention import TILE, split_plan, split_ranges
    n_sm, bh = 132, b * hkv
    n_split = split_plan(b, hkv, w, n_sm, capacity)
    n_tiles = -(-w // TILE)
    assert 1 <= n_split <= n_tiles
    assert n_split == 1 or bh * n_split <= capacity
    assert bh * n_split >= min(2 * n_sm, bh * n_tiles, capacity - bh + 1)
    if (b, hkv, w, capacity) in ((8, 2, 768, 396), (8, 1, 768, 264)):
        # the serving paths' shapes on their kernels' resident grids
        assert bh * n_split >= 2 * n_sm
    ranges = split_ranges(w, n_split)
    assert ranges[0][0] == 0 and ranges[-1][1] == w
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(w, None)]):
        assert lo % TILE == 0 and lo < hi == nxt
        assert hi % TILE == 0 or hi == w
    sizes = [-(-(hi - lo) // TILE) for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1


def _split_merge(q, kc, vc, pos, t, n_split, window=0):
    """The kernel's algorithm in plain PyTorch: per split of
    ``split_ranges``, the partial state (m, l, acc) of the group's heads
    over its keys; then, per head, M = the splits' largest m, and the
    splits' l and acc weighed by exp(m - M) and added in split order; the
    max(l, 1e-30) clamp.  q (B, H, hd), caches (B, W, Hkv, hd)."""
    from repro_torch.kernels.decode_attention import split_ranges
    b, h, hd = q.shape
    w, hkv = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd).double()
    tb = t[:, None, None, None]
    states = []
    for lo, hi in split_ranges(w, n_split):
        s = torch.einsum("bngd,bwnd->bngw", qg, kc[:, lo:hi].double()) * hd ** -0.5
        p = pos[:, None, None, lo:hi]
        valid = (p >= 0) & (p <= tb)
        if window:
            valid &= p > tb - window
        s = torch.where(valid, s, torch.full_like(s, ref.NEG_INF))
        m = s.max(dim=-1, keepdim=True).values
        e = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        states.append((m, e.sum(-1, keepdim=True),
                       torch.einsum("bngw,bwnd->bngd", e, vc[:, lo:hi].double())))
    big_m = torch.stack([m for m, _, _ in states]).max(dim=0).values
    big_l, big_a = torch.zeros_like(big_m), torch.zeros_like(qg)
    for m, l, acc in states:
        c = torch.exp(m - big_m)
        big_l, big_a = big_l + l * c, big_a + acc * c
    return (big_a / big_l.clamp_min(1e-30)).reshape(b, h, hd).float()


@pytest.mark.parametrize("b,h,hkv,hd,w,window", [(3, 12, 2, 128, 100, 0), (2, 16, 1, 256, 768, 0),
                                                 (3, 6, 1, 64, 1000, 37), (1, 4, 4, 64, 40, 0)])
def test_decode_split_merge_matches_plain(b, h, hkv, hd, w, window):
    """The one-launch merge, mirrored on the CPU: per-split states merged
    in split order equal the plain version at every split plan, with a
    split whose every key is masked (slot 0 holds nothing in its first
    tiles) and a slot with no visible key (the last), which gives 0."""
    from repro_torch.kernels.decode_attention import TILE, split_plan
    q, kc, vc, pos, t = _da_inputs(np.random.default_rng(w + h), b, h, hkv, hd, w)
    pos[0, :TILE * (1 if w < 64 else 2)] = -1
    if b > 1:
        pos[-1] = -1
    tq, tk, tv, tpos, tt = (torch.from_numpy(x) for x in (q, kc, vc, pos, t))
    want = ref.decode_attention(tq, tk, tv, tpos, tt, window=window)
    live = slice(0, b - 1) if b > 1 else slice(0, b)
    n_tiles = -(-w // TILE)
    for n_split in sorted({1, 2, split_plan(b, hkv, w, 132, 264), n_tiles}):
        got = _split_merge(tq, tk, tv, tpos, tt, min(n_split, n_tiles), window=window)
        np.testing.assert_allclose(_np(got[live]), _np(want[live]), atol=1e-5, rtol=1e-5,
                                   err_msg=f"n_split={n_split}")
        if b > 1:
            assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_pallas_decode_kernels_give_zero_where_no_key_is_seen(kind):
    """The convention the Hopper decode kernels follow: the TPU kernels
    (Pallas, interpret mode) give exactly 0 for a slot that sees no key
    (p is 0 wherever masked, then acc / max(l, 1e-30)), where the plain
    versions spread the slot uniformly over its rows.  Ring: W = 1 with
    its one entry empty, an entry past t, an entry outside the window;
    paged: a slot whose table binds nothing.  Slot 0 sees keys."""
    rng = np.random.default_rng(7)
    b, h, hkv, hd = 3, 4, 2, 64
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    if kind == "ring":
        for w, pos, t, window in ((1, [[0], [-1], [5]], [0, 0, 3], 0),
                                  (4, [[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 2, 3]], [3, 3, 9], 4)):
            kc = rng.normal(size=(b, w, hkv, hd)).astype(np.float32)
            vc = rng.normal(size=(b, w, hkv, hd)).astype(np.float32)
            pos, t = np.array(pos, np.int32), np.array(t, np.int32)
            assert list(_sees_a_key(pos, t, window)) == [True, False, False]
            args = [jnp.asarray(v) for v in (q, kc, vc, pos, t)]
            got = np.asarray(jops.decode_attention(*args, window=window,
                                                   backend="pallas_interpret"))
            plain = np.asarray(jops.decode_attention(*args, window=window, backend="jnp"))
            assert np.all(got[1:] == 0) and np.all(plain[1:] != 0)
            np.testing.assert_allclose(got[0], plain[0], atol=2e-5, rtol=2e-5)
            port = _split_merge(*(torch.from_numpy(v) for v in (q, kc, vc, pos, t)), 1,
                                window=window)
            assert torch.all(port[1:] == 0)
    else:
        bs, entries = 16, 4
        kp = rng.normal(size=(b * entries, bs, hkv, hd)).astype(np.float32)
        vp = rng.normal(size=(b * entries, bs, hkv, hd)).astype(np.float32)
        tables = np.full((b, entries), -1, np.int32)
        tables[0] = np.arange(entries)
        tables[2, 1:] = entries + np.arange(entries - 1)    # t inside the unbound entry 0
        t = np.array([40, 20, 5], np.int32)
        args = [jnp.asarray(v) for v in (q, kp, vp, tables, t)]
        got = np.asarray(jops.paged_decode_attention(*args, backend="pallas_interpret"))
        plain = np.asarray(jops.paged_decode_attention(*args, backend="jnp"))
        assert np.all(got[1:] == 0)
        np.testing.assert_allclose(got[0], plain[0], atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd,window,segs",
                         [c for c in FA_CASES if c[4] in (64, 128)]
                         + [(2, 200, 12, 2, 128, 0, True), (1, 130, 6, 2, 64, 48, True),
                            # head_dim 256 with MQA, the RG-LRU hybrid's local layers
                            (2, 200, 16, 1, 256, 0, True), (1, 130, 16, 1, 256, 48, True),
                            (1, 96, 4, 2, 256, 0, False),
                            # ragged S (not a multiple of 64 or 128) with B > 1, so a
                            # tile's rows run past S: TMA must zero-fill them, never
                            # reading the next batch row; padding segments at the tail
                            (3, 577, 4, 2, 128, 0, "pad"), (2, 200, 4, 1, 64, 0, "pad"),
                            (2, 577, 16, 1, 256, 0, "pad"),
                            # windows whose first visible key falls inside a tile
                            (2, 300, 4, 2, 128, 100, "pad"), (1, 577, 16, 1, 256, 200, True),
                            (2, 200, 4, 2, 64, 70, False)])
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_kernel_vs_plain(cuda, b, s, h, hkv, hd, window, segs,
                                         dname, jdt, tdt, tol):
    q, k, v, seg = _fa_inputs(np.random.default_rng(s), b, s, h, hkv, hd, segs)
    tq, tk, tv = (torch.from_numpy(x).to(cuda, tdt) for x in (q, k, v))
    tseg = None if seg is None else torch.from_numpy(seg).to(cuda)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(tq, tk, tv, tseg, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention(tq, tk, tv, segment_ids=tseg, window=window)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), atol=tol, rtol=tol)


# b, h, hkv, hd, w, window, variant.  Variants: "empty" (the last slot
# sees no key: 0), "plans" (forced split plans 1, 2 and one per tile, each
# twice, bitwise equal), "nan_tail" (B=1 caches that are a view [:, :W]
# of a longer buffer whose tail is NaN: no row past W is read)
DA_CARD_CASES = (
    [c + (None,) for c in DA_CASES if c[3] in (64, 128)]
    + [(8, 12, 2, 128, 768, 0, None), (3, 6, 2, 64, 1000, 100, None),
       (8, 16, 1, 256, 768, 0, None), (3, 16, 1, 256, 100, 16, None),
       # W = 1 and ragged W (not a multiple of the 16-key tile or the stage)
       (2, 12, 2, 128, 1, 0, None), (1, 16, 1, 256, 1, 0, None), (3, 12, 2, 128, 17, 0, None),
       (2, 16, 1, 256, 100, 0, None), (2, 6, 2, 64, 1000, 0, None),
       # groups of 1, 6 and 16 at head_dim 64, 128 and 256
       (2, 4, 4, 64, 200, 0, None), (2, 6, 1, 64, 300, 0, None), (2, 16, 1, 64, 130, 40, None),
       (2, 8, 8, 128, 300, 0, None), (2, 6, 1, 128, 257, 0, None), (2, 32, 2, 128, 333, 50, None),
       (2, 2, 2, 256, 150, 0, None), (2, 12, 2, 256, 515, 0, None), (64, 12, 2, 128, 32, 0, None),
       # windows opening inside a tile
       (2, 12, 2, 128, 1000, 37, None), (2, 16, 1, 256, 2048, 1000, None),
       (3, 12, 2, 128, 768, 0, "empty"), (3, 16, 1, 256, 300, 0, "empty"),
       (2, 12, 2, 128, 1000, 0, "plans"), (2, 16, 1, 256, 768, 100, "plans"),
       (1, 12, 2, 128, 100, 0, "nan_tail"), (1, 16, 1, 256, 777, 0, "nan_tail")])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,hd,w,window,variant", DA_CARD_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_decode_attention_kernel_vs_plain(cuda, b, h, hkv, hd, w, window, variant,
                                          dname, jdt, tdt, tol):
    from repro_torch.kernels.decode_attention import TILE, decode_attention_split
    q, kc, vc, pos, t = _da_inputs(np.random.default_rng(w), b, h, hkv, hd, w)
    if variant == "empty":
        pos[-1] = -1
    tq, tk, tv = (torch.from_numpy(x).to(cuda, tdt) for x in (q, kc, vc))
    if variant == "nan_tail":
        pad = lambda x: torch.cat([x, torch.full_like(x[:, :50], float("nan"))], dim=1)[:, :w]
        tk, tv = pad(tk), pad(tv)
        assert tk.is_contiguous() and tk.untyped_storage().nbytes() > tk.nbytes
    tpos, tt = torch.from_numpy(pos).to(cuda), torch.from_numpy(t).to(cuda)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(tq, tk, tv, tpos, tt, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = ref.decode_attention(tq, tk, tv, tpos, tt, window=window)
    # the plain version spreads a slot that sees no key uniformly over its
    # rows; the kernel, as the TPU kernel, gives 0 there
    seen = torch.from_numpy(_sees_a_key(pos, t, window)).to(cuda)
    if variant == "empty":
        assert not seen[-1]
    np.testing.assert_allclose(_np(got[seen].cpu()), _np(want[seen].cpu()), atol=tol, rtol=tol)
    assert torch.all(got[~seen] == 0)
    if variant == "plans":
        for n_split in (1, 2, -(-w // TILE)):
            once = decode_attention_split(tq, tk, tv, tpos, tt, n_split, window=window)
            again = decode_attention_split(tq, tk, tv, tpos, tt, n_split, window=window)
            torch.cuda.synchronize()
            assert torch.equal(once, again), f"n_split={n_split}: two calls differ"
            np.testing.assert_allclose(_np(once[seen].cpu()), _np(want[seen].cpu()), atol=tol,
                                       rtol=tol, err_msg=f"n_split={n_split}")
            assert torch.all(once[~seen] == 0)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, device=cuda)
    kc = torch.zeros(1, 16, 2, 64, device=cuda)
    pos = torch.zeros(1, 16, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="cache_pos"):
        ops.decode_attention(q, kc, kc, pos, torch.zeros(1, dtype=torch.int32, device=cuda))

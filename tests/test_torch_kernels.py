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
    ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(seg))
    q, kc, vc, pos, t = _da_inputs(np.random.default_rng(0), 1, 2, 1, 64, 32)
    ops.decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc, pos, t)))
    assert ops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0,
                            "paged_decode_attention": 0, "paged_prefill_attention": 0,
                            "fused_decode_tail": 0, "linear_scan": 0}


def test_decode_split_plan_fills_the_card():
    from repro_torch.kernels.decode_attention import MAX_CHUNK, split_plan
    chunk, n_split = split_plan(8, 2, 768, 132)     # the serving shapes
    assert 8 * 2 * n_split >= 2 * 132 and chunk * n_split >= 768
    for b, hkv, w in ((1, 1, 5), (64, 8, 32768), (3, 2, 100000)):
        chunk, n_split = split_plan(b, hkv, w, 132)
        assert 0 < chunk <= MAX_CHUNK and chunk * n_split >= w > chunk * (n_split - 1)


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,hd,w,window",
                         [c for c in DA_CASES if c[3] in (64, 128)]
                         + [(8, 12, 2, 128, 768, 0), (3, 6, 2, 64, 1000, 100),
                            (8, 16, 1, 256, 768, 0), (3, 16, 1, 256, 100, 16)])
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_decode_attention_kernel_vs_plain(cuda, b, h, hkv, hd, w, window, dname, jdt, tdt, tol):
    q, kc, vc, pos, t = _da_inputs(np.random.default_rng(w), b, h, hkv, hd, w)
    tq, tk, tv = (torch.from_numpy(x).to(cuda, tdt) for x in (q, kc, vc))
    tpos, tt = torch.from_numpy(pos).to(cuda), torch.from_numpy(t).to(cuda)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(tq, tk, tv, tpos, tt, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = ref.decode_attention(tq, tk, tv, tpos, tt, window=window)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), atol=tol, rtol=tol)


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

"""The gradient of the port's flash attention against the JAX reference.

The JAX package has no backward kernel: its trainer differentiates the
jnp oracle ``repro.kernels.ref.flash_attention`` with ``jax.grad``.  On
the CPU the port differentiates its plain version by ``torch.autograd``;
that is held against ``jax.grad`` of the oracle on the same inputs (made
with numpy), and the port's plain backward ``ref.flash_attention_bwd``
(what the backward kernel computes, from the forward's log-sum-exp) is
held against autograd.  ``flash_attention_chunked``, which the CPU route
takes for long rows, is held against its JAX twin, values and
gradients.  All in f32: tolerance 1e-5 absolute and relative, the
rounding of sums over at most a few hundred terms in another order.

The ``cuda`` cases hold the backward kernel (and the forward's
log-sum-exp output) against the plain versions on the card, and skip
without one: f32 at 2e-5 (summation order), bf16 at 2e-2 of each
gradient's largest entry (the kernel rounds P and dS to bf16 for its
tensor-core products, and each gradient to bf16); every call twice,
bitwise equal.  Each gradient is also held by its rms error, whole and
per (batch, head), against ``NORM_TOL``'s rel x rms(reference) + floor:
bf16 1e-2 (a dropped or misweighted tile moves a head by far more), f32
1e-5; the floor, 1e-5, covers gradients that cancel to rounding noise
(a token that sees only itself has dq = dk = 0 up to it, ~8e-7 rms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = 1e-5
NORM_TOL = {torch.bfloat16: (1e-2, 1e-5), torch.float32: (1e-5, 1e-5)}

# b, s, h, hkv, hd, window, segs, causal: GQA groups of 1, 2 and 4,
# packed segments with -1 padding, windows, and without the causal mask
CASES = [
    (1, 24, 4, 4, 16, 0, None, True),
    (2, 40, 4, 2, 16, 0, "packed", True),
    (2, 33, 8, 2, 8, 7, "packed", True),
    (1, 50, 4, 1, 16, 12, None, True),
    (2, 31, 4, 2, 16, 0, "packed", False),
    (1, 29, 6, 2, 8, 5, None, False),
]


def _inputs(seed, b, s, h, hkv, hd, segs):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    dout = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    seg = None
    if segs == "packed":
        # sorted segments, then a -1 padding tail (it attends only to itself)
        seg = np.sort(rng.integers(0, 3, size=(b, s)), axis=1).astype(np.int32)
        seg[:, s - s // 5:] = -1
    elif segs is not None:
        # segments of the given lengths, then a -1 padding tail
        seg = np.full((b, s), -1, np.int32)
        o = 0
        for i, n in enumerate(segs):
            seg[:, o:o + n] = i
            o += n
    return q, k, v, dout, seg


def _t(x, dtype=torch.float32, device="cpu", grad=False):
    return None if x is None else torch.from_numpy(x).to(device, dtype).requires_grad_(grad)


def _jax_grads(fn, q, k, v, dout, seg, **kw):
    segj = None if seg is None else jnp.asarray(seg)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, segment_ids=segj, **kw) * dout)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, grads = jax.jit(jax.value_and_grad(
        lambda *a: (loss(*a), fn(*a, segment_ids=segj, **kw)), argnums=(0, 1, 2),
        has_aux=True))(*args)
    return [np.asarray(out[1])] + [np.asarray(g) for g in grads]


def _torch_grads(fn, q, k, v, dout, seg, **kw):
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    out = fn(tq, tk, tv, segment_ids=_t(seg, torch.int32), **kw)
    out.backward(torch.from_numpy(dout))
    return [out.detach().numpy()] + [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("b,s,h,hkv,hd,window,segs,causal", CASES)
def test_autograd_of_plain_attention_matches_jax_grad(b, s, h, hkv, hd, window, segs, causal):
    q, k, v, dout, seg = _inputs(s, b, s, h, hkv, hd, segs)
    kw = dict(causal=causal, window=window)
    want = _jax_grads(jref.flash_attention, q, k, v, dout, seg, **kw)
    got = _torch_grads(ref.flash_attention, q, k, v, dout, seg, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("b,s,h,hkv,hd,window,segs,causal", CASES)
def test_plain_backward_matches_autograd(b, s, h, hkv, hd, window, segs, causal):
    q, k, v, dout, seg = _inputs(s + 1, b, s, h, hkv, hd, segs)
    kw = dict(causal=causal, window=window)
    out, *want = _torch_grads(ref.flash_attention, q, k, v, dout, seg, **kw)
    tq, tk, tv, tseg = _t(q), _t(k), _t(v), _t(seg, torch.int32)
    lse = ref.flash_attention_lse(tq, tk, segment_ids=tseg, **kw)
    got = ref.flash_attention_bwd(tq, tk, tv, torch.from_numpy(out), lse, torch.from_numpy(dout),
                                  segment_ids=tseg, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL, err_msg=name)


def test_plain_backward_gives_zero_for_a_row_that_sees_no_key():
    q, k, v, dout, _ = _inputs(3, 1, 8, 2, 2, 8, None)
    tq, tk, tv = _t(q), _t(k), _t(v)
    lse = ref.flash_attention_lse(tq, tk)
    lse[:, :, 3] = -float("inf")              # as the kernel writes for such a row
    out = ref.flash_attention(tq, tk, tv)
    dq, dk, dv = ref.flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(dout))
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all() and torch.isfinite(dv).all()
    assert torch.all(dq[:, 3] == 0)


@pytest.mark.parametrize("b,s,h,hkv,hd,window,segs,causal",
                         [(1, 50, 4, 2, 16, 0, "packed", True), (2, 45, 4, 1, 8, 9, None, True),
                          (1, 37, 4, 4, 8, 0, "packed", False)])
def test_chunked_attention_matches_jax_twin(b, s, h, hkv, hd, window, segs, causal):
    q, k, v, dout, seg = _inputs(s + 2, b, s, h, hkv, hd, segs)
    kw = dict(causal=causal, window=window, chunk=16)    # a ragged last chunk
    want = _jax_grads(jref.flash_attention_chunked, q, k, v, dout, seg, **kw)
    got = _torch_grads(ref.flash_attention_chunked, q, k, v, dout, seg, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


def test_cpu_route_switches_to_the_chunked_oracle_on_long_rows():
    q, k, v, _, seg = _inputs(4, 1, 1100, 2, 1, 8, "packed")    # 1100^2 > 2^20 scores
    tq, tk, tv, tseg = _t(q), _t(k), _t(v), _t(seg, torch.int32)
    got = ops.flash_attention(tq, tk, tv, tseg)
    assert torch.equal(got, ref.flash_attention_chunked(tq, tk, tv, tseg))
    np.testing.assert_allclose(got.numpy(),
                               ref.flash_attention(tq, tk, tv, segment_ids=tseg).numpy(),
                               atol=TOL, rtol=TOL)
    short = _t(_inputs(5, 1, 64, 2, 1, 8, None)[0])
    assert torch.equal(ops.flash_attention(short, short[:, :, :1], short[:, :, :1]),
                       ref.flash_attention(short, short[:, :, :1], short[:, :, :1]))


# ---------------------------------------------------------------------------
# on the card: the backward kernel against the plain backward
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = [
    # the trainer's shapes (areal-qwen-1.5b, and the laptop scale of hd 64),
    # ragged S, one token, packed segments with padding, windows
    (1, 768, 12, 2, 128, 0, "packed", True), (4, 256, 4, 2, 64, 0, "packed", True),
    (2, 37, 12, 2, 128, 0, None, True), (1, 1, 4, 2, 64, 0, None, True),
    (2, 300, 4, 2, 128, 100, "packed", True), (1, 200, 12, 2, 64, 0, None, False),
    # the wgmma tiling's edges: 128-row blocks of 64-row tiles.  S not a
    # multiple of 128, GQA group 1; the train row's segments of 727 (ends
    # inside a 64- and a 128-row tile) at S = 6144 + 37; segments ending
    # at 100 and 160 (inside both tile sizes), group 6; one segment over
    # 16 tiles and a -1 tail, group 8; a window of 130 crossing block
    # edges, group 8; non-causal with a window and segments, group 6
    (1, 200, 4, 4, 64, 0, None, True), (1, 6181, 4, 2, 128, 0, (727,) * 8, True),
    (2, 300, 12, 2, 128, 0, (100, 60, 27), True), (1, 1100, 8, 1, 64, 0, (1000,), True),
    (1, 520, 16, 2, 128, 130, (400,), True), (1, 333, 6, 1, 128, 70, (150, 120), False),
]


def _check_kernel_grads(got, again, want, dtype, tol):
    """Two calls bitwise equal, each gradient within ``tol`` of the plain
    backward element by element and within ``NORM_TOL`` by rms."""
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, a), f"{name}: two calls differ"
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(g.float(), w.float(), atol=tol * scale, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")
        _assert_rms_close(name, g, w, *NORM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd,window,segs,causal", CARD_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_backward_kernel_vs_plain(cuda, b, s, h, hkv, hd, window, segs, causal, dtype, tol):
    q, k, v, dout, seg = _inputs(s + 3, b, s, h, hkv, hd, segs)
    tq, tk, tv, tdo = (_t(x, dtype, cuda) for x in (q, k, v, dout))
    tseg = _t(seg, torch.int32, cuda)
    kw = dict(causal=causal, window=window)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
    out, lse = flash_attention_cuda(tq, tk, tv, tseg, return_lse=True, **kw)
    want_lse = ref.flash_attention_lse(tq, tk, segment_ids=tseg, **kw)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    got = flash_attention_bwd_cuda(tq, tk, tv, out, lse, tdo, tseg, **kw)
    again = flash_attention_bwd_cuda(tq, tk, tv, out, lse, tdo, tseg, **kw)
    want = ref.flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tseg, **kw)
    torch.cuda.synchronize()
    _check_kernel_grads(got, again, want, dtype, tol)


# the RG-LRU hybrid's local attention: head_dim 256 in bf16 (the
# trainer's dtype; f32 at 256 raises), MQA groups of 16: a window of 130
# crossing tile edges over a segment and a -1 tail; segments of 2300 and
# 200 under the hybrid's window of 2048; no window, group 4, ragged S;
# non-causal with a window and segments, 6 heads over 2
HD256_CASES = [
    (1, 520, 16, 1, 256, 130, (400,), True), (1, 2600, 16, 1, 256, 2048, (2300, 200), True),
    (2, 200, 4, 1, 256, 0, None, True), (1, 333, 6, 2, 256, 70, (150, 120), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd,window,segs,causal", HD256_CASES)
def test_backward_kernel_at_head_dim_256_vs_plain(cuda, b, s, h, hkv, hd, window, segs, causal):
    """bf16 at head_dim 256, where the two warpgroups of a block split the
    accumulated columns: against the plain backward, element by element
    (2e-2 of each gradient's largest entry) and by rms, whole and per
    head; two calls bitwise equal."""
    q, k, v, dout, seg = _inputs(s + 5, b, s, h, hkv, hd, segs)
    tq, tk, tv, tdo = (_t(x, torch.bfloat16, cuda) for x in (q, k, v, dout))
    tseg = _t(seg, torch.int32, cuda)
    kw = dict(causal=causal, window=window)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
    out, lse = flash_attention_cuda(tq, tk, tv, tseg, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(tq, tk, tv, out, lse, tdo, tseg, **kw)
    again = flash_attention_bwd_cuda(tq, tk, tv, out, lse, tdo, tseg, **kw)
    want = ref.flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tseg, **kw)
    torch.cuda.synchronize()
    _check_kernel_grads(got, again, want, torch.bfloat16, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_backward_kernel_gives_zero_for_a_row_that_sees_no_key(cuda, hd, dtype, tol):
    q, k, v, dout, seg = _inputs(12, 1, 200, 4, 2, hd, (90, 70))
    tq, tk, tv, tdo = (_t(x, dtype, cuda) for x in (q, k, v, dout))
    tseg = _t(seg, torch.int32, cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
    out, lse = flash_attention_cuda(tq, tk, tv, tseg, return_lse=True)
    rows = [5, 63, 64, 130, 199]           # tile and block edges, a -1 row
    lse[:, :, rows] = -float("inf")         # as the forward writes for a row that sees no key
    got = flash_attention_bwd_cuda(tq, tk, tv, out, lse, tdo, tseg)
    again = flash_attention_bwd_cuda(tq, tk, tv, out, lse, tdo, tseg)
    want = ref.flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tseg)
    torch.cuda.synchronize()
    assert torch.all(got[0][:, rows] == 0)
    _check_kernel_grads(got, again, want, dtype, tol)


def _assert_rms_close(name, got, want, rel, floor):
    """rms(got - want) <= rel x rms(want) + floor over a (B, S, H, hd)
    gradient, and over each (batch, head) of it."""
    d, w = got.float() - want.float(), want.float()
    for dims in ((0, 1, 2, 3), (1, 3)):
        err = d.square().mean(dim=dims).sqrt()
        lim = rel * w.square().mean(dim=dims).sqrt() + floor
        assert (err <= lim).all(), f"{name}: rms error {err.max().item()} over {lim.min().item()}"


@pytest.mark.cuda
def test_autograd_on_the_card_launches_the_backward_kernel(cuda):
    q, k, v, dout, seg = _inputs(9, 2, 96, 4, 2, 64, "packed")
    tq, tk, tv = (_t(x, device=cuda, grad=True) for x in (q, k, v))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(tq, tk, tv, _t(seg, torch.int32, cuda))
    out.backward(_t(dout, device=cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    want = _torch_grads(ref.flash_attention, q, k, v, dout, seg)
    for g, w in zip((out, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.detach().cpu().numpy(), w, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_backward_wrapper_rejects_head_dim_256(cuda):
    """In f32 (the CPU-parity dtype) the kernel takes head_dim 64 and 128
    only; bf16 takes 256 too."""
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
    q = torch.zeros(1, 8, 2, 256, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd_cuda(q, q[:, :, :1], q[:, :, :1], q, lse, q)

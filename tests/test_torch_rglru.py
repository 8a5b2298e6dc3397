"""The PyTorch port's RG-LRU pieces against the JAX reference.

The plain ``linear_scan`` (what ``ops.linear_scan`` runs for CPU
tensors) is held against the reference's jnp oracle and its Pallas
kernel in interpret mode over ``tests/test_kernels.py``'s ``LS_CASES``,
at that test's tolerances: 1e-5 in f32 (summation order: an associative
scan against a sequential loop) and 5e-2 in bf16 (bf16 inputs and
outputs).  The causal conv and the RG-LRU forward, decode step and
prefill state are held against ``repro/models/layers.py`` and
``repro/models/rglru.py`` on the same weights and inputs at 1e-5 in
f32.  The CUDA cases hold the Hopper ``linear_scan`` against its plain
version on the card and skip without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, rglru

LS_CASES = [(1, 32, 16), (2, 64, 64), (1, 100, 200), (3, 256, 128)]
DTYPES = [("float32", jnp.float32, torch.float32, 1e-5),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, 5e-2)]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread each, so this file does not
    crowd the processes that other test files run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ls_inputs(rng, b, s, c):
    a = rng.uniform(0.7, 1.0, size=(b, s, c)).astype(np.float32)
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    h0 = rng.normal(size=(b, c)).astype(np.float32)
    return a, x, h0


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("b,s,c", LS_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_linear_scan_plain_vs_reference(b, s, c, with_h0, dname, jdt, tdt, tol):
    a, x, h0 = _ls_inputs(np.random.default_rng(s + c), b, s, c)
    ja, jx, jh0 = (jnp.asarray(v, jdt) for v in (a, x, h0))
    ta, tx, th0 = (torch.from_numpy(v).to(tdt) for v in (a, x, h0))
    if not with_h0:
        jh0 = th0 = None
    h, h_last = ops.linear_scan(ta, tx, th0)
    assert h.dtype == h_last.dtype == tdt and h.shape == (b, s, c) and h_last.shape == (b, c)
    for backend in ("jnp", "pallas_interpret"):
        jh, jl = jops.linear_scan(ja, jx, jh0, backend=backend)
        np.testing.assert_allclose(_np(h), _np(jh), atol=tol, rtol=tol, err_msg=backend)
        np.testing.assert_allclose(_np(h_last), _np(jl), atol=tol, rtol=tol, err_msg=backend)


def test_linear_scan_matches_stepwise():
    """Against numpy's step-by-step recurrence, as
    ``tests/test_kernels.py::test_linear_scan_matches_stepwise``, with an
    ``a`` that reaches 0 (where a cumulative-product form breaks down)."""
    rng = np.random.default_rng(5)
    b, s, c = 2, 37, 8
    a = rng.uniform(0.0, 1.0, size=(b, s, c)).astype(np.float32)
    a[:, 10] = 0.0
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    h0 = rng.normal(size=(b, c)).astype(np.float32)
    h, h_last = ref.linear_scan(*(torch.from_numpy(v) for v in (a, x, h0)))
    cur = h0
    for t in range(s):
        cur = a[:, t] * cur + x[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), cur, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), cur, atol=1e-5, rtol=1e-5)


# ragged shapes: S of one step, around the spans of the kernel's plans (32
# and 128 steps), the engine's admission and re-prefill lengths (463, 559);
# C not a multiple of the 32-channel tile, or of 4
LS_RAGGED = [(2, 1, 33), (1, 31, 200), (2, 33, 36), (1, 127, 12), (1, 129, 20),
             (1, 463, 8), (1, 559, 10)]


@pytest.mark.parametrize("warps,steps", [(8, 4), (16, 8)], ids=["W8L4", "W16L8"])
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("b,s,c", LS_CASES + LS_RAGGED)
def test_linear_scan_span_model_vs_reference(b, s, c, with_h0, warps, steps):
    """The Hopper kernel's decomposition (spans of W*L steps split across
    W warps, slice aggregates folded in warp order, each slice rerun from
    its carry-in) in plain PyTorch, f32, against the reference's jnp
    oracle and Pallas kernel at 1e-5."""
    from repro_torch.kernels.linear_scan import span_scan
    a, x, h0 = _ls_inputs(np.random.default_rng(s + c), b, s, c)
    h, h_last = span_scan(*(torch.from_numpy(v) for v in (a, x)),
                          torch.from_numpy(h0) if with_h0 else None, warps=warps, steps=steps)
    for backend in ("jnp", "pallas_interpret"):
        jh, jl = jops.linear_scan(jnp.asarray(a), jnp.asarray(x),
                                  jnp.asarray(h0) if with_h0 else None, backend=backend)
        np.testing.assert_allclose(h.numpy(), _np(jh), atol=TOL, rtol=TOL, err_msg=backend)
        np.testing.assert_allclose(h_last.numpy(), _np(jl), atol=TOL, rtol=TOL, err_msg=backend)


def _resets_and_underflow(a):
    """a = 0 at a slice's first step, at a span's first step and mid-slice
    (resets), and a run of 1e-12 long enough that a slice's product
    underflows to 0 in f32."""
    a[:, [32, 41, 64, 130]] = 0.0
    a[:, 96:112] = 1e-12
    return a


def test_linear_scan_span_model_resets_and_underflow():
    from repro_torch.kernels.linear_scan import span_scan
    rng = np.random.default_rng(11)
    b, s, c = 2, 300, 6
    a, x, h0 = _ls_inputs(rng, b, s, c)
    a = _resets_and_underflow(a)
    cur, want = h0, np.empty_like(x)
    for t in range(s):
        cur = a[:, t] * cur + x[:, t]
        want[:, t] = cur
    for warps, steps in ((8, 4), (16, 8)):
        h, h_last = span_scan(*(torch.from_numpy(v) for v in (a, x, h0)), warps=warps,
                              steps=steps)
        np.testing.assert_allclose(h.numpy(), want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(h_last.numpy(), cur, atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(h[:, 41].numpy(), x[:, 41])   # reset: exactly x


def test_causal_conv1d_apply_and_step_match_reference():
    rng = np.random.default_rng(2)
    b, s, width, c = 3, 9, 4, 16
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    jw = jlayers.causal_conv1d_init(jax.random.key(1), width, c)
    w = torch.from_numpy(np.array(jw["w"]))
    got = layers.causal_conv1d_apply(w, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlayers.causal_conv1d_apply(
        jw, jnp.asarray(x))), atol=TOL, rtol=TOL)
    # stepping token by token from a zero state gives the same outputs
    state = torch.zeros((b, width - 1, c))
    jstate = jnp.zeros((b, width - 1, c))
    for t in range(s):
        state, out = layers.causal_conv1d_step(w, state, torch.from_numpy(x[:, t]))
        jstate, jout = jlayers.causal_conv1d_step(jw, jstate, jnp.asarray(x[:, t]))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out.numpy(), got[:, t].numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=TOL, rtol=TOL)


def _rglru_pair(seed=0):
    kw = dict(name="t", family="hybrid", n_layers=3, d_model=32, n_heads=4, n_kv_heads=1,
              d_ff=64, vocab_size=64, lru_width=24, block_pattern=("rec", "rec", "local"))
    jcfg, tcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = jrglru.rglru_init(jax.random.key(seed), jcfg)
    p = rglru.RGLRU(tcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp["conv"]["w"] if name == "conv.w"
                                              else jp[name])))
    return jcfg, tcfg, jp, p


def test_rglru_forward_decode_and_prefill_state_match_reference():
    """Right-padded rows (lengths 9, 5, 1 and 2 of 9): the forward, the
    prefill's final state and conv history, then three decode steps from
    that state."""
    jcfg, tcfg, jp, p = _rglru_pair()
    rng = np.random.default_rng(3)
    b, s = 4, 9
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    length = np.array([9, 5, 1, 2])
    valid = np.arange(s)[None, :] < length[:, None]
    h0 = rng.normal(size=(b, jcfg.lru_width)).astype(np.float32)
    tx, tvalid = torch.from_numpy(x), torch.from_numpy(valid)

    out, h_last = rglru.rglru_forward(tcfg, p, tx, h0=torch.from_numpy(h0), valid=tvalid)
    jout, jlast = jrglru.rglru_forward(jcfg, jp, jnp.asarray(x), h0=jnp.asarray(h0),
                                       valid=jnp.asarray(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jlast), atol=TOL, rtol=TOL)

    out, state = rglru.rglru_prefill_state(tcfg, p, tx, valid=tvalid)
    jout, jstate = jrglru.rglru_prefill_state(jcfg, jp, jnp.asarray(x),
                                              valid=jnp.asarray(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    assert state["h"].dtype == torch.float32
    for name in ("h", "conv"):
        np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]),
                                   atol=TOL, rtol=TOL, err_msg=name)
    for _ in range(3):
        xt = rng.normal(size=(b, jcfg.d_model)).astype(np.float32)
        out, state = rglru.rglru_decode_step(tcfg, p, torch.from_numpy(xt), state)
        jout, jstate = jrglru.rglru_decode_step(jcfg, jp, jnp.asarray(xt), jstate)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]),
                                       atol=TOL, rtol=TOL, err_msg=name)
    # without a valid mask: the conv history of a prompt shorter than the
    # conv's left context is zero-padded on the left
    out, state = rglru.rglru_prefill_state(tcfg, p, tx[:, :2])
    jout, jstate = jrglru.rglru_prefill_state(jcfg, jp, jnp.asarray(x[:, :2]))
    for name in ("h", "conv"):
        np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_rglru_init_draws_reference_distributions():
    _, tcfg, _, _ = _rglru_pair()
    tcfg = dataclasses.replace(tcfg, lru_width=4096, d_model=64)
    p = rglru.RGLRU(tcfg, device="cpu", dtype=torch.bfloat16)
    p.init_(torch.Generator().manual_seed(0))
    assert p.lam.dtype == torch.float32 and p.w_a.dtype == torch.bfloat16
    assert 0.38 <= p.lam.min().item() and p.lam.max().item() <= 0.8
    assert abs(p.lam.mean().item() - 0.59) < 0.01
    assert abs(p.conv.w.float().std().item() * 2.0 - 1.0) < 0.05      # 1/sqrt(4)


# ---------------------------------------------------------------------------
# on the card: the Hopper linear scan against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


# the card's cases: S of one step; around the spans of the default plans
# (32 steps for a state row B*C of 128 KB or more, 128 below it); the
# engine's admission and re-prefill lengths (463, 559); C not a multiple
# of the tile or of 4; B = 1 at S = 4096; and a = 0 at chosen steps
# with a run of tiny a ("resets")
LS_CARD_CASES = (
    [c + (None,) for c in LS_CASES + [(8, 512, 4096), (1, 7, 33)]]
    + [(2, 1, 33, None), (2, 31, 200, None), (2, 33, 200, None), (8, 31, 4096, None),
       (8, 33, 4096, None), (1, 127, 4100, None), (1, 129, 4100, None), (8, 463, 4096, None),
       (8, 559, 4096, None), (1, 4096, 4096, None), (2, 300, 200, "resets"),
       (8, 300, 4096, "resets")])


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("b,s,c,variant", LS_CARD_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_linear_scan_kernel_vs_plain(cuda, b, s, c, variant, with_h0, dname, jdt, tdt, tol):
    a, x, h0 = _ls_inputs(np.random.default_rng(s + c), b, s, c)
    if variant == "resets":
        a = _resets_and_underflow(a)
    ta, tx, th0 = (torch.from_numpy(v).to(cuda, tdt) for v in (a, x, h0))
    if not with_h0:
        th0 = None
    before = ops.LAUNCHES["linear_scan"]
    h, h_last = ops.linear_scan(ta, tx, th0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["linear_scan"] == before + 1
    want_h, want_last = ref.linear_scan(ta, tx, th0)
    assert h.dtype == h_last.dtype == tdt
    np.testing.assert_allclose(_np(h.cpu()), _np(want_h.cpu()), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(h_last.cpu()), _np(want_last.cpu()), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_linear_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ops.linear_scan(x.half(), x.half())
    with pytest.raises(ValueError, match="a has dtype"):
        ops.linear_scan(x.bfloat16(), x)
    with pytest.raises(ValueError, match="h0"):
        ops.linear_scan(x, x, torch.zeros(2, 15, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(4, 8, 4), (2, 8, 4), (1, 8, 4), (1, 16, 8)],
                         ids=lambda p: "V%dW%dL%d" % p)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_linear_scan_kernel_plans_vs_plain(cuda, plan, dname, jdt, tdt, tol):
    """Every built plan, forced, at S = one span - 1, one span + 1 and
    several spans with a ragged tail, C ragged against its tile; with h0,
    and with resets; each call twice, bitwise equal."""
    from repro_torch.kernels.linear_scan import PLANS, linear_scan_with_plan
    assert plan in PLANS
    span = plan[1] * plan[2]
    for b, s, c in ((2, span - 1, 200), (2, span + 1, 4100), (1, 3 * span + 5, 36 * plan[0])):
        a, x, h0 = _ls_inputs(np.random.default_rng(s + c), b, s, c)
        if s > 130:
            a = _resets_and_underflow(a)
        ta, tx, th0 = (torch.from_numpy(v).to(cuda, tdt) for v in (a, x, h0))
        h, h_last = linear_scan_with_plan(ta, tx, th0, plan)
        again = linear_scan_with_plan(ta, tx, th0, plan)
        torch.cuda.synchronize()
        assert torch.equal(h, again[0]) and torch.equal(h_last, again[1])
        want_h, want_last = ref.linear_scan(ta, tx, th0)
        np.testing.assert_allclose(_np(h.cpu()), _np(want_h.cpu()), atol=tol, rtol=tol,
                                   err_msg=str((b, s, c)))
        np.testing.assert_allclose(_np(h_last.cpu()), _np(want_last.cpu()), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(8, 463, 4096), (1, 512, 4096), (2, 100, 33)])
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_linear_scan_kernel_repeats_bitwise_and_replays_from_a_graph(cuda, b, s, c, dname, jdt,
                                                                      tdt, tol):
    """Two calls give the same bits, and a call captured in a CUDA graph
    replays to the bits of the eager call: the kernel has no scratch,
    no flags and a fixed combine order."""
    a, x, h0 = _ls_inputs(np.random.default_rng(s + c), b, s, c)
    ta, tx, th0 = (torch.from_numpy(v).to(cuda, tdt) for v in (a, x, h0))
    eager = ops.linear_scan(ta, tx, th0)
    again = ops.linear_scan(ta, tx, th0)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(eager, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.linear_scan(ta, tx, th0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.linear_scan(ta, tx, th0)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(out, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(8, 4096), (1, 4096), (4, 4096), (2, 200), (1, 33),
                                 (8, 4100), (64, 4098)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_linear_scan_plan_fills_the_card(cuda, b, c, tdt):
    """The default plan is a built one with V dividing C, and puts a
    block on every SM where a 32-wide channel tile allows it."""
    from repro_torch.kernels.linear_scan import PLANS, scan_plan
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    v, w, l = plan = scan_plan(b, c, tdt)
    assert plan in PLANS and c % v == 0
    assert b * -(-c // (32 * v)) >= min(n_sm, b * -(-c // 32))


# the gradient kernel's cases: one step; the spans' edges of both plans;
# the train_hybrid phase's row (B = 1, S = 6144, C = 4096: 16 warps of 8
# steps); the serving shape's state row (8 x 4096: 8 warps of 4 steps);
# resets and an underflowing run; each with and without h0
LS_BWD_CARD_CASES = [(2, 1, 33, None), (2, 127, 200, "resets"), (2, 129, 4100, "resets"),
                     (8, 300, 4096, "resets"), (1, 6144, 4096, "resets")]


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("b,s,c,variant", LS_BWD_CARD_CASES)
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_linear_scan_backward_kernel_vs_autograd(cuda, b, s, c, variant, with_h0, dname, jdt,
                                                 tdt, tol):
    """``ops.linear_scan`` under autograd on the card (the reverse-time
    kernel, one launch a backward) against ``torch.autograd`` of the plain
    scan on the same inputs: da, dx and dh0 within ``tol`` of each
    gradient's largest entry (f32: summation order; bf16: the kernel
    reads the forward's bf16 h where autograd keeps f32); padded steps
    (a = 1, x = 0) carry the gradient through; two calls bitwise equal."""
    from repro_torch.kernels.linear_scan import linear_scan_bwd_cuda
    rng = np.random.default_rng(s + c + 1)
    a, x, h0 = _ls_inputs(rng, b, s, c)
    if variant == "resets" and s > 130:
        a = _resets_and_underflow(a)
    a[:, s - s // 7:] = 1.0          # padded tail: identity steps
    x[:, s - s // 7:] = 0.0
    g = rng.normal(size=(b, s, c)).astype(np.float32)
    g_last = rng.normal(size=(b, c)).astype(np.float32)
    ta, tx, tg, tgl = (torch.from_numpy(v).to(cuda, tdt) for v in (a, x, g, g_last))
    th0 = torch.from_numpy(h0).to(cuda) if with_h0 else None

    def grads(fn):
        ia, ix = ta.clone().requires_grad_(), tx.clone().requires_grad_()
        ih0 = None if th0 is None else th0.clone().requires_grad_()
        h, h_last = fn(ia, ix, ih0)
        torch.autograd.backward((h, h_last), (tg, tgl))
        return h.detach(), [ia.grad, ix.grad] + ([] if ih0 is None else [ih0.grad])

    before = dict(ops.LAUNCHES)
    h, got = grads(ops.linear_scan)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["linear_scan"] == before["linear_scan"] + 1
    assert ops.LAUNCHES["linear_scan_bwd"] == before["linear_scan_bwd"] + 1
    _, want = grads(ref.linear_scan)
    for name, gk, w in zip(("da", "dx", "dh0"), got, want):
        assert gk.dtype == w.dtype, name
        err = (gk.float() - w.float()).abs().max().item()
        assert err <= tol * max(1.0, w.float().abs().max().item()), f"{name}: {err}"
    again = linear_scan_bwd_cuda(ta, h, th0, tg, tgl)
    first = linear_scan_bwd_cuda(ta, h, th0, tg, tgl)
    torch.cuda.synchronize()
    for u, v in zip(first, again):
        assert (u is None and v is None) or torch.equal(u, v)

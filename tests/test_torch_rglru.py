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


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("b,s,c", LS_CASES + [(8, 512, 4096), (1, 7, 33)])
@pytest.mark.parametrize("dname,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_linear_scan_kernel_vs_plain(cuda, b, s, c, with_h0, dname, jdt, tdt, tol):
    a, x, h0 = _ls_inputs(np.random.default_rng(s + c), b, s, c)
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

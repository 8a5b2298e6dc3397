"""The PyTorch port's xLSTM blocks and the xLSTM LM against the live JAX
package.

Module by module (``models/xlstm.py``), the five mLSTM checks and the two
sLSTM checks of ``tests/test_xlstm_rglru.py`` on the reduced xlstm-1.3b
(d 256, 4 heads: the mLSTM's head_dim 128), each run through the port's
function and the reference's on the same numpy-seeded inputs and the
reference's init: the port equals the reference within 1e-5 (f32, another
summation order) and shows the check's own property at the reference
test's tolerance.  Then the reduced xlstm LM (pattern ``("mlstm",
"slstm")``) from ``params_from_jax`` of the reference's init: forward over
separate and packed rows (the packed row past ``MLSTM_CHUNK_THRESHOLD``,
so the chunkwise form with its segment boundaries), prefill, decode,
``prefill_chunk`` and the cache's state against the reference's, 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.models import xlstm as jx
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.models import xlstm as tx
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import MLSTM_CHUNK_THRESHOLD, STATE_KEYS

JCFG = jax_reduced(jax_config("xlstm-1.3b"))
CFG = reduced(get_model_config("xlstm-1.3b"))
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def cell(cls, jparams):
    """A port cell holding the reference cell's parameters."""
    mod = cls(CFG, device="cpu", dtype=torch.float32)
    flat = flat_params(jparams)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(flat[name.replace(".", "/")])))
    assert len(flat) == len(list(mod.parameters()))
    return mod


def x_of(seed, b, s, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, s, CFG.d_model)) * scale).astype(
        np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def state_close(got, want, names, tol=TOL):
    for n in names:
        g, w = np.asarray(got[n]), np.asarray(want[n])
        if n == "m":     # -1e30 where nothing was written: compare where finite
            assert ((g < -1e29) == (w < -1e29)).all(), n
            g, w = np.where(g < -1e29, 0, g), np.where(w < -1e29, 0, w)
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=n)


@pytest.fixture(scope="module")
def mlstm():
    jp = jx.mlstm_init(jax.random.key(0), JCFG)
    return jp, cell(tx.MLSTM, jp)


@pytest.fixture(scope="module")
def slstm():
    jp = jx.slstm_init(jax.random.key(1), JCFG)
    return jp, cell(tx.SLSTM, jp)


# ---------------------------------------------------------------------------
# mLSTM: the reference's five checks
# ---------------------------------------------------------------------------

def test_mlstm_chunked_equals_quadratic(mlstm):
    jp, p = mlstm
    x = x_of(0, 2, 100)
    o1 = tx.mlstm_forward(CFG, p, t(x))
    o2 = tx.mlstm_forward_chunked(CFG, p, t(x), chunk=32)
    close(o1, jx.mlstm_forward(JCFG, jp, jnp.asarray(x)))
    close(o2, jx.mlstm_forward_chunked(JCFG, jp, jnp.asarray(x), chunk=32))
    close(o2, o1, 1e-4)


def test_mlstm_stepwise_equals_quadratic(mlstm):
    jp, p = mlstm
    x = x_of(1, 1, 40)
    st = tx.mlstm_init_state(CFG, 1, dtype=torch.float32, device="cpu")
    jst = jx.mlstm_init_state(JCFG, 1)
    outs = []
    for i in range(40):
        o, st = tx.mlstm_decode_step(CFG, p, t(x[:, i]), st)
        jo, jst = jx.mlstm_decode_step(JCFG, jp, jnp.asarray(x[:, i]), jst)
        close(o, jo)
        outs.append(o)
    state_close(st, jst, ("C", "n", "m", "conv"))
    close(torch.stack(outs, 1), tx.mlstm_forward(CFG, p, t(x)), 1e-4)


def test_mlstm_prefill_state_continues_decode(mlstm):
    jp, p = mlstm
    x = x_of(2, 1, 30)
    k = 17
    _, st = tx.mlstm_forward_chunked(CFG, p, t(x[:, :k]), chunk=8, return_state=True)
    _, jst = jx.mlstm_forward_chunked(JCFG, jp, jnp.asarray(x[:, :k]), chunk=8,
                                      return_state=True)
    state_close(st, jst, ("C", "n", "m", "conv"))
    o_cont, _ = tx.mlstm_decode_step(CFG, p, t(x[:, k]), st)
    close(o_cont, tx.mlstm_forward(CFG, p, t(x[:, :k + 1]))[:, k], 1e-4)


def test_mlstm_segment_isolation(mlstm):
    jp, p = mlstm
    xa, xb = x_of(3, 1, 10), x_of(4, 1, 12)
    packed = np.concatenate([xa, xb], 1)
    seg = np.array([[0] * 10 + [1] * 12], np.int32)
    o = tx.mlstm_forward_chunked(CFG, p, t(packed), segment_ids=t(seg), chunk=8)
    close(o, jx.mlstm_forward_chunked(JCFG, jp, jnp.asarray(packed),
                                      segment_ids=jnp.asarray(seg), chunk=8))
    close(o[:, 10:], tx.mlstm_forward(CFG, p, t(xb)), 1e-3)
    # the parallel form over the packed row too
    close(tx.mlstm_forward(CFG, p, t(packed), segment_ids=t(seg)),
          jx.mlstm_forward(JCFG, jp, jnp.asarray(packed), segment_ids=jnp.asarray(seg)))


def test_mlstm_valid_masking(mlstm):
    jp, p = mlstm
    x = x_of(5, 1, 20)
    valid = np.array([[True] * 14 + [False] * 6])
    o, st_pad = tx.mlstm_prefill_state(CFG, p, t(x), valid=t(valid))
    jo, jst = jx.mlstm_prefill_state(JCFG, jp, jnp.asarray(x), valid=jnp.asarray(valid))
    close(o, jo)
    state_close(st_pad, jst, ("C", "n", "m", "conv"))
    _, st_exact = tx.mlstm_prefill_state(CFG, p, t(x[:, :14]))
    state_close(st_pad, st_exact, ("C", "n", "m", "conv"), 1e-4)


# ---------------------------------------------------------------------------
# sLSTM: the reference's two checks
# ---------------------------------------------------------------------------

def test_slstm_scan_equals_stepwise(slstm):
    jp, p = slstm
    x = x_of(6, 2, 25)
    o, state = tx.slstm_forward(CFG, p, t(x))
    jo, jstate = jx.slstm_forward(JCFG, jp, jnp.asarray(x))
    close(o, jo)
    state_close(state, jstate, ("h", "c", "n", "m"))
    st = tx.slstm_init_state(CFG, 2, device="cpu")
    for i in range(25):
        st = tx._slstm_cell(CFG, p, t(x[:, i]), st)
    close(state["h"], st["h"])


def test_slstm_segment_reset_and_padding(slstm):
    jp, p = slstm
    xa, xb = x_of(7, 1, 8), x_of(8, 1, 9)
    packed = np.concatenate([xa, xb], 1)
    seg = np.array([[0] * 8 + [1] * 9], np.int32)
    o, _ = tx.slstm_forward(CFG, p, t(packed), segment_ids=t(seg))
    jo, _ = jx.slstm_forward(JCFG, jp, jnp.asarray(packed), segment_ids=jnp.asarray(seg))
    close(o, jo)
    o_b, _ = tx.slstm_forward(CFG, p, t(xb))
    close(o[:, 8:], o_b, 1e-4)
    # padded steps hold the state; a state given is continued
    valid = np.array([[True] * 12 + [False] * 5])
    st0 = {k: torch.from_numpy(np.random.default_rng(9).normal(size=(1, CFG.d_model))
                               .astype(np.float32)) for k in ("h", "c", "n", "m")}
    _, st = tx.slstm_forward(CFG, p, t(packed), state=st0, valid=t(valid))
    _, jst = jx.slstm_forward(JCFG, jp, jnp.asarray(packed),
                              state={k: jnp.asarray(v.numpy()) for k, v in st0.items()},
                              valid=jnp.asarray(valid))
    state_close(st, jst, ("h", "c", "n", "m"))
    _, st12 = tx.slstm_forward(CFG, p, t(packed[:, :12]), state=st0)
    state_close(st, st12, ("h", "c", "n", "m"))
    close(tx.slstm_ffn(CFG, p, o), jx.slstm_ffn(JCFG, jp, jo))


# ---------------------------------------------------------------------------
# the reduced xlstm LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    jmodel = jax_build_model(JCFG, remat=False)
    params = jmodel.init(jax.random.key(3))
    return jmodel, params, params_from_jax(CFG, flat_params(params), device="cpu")


def tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def test_lm_forward_separate_and_packed_past_the_chunk_threshold(lm):
    """Separate rows (the parallel form) and a packed row of three
    segments and a padding tail, longer than ``MLSTM_CHUNK_THRESHOLD``
    (the chunkwise form, each segment's forget gate closed at its start;
    the sLSTM reset there): logits and hidden states against the
    reference's, and the packed segment against its row alone."""
    jmodel, params, model = lm
    toks = tokens(0, 2, 24)
    with torch.no_grad():
        logits, aux = model(t(toks))
    jl, _ = jmodel.forward(params, jnp.asarray(toks))
    close(logits, jl, 1e-4)
    assert float(aux["lb"]) == 0.0
    lens = [200, 180, 150]
    s = MLSTM_CHUNK_THRESHOLD + 40
    seg = np.full((1, s), -1, np.int32)
    pos = np.zeros((1, s), np.int32)
    packed = np.zeros((1, s), np.int32)
    o = 0
    for i, n in enumerate(lens):
        seg[0, o:o + n], pos[0, o:o + n] = i, np.arange(n)
        packed[0, o:o + n] = tokens(10 + i, 1, n)
        o += n
    with torch.no_grad():
        h, _ = model.hidden_states(t(packed), positions=t(pos), segment_ids=t(seg))
        h1, _ = model.hidden_states(t(packed[:, 200:380]))
    jh, _ = jmodel.hidden_states(params, jnp.asarray(packed), positions=jnp.asarray(pos),
                                 segment_ids=jnp.asarray(seg))
    close(h, jh, 1e-4)
    close(h[:, 200:380], h1, 2e-3)


def test_lm_prefill_decode_and_chunk_match_the_reference(lm):
    """prefill of right-padded prompts, four decode steps (one with a row
    inactive), then ``prefill_chunk`` of a span for two slots: logits and
    every state of the cache against the reference's."""
    jmodel, params, model = lm
    b, s = 3, 9
    toks = tokens(1, b, s)
    length = np.array([9, 5, 7], np.int32)
    cache = model.init_cache(b, 32)
    jcache = jmodel.init_cache(b, 32)
    lg, cache = model.prefill(t(toks), cache, length=t(length))
    jlg, jcache = jmodel.prefill(params, jnp.asarray(toks), jcache, length=jnp.asarray(length))
    close(lg, jlg, 1e-4)

    def states_match():
        for j, bt in enumerate(model.pattern):
            for name, key in STATE_KEYS[bt].items():
                want = np.asarray(jcache["units"][j][name])[0]
                got = cache[key][0].numpy()
                if name == "m":
                    assert ((got < -1e29) == (want < -1e29)).all()
                    got, want = np.maximum(got, -1e29), np.maximum(want, -1e29)
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=key)
        np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))
    states_match()
    for i in range(4):
        tok = tokens(20 + i, 1, b)[0]
        active = None if i != 2 else np.array([True, False, True])
        lg, cache = model.decode_step(t(tok), cache,
                                      active=None if active is None else t(active))
        jlg, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache,
                                         active=None if active is None else jnp.asarray(active))
        close(lg, jlg, 1e-4)
    states_match()
    span = tokens(30, 2, 6)
    slots = np.array([2, 0], np.int32)
    start = np.asarray(jcache["t"])[slots]
    n = np.array([6, 4], np.int32)
    lg, cache = model.prefill_chunk(t(span), cache, t(slots), t(start), t(n))
    jlg, jcache = jmodel.prefill_chunk(params, jnp.asarray(span), jcache, jnp.asarray(slots),
                                       jnp.asarray(start), jnp.asarray(n))
    close(lg, jlg, 1e-4)
    states_match()


def test_lm_reset_slot_rows_restores_the_initial_state(lm):
    """``reset_slot_rows`` puts a slot's xLSTM state back to the fresh
    state: m at -inf (not 0), everything else 0."""
    _, _, model = lm
    cache = model.init_cache(2, 16)
    fresh = {k: v.clone() for k, v in cache.items()}
    model.prefill(t(tokens(2, 2, 6)), cache)
    model.reset_slot_rows(cache, torch.tensor([1]))
    for k, v in cache.items():
        if k != "t":
            assert torch.equal(v[:, 1], fresh[k][:, 1]), k
            assert not torch.equal(v[:, 0], fresh[k][:, 0]), k
    assert cache["mlstm_m"][:, 1].max().item() == torch.tensor(tx.NEG_INF).item()


def test_lm_init_draws_reference_shapes(lm):
    """``init`` fills every parameter: the forget biases at 3, the
    recurrent weights at 0.5/sqrt(d), and the model runs."""
    _, _, ref_model = lm
    from repro_torch.models.model import build_model
    model = build_model(CFG, device="cpu").init(torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(model.named_parameters(), ref_model.named_parameters()):
        assert p.shape == q.shape, name
    assert all(torch.all(blk.cell.f_bias == 3) for blk in model.blocks)
    r = model.blocks[1].cell.r_i
    assert abs(r.std().item() * CFG.d_model ** 0.5 / 0.5 - 1.0) < 0.05
    with torch.no_grad():
        logits, _ = model(t(tokens(3, 1, 5)))
    assert torch.isfinite(logits).all()

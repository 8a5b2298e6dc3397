"""The PyTorch port's enc-dec model (whisper-medium, reduced) against the
live JAX package.

The reduced whisper (2 encoder and 2 decoder layers, d 256, 4 heads at
head_dim 64, LayerNorm, GeLU, sinusoidal positions) from
``params_from_jax`` of the reference's init, f32, frames made with numpy:

  * ``encode`` and ``forward`` within 1e-5;
  * ``prefill`` then ``decode_step`` against ``forward`` (the reference's
    ``test_decode_matches_forward``, 5e-4) and against the reference's own
    prefill and decode (1e-4), with 8 frames (the reduced config's
    ``n_prefix_tokens``, while ``init_cache`` sizes the cross cache by its
    ``encoder_seq_len`` of 16: the port's cross cache must become 8 wide,
    as the reference's returned one is) and with 16;
  * ``cache_insert`` of a sub-batch prefill into a full cache;
  * gradients of the reference test's loss ``mean(logits^2)`` against
    ``jax.grad``, 1e-4 of each tensor's largest entry;
  * ``ops.flash_attention`` with Sq != Sk (cross attention) against the
    reference's route, forward and gradient, below and above the 2^20
    scores where both switch to the query-chunked oracle;
  * ``layers.sinusoidal_positions`` rows against the reference's table.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.model import build_model

JCFG = jax_reduced(jax_config("whisper-medium"))
CFG = reduced(get_model_config("whisper-medium"))


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


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(JCFG, remat=False)
    params = jmodel.init(jax.random.key(0))
    return jmodel, params, params_from_jax(CFG, flat_params(params), device="cpu")


def inputs(seed, b=2, s=12, frames=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
    f = frames or CFG.n_prefix_tokens
    fr = (rng.normal(size=(b, f, CFG.prefix_dim)) * 0.1).astype(np.float32)
    return toks, fr


def test_reduced_config_has_the_cross_width_trap():
    assert CFG.is_encdec and CFG.n_prefix_tokens == 8 and CFG.encoder_seq_len == 16
    assert isinstance(build_model(CFG, device="cpu"), EncDecLM)


def test_encode_and_forward_match(pair):
    jmodel, params, model = pair
    toks, fr = inputs(0)
    with torch.no_grad():
        enc = model.encode(t(fr))
        logits, aux = model(t(toks), prefix_embeds=t(fr))
    close(enc, jmodel.encode(params, jnp.asarray(fr)), 1e-5)
    jl, _ = jmodel.forward(params, jnp.asarray(toks), prefix_embeds=jnp.asarray(fr))
    assert logits.shape == (2, 12, CFG.padded_vocab)
    close(logits, jl, 1e-5)
    assert all(float(v) == 0.0 for v in aux.values())


@pytest.mark.parametrize("frames", [8, 16], ids=["8-frames-16-wide", "16-frames"])
def test_prefill_then_decode_matches_forward_and_the_reference(pair, frames):
    jmodel, params, model = pair
    toks, fr = inputs(1, frames=frames)
    with torch.no_grad():
        full, _ = model(t(toks), prefix_embeds=t(fr))
    pre = 5
    cache = model.init_cache(2, 64)
    jcache = jmodel.init_cache(2, 64)
    assert cache["cross"]["k"].shape == tuple(jcache["cross"]["k"].shape)
    lg, cache = model.prefill(t(toks[:, :pre]), cache, prefix_embeds=t(fr))
    jlg, jcache = jmodel.prefill(params, jnp.asarray(toks[:, :pre]), jcache,
                                 prefix_embeds=jnp.asarray(fr))
    assert cache["cross"]["k"].shape[2] == jcache["cross"]["k"].shape[2] == frames
    close(lg, jlg, 1e-4)
    for part in ("self", "cross"):
        for name, x in jcache[part].items():
            close(cache[part][name], x, 1e-4)
    errs = [(lg - full[:, pre - 1]).abs().max().item()]
    for i in range(pre, 12):
        lg, cache = model.decode_step(t(toks[:, i]), cache)
        jlg, jcache = jmodel.decode_step(params, jnp.asarray(toks[:, i]), jcache)
        close(lg, jlg, 1e-4)
        errs.append((lg - full[:, i]).abs().max().item())
    assert max(errs) < 5e-4
    np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))
    # an inactive row keeps its ring entry and position
    before = {k: v.clone() for k, v in cache["self"].items()}
    active = torch.tensor([True, False])
    lg, cache = model.decode_step(t(toks[:, 0]), cache, active=active)
    jlg, jcache = jmodel.decode_step(params, jnp.asarray(toks[:, 0]), jcache,
                                     active=jnp.asarray(active.numpy()))
    close(lg, jlg, 1e-4)
    assert all(torch.equal(cache["self"][k][:, 1], before[k][:, 1]) for k in before)
    assert cache["t"].tolist() == np.asarray(jcache["t"]).tolist() == [13, 12]


def test_right_padded_prefill_matches_the_reference(pair):
    jmodel, params, model = pair
    toks, fr = inputs(2, s=7)
    length = np.array([7, 4], np.int32)
    cache = model.init_cache(2, 16)
    jcache = jmodel.init_cache(2, 16)
    lg, cache = model.prefill(t(toks), cache, prefix_embeds=t(fr), length=t(length))
    jlg, jcache = jmodel.prefill(params, jnp.asarray(toks), jcache,
                                 prefix_embeds=jnp.asarray(fr), length=jnp.asarray(length))
    close(lg, jlg, 1e-4)
    np.testing.assert_array_equal(cache["self"]["pos"].numpy(), np.asarray(jcache["self"]["pos"]))
    tok = toks[:, 0]
    lg, _ = model.decode_step(t(tok), cache)
    jlg, _ = jmodel.decode_step(params, jnp.asarray(tok), jcache)
    close(lg, jlg, 1e-4)


def test_cache_insert_matches_the_reference(pair):
    jmodel, params, model = pair
    toks, fr = inputs(3, b=2, s=6)
    sub = model.init_cache(2, 16)
    jsub = jmodel.init_cache(2, 16)
    _, sub = model.prefill(t(toks), sub, prefix_embeds=t(fr))
    _, jsub = jmodel.prefill(params, jnp.asarray(toks), jsub, prefix_embeds=jnp.asarray(fr))
    full = model.init_cache(4, 16)
    jfull = jmodel.init_cache(4, 16)
    with pytest.raises(ValueError, match="frames"):      # 16-wide full, 8-wide sub
        model.cache_insert(full, sub, torch.tensor([3, 1]))
    toks4, fr4 = inputs(4, b=4, s=6)
    _, full = model.prefill(t(toks4), full, prefix_embeds=t(fr4))
    _, jfull = jmodel.prefill(params, jnp.asarray(toks4), jfull, prefix_embeds=jnp.asarray(fr4))
    slots = np.array([3, 1], np.int32)
    full = model.cache_insert(full, sub, t(slots))
    jfull = jmodel.cache_insert(jfull, jsub, jnp.asarray(slots))
    for part in ("self", "cross"):
        for name, x in jfull[part].items():
            close(full[part][name], x, 1e-4)
    np.testing.assert_array_equal(full["t"].numpy(), np.asarray(jfull["t"]))
    tok = np.array([3, 5, 7, 9], np.int32)
    lg, _ = model.decode_step(t(tok), full)
    jlg, _ = jmodel.decode_step(params, jnp.asarray(tok), jfull)
    close(lg, jlg, 1e-4)


def test_gradients_match_jax_grad(pair):
    """The gradient of ``mean(logits^2)`` (the reference's smoke test's
    loss) through the encoder's non-causal attention, the cross attention
    and the decoder, against ``jax.grad``."""
    jmodel, params, model = pair
    toks, fr = inputs(5)

    def loss_fn(p):
        lg, _ = jmodel.forward(p, jnp.asarray(toks), prefix_embeds=jnp.asarray(fr))
        return jnp.mean(lg.astype(jnp.float32) ** 2)
    jgrads = params_from_jax(CFG, flat_params(jax.grad(loss_fn)(params)), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    try:
        logits, _ = model(t(toks), prefix_embeds=t(fr))
        (logits.float() ** 2).mean().backward()
        want = dict(jgrads.named_parameters())
        for name, p in model.named_parameters():
            w = want[name].detach()
            scale = w.abs().max().item()
            assert scale > 0, name
            np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
            p.grad = None


@pytest.mark.parametrize("sq,sk,causal", [(12, 8, False), (7, 30, True), (1100, 1000, False)],
                         ids=["dec-over-frames", "causal-rect", "chunked"])
def test_flash_attention_cross_matches_the_reference_route(sq, sk, causal):
    """Sq != Sk goes to the plain route on every device, as the
    reference's; above 2^20 scores both take the query-chunked oracle."""
    rng = np.random.default_rng(sq)
    h, hkv, hd = (4, 2, 16) if sq < 1000 else (1, 1, 8)
    q = rng.normal(size=(2, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(2, sk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(2, sk, hkv, hd)).astype(np.float32)
    g = rng.normal(size=(2, sq, h, hd)).astype(np.float32)
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, None, causal=causal)
    (out * t(g)).sum().backward()
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                causal=causal)
    close(out.detach(), want, 1e-5)
    jg = jax.grad(lambda a, b, c: jnp.sum(
        jops.flash_attention(a, b, c, None, causal=causal) * jnp.asarray(g)), (0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, w in zip((tq.grad, tk.grad, tv.grad), jg):
        close(got, w, 1e-4)
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.parametrize("dim", [64, 256, 1024])
def test_sinusoidal_positions_rows_match_the_reference_table(dim):
    table = np.asarray(jlayers.sinusoidal_positions(2048, dim))
    pos = np.array([[0, 1, 7, 255], [511, 1024, 1499, 2047]], np.int32)
    got = layers.sinusoidal_positions(t(pos), dim)
    assert got.shape == (2, 4, dim) and got.dtype == torch.float32
    # exp rounds inv within an ulp on each side, not identically: an
    # angle p * inv may differ by up to p * 2 ulp(1) (2.4e-7 p)
    bound = 2e-6 + 2.4e-7 * pos[..., None]
    assert (np.abs(got.numpy() - table[pos]) <= bound).all()
    np.testing.assert_array_equal(got[0, 0].numpy(), table[0])          # sin 0, cos 0


def test_full_width_encdec_builds_on_meta():
    cfg = get_model_config("whisper-medium")
    model = build_model(cfg, device="meta")
    assert len(model.encoder) == len(model.decoder) == 24
    assert model.decoder[0].cross.wq.shape == (1024, 1024)
    small = dataclasses.replace(CFG, tie_embeddings=True)
    assert build_model(small, device="meta").head is None

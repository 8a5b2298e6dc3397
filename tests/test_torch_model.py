"""The PyTorch port's dense LM against the JAX ``LM`` on the same weights.

The reference initialises the parameters; ``params_from_jax`` loads them
into the port.  Prefill logits, the ring cache contents (k, v, pos, t)
and four decode steps' logits are compared in f32 with atol = rtol =
1e-4: the two frameworks run the same operations in a different
summation order, so results agree to float32 rounding, not bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, get_model_config, reduced
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread each, so this file does not
    crowd the processes that other test files run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_params(params):
    """'/'-joined paths to numpy arrays: the reference's key scheme."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def configs(**extra):
    """The same reduced areal-qwen-1.5b config in both packages."""
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE, **extra)
    return (dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")), **kw),
            dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), **kw))


def pair(seed=0, **extra):
    jcfg, tcfg = configs(**extra)
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(seed))
    return jmodel, params, params_from_jax(tcfg, flat_params(params), device="cpu")


def test_params_from_jax_consumes_every_leaf_once():
    jcfg, tcfg = configs()
    params = jax_build_model(jcfg, remat=False).init(jax.random.key(0))
    flat = flat_params(params)
    model = params_from_jax(tcfg, flat, device="cpu")
    # every stacked unit leaf is split into n_layers port parameters
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == sum(a.size for a in flat.values())
    names = dict(model.named_parameters())
    np.testing.assert_array_equal(names["blocks.1.attn.wq"].numpy(),
                                  flat["units/0/attn/wq"][1])
    np.testing.assert_array_equal(names["embed.table"].numpy(), flat["embed/table"])
    with pytest.raises(KeyError, match="not consumed"):
        params_from_jax(tcfg, {**flat, "units/0/attn/extra": flat["units/0/attn/wq"]},
                        device="cpu")
    missing = dict(flat)
    del missing["units/0/mlp/w_gate"]
    with pytest.raises(KeyError, match="w_gate"):
        params_from_jax(tcfg, missing, device="cpu")


@pytest.mark.parametrize("extra", [{}, {"sliding_window": 4}], ids=["attn", "swa"])
def test_prefill_and_decode_match_reference(extra):
    jmodel, params, model = pair(**extra)
    rng = np.random.default_rng(0)
    b, s, max_len = 3, 12, 20
    toks = rng.integers(3, tokenizer.VOCAB_SIZE, size=(b, s)).astype(np.int32)
    length = np.array([12, 7, 1], np.int32)

    jlogits, jcache = jmodel.prefill(params, jnp.asarray(toks),
                                     jmodel.init_cache(b, max_len), length=jnp.asarray(length))
    cache = model.init_cache(b, max_len)
    logits, cache = model.prefill(torch.from_numpy(toks), cache,
                                  length=torch.from_numpy(length))
    assert logits.dtype == torch.float32 and logits.shape == (b, model.cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)

    def check_cache():
        ju = jcache["units"][0]              # stacked (n_layers, B, W, ...)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ju["pos"]))
        np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(ju[name]),
                                       atol=TOL, rtol=TOL)

    check_cache()
    active = np.array([True, False, True])
    for _ in range(4):
        tok = rng.integers(3, tokenizer.VOCAB_SIZE, size=(b,)).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache,
                                             jnp.asarray(active))
        logits, cache = model.decode_step(torch.from_numpy(tok), cache,
                                          torch.from_numpy(active))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
        check_cache()


@pytest.mark.parametrize("norm_type,parametric,act", [
    ("rmsnorm", True, "swiglu"), ("layernorm", True, "geglu"),
    ("layernorm", False, "gelu"), ("rmsnorm", True, "relu2"),
])
def test_layers_match_reference(norm_type, parametric, act):
    """Norms, the MLP activations, RoPE (split halves, f32 angles) and
    the f32 logits head, one by one, against ``repro/models/layers.py``."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    jcfg, tcfg = configs(norm_type=norm_type, parametric_norm=parametric, act=act)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    scale = (1 + 0.1 * rng.normal(size=jcfg.d_model)).astype(np.float32)
    bias = (0.1 * rng.normal(size=jcfg.d_model)).astype(np.float32)
    jp = {}
    if parametric:
        jp = {"scale": jnp.asarray(scale)}
        if norm_type == "layernorm":
            jp["bias"] = jnp.asarray(bias)
    got = tl.norm_apply(tcfg, torch.from_numpy(scale) if parametric else None,
                        torch.from_numpy(bias) if "bias" in jp else None, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.norm_apply(jcfg, jp, jnp.asarray(x))),
                               atol=TOL, rtol=TOL)

    ff = jcfg.d_ff
    w = {n: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
         for n, shape in (("w_up", (jcfg.d_model, ff)), ("w_gate", (jcfg.d_model, ff)),
                          ("w_down", (ff, jcfg.d_model)))}
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    if act not in ("swiglu", "geglu"):
        del jw["w_gate"]
    got = tl.mlp_apply(act, torch.from_numpy(w["w_up"]),
                       torch.from_numpy(w["w_gate"]) if "w_gate" in jw else None,
                       torch.from_numpy(w["w_down"]), tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.mlp_apply(jcfg, jw, jnp.asarray(x))),
                               atol=TOL, rtol=TOL)

    heads = x.reshape(2, 5, 4, jcfg.d_model // 4)
    pos = np.array([[0, 1, 2, 7, 300], [5, 6, 7, 8, 9]], np.int32)
    got = tl.apply_rope(torch.from_numpy(heads), torch.from_numpy(pos), jcfg.rope_theta)
    want = jl.apply_rope(jnp.asarray(heads), jnp.asarray(pos), jcfg.rope_theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    table = rng.normal(size=(jcfg.padded_vocab, jcfg.d_model)).astype(np.float32) * 0.02
    got = tl.unembed_apply(torch.from_numpy(table), None, tx, tie=True)
    want = jl.unembed_apply({"table": jnp.asarray(table)}, None, jnp.asarray(x), True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_init_draws_reference_shapes_and_scales():
    _, tcfg = configs()
    from repro_torch.models.model import build_model
    model = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    wq = model.blocks[0].attn.wq
    assert wq.shape == (tcfg.d_model, tcfg.q_dim)
    assert abs(wq.std().item() * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(model.embed.table.std().item() / 0.02 - 1.0) < 0.05
    assert torch.all(model.blocks[0].attn_norm.scale == 1)
    again = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_with_the_reference_parameter_count(arch):
    """Every config of ``configs/`` builds at full size (on the meta
    device: no memory), with as many parameters as the reference's init
    (counted by ``jax.eval_shape``: 3.65 B for xlstm-1.3b, whose q/k/v are
    dense where ``ModelConfig.param_count`` counts them block-diagonal,
    0.813 B for whisper-medium); the enc-dec family builds an
    ``EncDecLM``, a VLM has its projector, an MoE its experts."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.model import build_model
    cfg = get_model_config(arch)
    model = build_model(cfg, device="meta")
    shapes = jax.eval_shape(jax_build_model(jax_config(arch), remat=False).init,
                            jax.random.key(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want
    assert isinstance(model, EncDecLM) == cfg.is_encdec
    if not cfg.is_encdec:
        assert (model.projector is not None) == bool(cfg.n_prefix_tokens and cfg.prefix_dim)
        assert all(hasattr(blk, "moe") == cfg.is_moe for blk in model.blocks
                   if blk.__class__.__name__ == "Block")
    if arch == "xlstm-1.3b":
        assert round(want / 1e9, 2) == 3.65 and want != cfg.param_count()
    if arch == "whisper-medium":
        assert round(want / 1e9, 3) == 0.813
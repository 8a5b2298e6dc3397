"""The PyTorch port's RG-LRU hybrid LM against the JAX ``LM`` on the same
weights.

RecurrentGemma's pattern ``("rec", "rec", "local")`` at 5 layers (one
unit of three and a remainder of two), MQA (one kv head) and a local
window of 4, shorter than the prompt.  The reference initialises the
parameters; ``params_from_jax`` loads them into the port.  Prefill
logits, the ring cache (k, v, pos of the local layers, h and conv of the
recurrent ones, t) and four decode steps with a row held inactive are
compared in f32 at atol = rtol = 1e-4: the same operations in another
summation order.
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
from repro_torch.configs import get_model_config, reduced
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

TOL = 1e-4
HYBRID = dict(vocab_size=tokenizer.VOCAB_SIZE, n_layers=5, block_pattern=("rec", "rec", "local"),
              n_heads=4, n_kv_heads=1, head_dim=16, d_model=64, d_ff=96, lru_width=48,
              local_window=4)


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
    """The same reduced recurrentgemma-9b config in both packages."""
    kw = dict(HYBRID, **extra)
    return (dataclasses.replace(jax_reduced(jax_config("recurrentgemma-9b")), **kw),
            dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")), **kw))


def pair(seed=0):
    jcfg, tcfg = configs()
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(seed))
    return jmodel, params, params_from_jax(tcfg, flat_params(params), device="cpu")


def test_params_from_jax_consumes_every_hybrid_leaf():
    jcfg, tcfg = configs()
    params = jax_build_model(jcfg, remat=False).init(jax.random.key(0))
    flat = flat_params(params)
    model = params_from_jax(tcfg, flat, device="cpu", dtype=torch.bfloat16)
    assert model.kinds == ("rec", "rec", "local", "rec", "rec")
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for a in flat.values())
    names = dict(model.named_parameters())
    # lam stays f32 in a bf16 model; everything else is bf16
    assert names["blocks.0.rec.lam"].dtype == torch.float32
    assert names["blocks.0.rec.w_a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(names["blocks.1.rec.lam"].numpy(), flat["units/1/rec/lam"][0])
    for name, path in (("blocks.4.rec.conv.w", "rem/1/rec/conv/w"), ("head.w", "head/w")):
        assert torch.equal(names[name], torch.tensor(flat[path]).to(torch.bfloat16))
    with pytest.raises(KeyError, match="not consumed"):
        params_from_jax(tcfg, {**flat, "rem/0/rec/extra": flat["rem/0/rec/lam"]}, device="cpu")
    missing = dict(flat)
    del missing["units/0/rec/w_i"]
    with pytest.raises(KeyError, match="w_i"):
        params_from_jax(tcfg, missing, device="cpu")
    # init's recast keeps lam f32 too
    m = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0),
                                             dtype=torch.bfloat16)
    assert m.blocks[0].rec.lam.dtype == torch.float32 and m.dtype == torch.bfloat16


def _jax_layer_cache(jmodel, jcache, i):
    p = len(jmodel.pattern)
    if i < jmodel.n_units * p:
        return {k: v[i // p] for k, v in jcache["units"][i % p].items()}
    return jcache["rem"][i - jmodel.n_units * p]


def test_hybrid_prefill_and_decode_match_reference():
    jmodel, params, model = pair()
    rng = np.random.default_rng(0)
    b, s, max_len = 3, 12, 20
    toks = rng.integers(3, tokenizer.VOCAB_SIZE, size=(b, s)).astype(np.int32)
    length = np.array([12, 7, 1], np.int32)

    jlogits, jcache = jmodel.prefill(params, jnp.asarray(toks),
                                     jmodel.init_cache(b, max_len), length=jnp.asarray(length))
    cache = model.init_cache(b, max_len)
    assert set(cache) == {"k", "v", "pos", "h", "conv", "t"}
    assert cache["h"].shape == (4, b, 48) and cache["h"].dtype == torch.float32
    assert cache["k"].shape == (1, b, 4, 1, 16)          # width min(window, max_len)
    logits, cache = model.prefill(torch.from_numpy(toks), cache,
                                  length=torch.from_numpy(length))
    assert logits.dtype == torch.float32 and logits.shape == (b, model.cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)

    def check_cache():
        np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))
        for i, kind in enumerate(model.kinds):
            want = _jax_layer_cache(jmodel, jcache, i)
            got = model._layer(cache, i)
            assert set(got) == set(want), i
            for name in got:
                if name == "pos":
                    np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
                else:
                    np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                               atol=TOL, rtol=TOL, err_msg=f"{i} {name}")

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


def test_cache_insert_moves_every_kind_of_state():
    _, _, model = pair()
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(3, tokenizer.VOCAB_SIZE, size=(2, 6)))
    sub = model.init_cache(2, 10)
    model.prefill(toks, sub, length=torch.tensor([6, 3], dtype=torch.int32))
    full = model.init_cache(4, 10)
    model.cache_insert(full, sub, torch.tensor([3, 1]))
    for name in ("k", "v", "pos", "h", "conv"):
        assert torch.equal(full[name][:, [3, 1]], sub[name]), name
        assert not full[name][:, [0, 2]].any() if name != "pos" else \
            bool((full[name][:, [0, 2]] == -1).all())
    assert full["t"].tolist() == [0, 3, 0, 6]


def test_paged_methods_raise_on_recurrent_blocks():
    """The paged methods take recurrent blocks now: the paged cache
    holds a pool slice per attention layer and slot-major state per
    recurrent layer, and a decode step through it gives the ring cache's
    logits and state (``tests/test_torch_hybrid_paged.py`` holds the
    paged methods against the reference)."""
    _, _, model = pair()
    cache = model.init_paged_cache(2, 8, 4)
    assert cache["k_pool"].shape[:2] == (model.n_attn, 8)
    assert cache["h"].shape[:2] == cache["conv"].shape[:2] == (model.n_rec, 2)
    ring = model.init_cache(2, 16)
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    tok = torch.tensor([3, 7])
    for _ in range(3):
        got, _ = model.decode_step_paged(tok, cache, tables)
        want, _ = model.decode_step(tok, ring)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for name in ("h", "conv", "t"):
        torch.testing.assert_close(cache[name], ring[name], atol=1e-5, rtol=0)


def test_build_model_defaults_to_cuda_for_the_hybrid():
    cfg = get_model_config("recurrentgemma-9b")
    assert build_model(configs()[1], device="cpu").kinds[-1] == "rec"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is exercised on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)

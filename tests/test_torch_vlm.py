"""The VLM prefix of internvl2-2b in the PyTorch port, against the live
JAX package.

The reduced internvl2-2b (8 prefix embeddings of width 64, GQA) from
``params_from_jax`` of the reference's init; the prefix embeddings are
normal · 0.1 from a numpy seed, as ``tests/test_models.py`` makes them.
``hidden_states`` / ``forward`` with the prefix, plain and over packed
segments (the prefix takes the segment of each row's first token), and
``prefill(prefix_embeds=)`` over right-padded rows followed by decode
steps, each against the reference at 1e-5; decode against the full
forward at 5e-4, as ``tests/test_models.py::test_decode_matches_forward``.
Then ``run_training("internvl2-2b")`` at laptop scale for 2 steps against
the reference's run (its engine and trainer take no prefix): StepLog by
StepLog, integer fields equal, the loss within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.launch.train import run_training as jax_run_training
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.data import tokenizer
from repro_torch.launch.train import run_training
from repro_torch.models.convert import params_from_jax

TOL = 1e-5
INT_FIELDS = ("version", "n_tokens", "gen_tokens_total", "interruptions", "staleness_max")


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


def configs():
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE)
    return (dataclasses.replace(jax_reduced(jax_config("internvl2-2b")), **kw),
            dataclasses.replace(reduced(get_model_config("internvl2-2b")), **kw))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs()
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(4))
    flat = flat_params(params)
    return jmodel, params, tcfg, flat, params_from_jax(tcfg, flat, device="cpu")


def prefix(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.n_prefix_tokens, cfg.prefix_dim)) * 0.1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def test_params_from_jax_consumes_the_projector(pair):
    _, _, tcfg, flat, model = pair
    assert model.projector.w.shape == (tcfg.prefix_dim, tcfg.d_model)
    np.testing.assert_array_equal(model.projector.w.numpy(), flat["projector/w"])
    missing = {k: v for k, v in flat.items() if k != "projector/w"}
    with pytest.raises(KeyError, match="projector"):
        params_from_jax(tcfg, missing, device="cpu")


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_forward_with_prefix_matches_reference(pair, packed):
    jmodel, params, tcfg, _, model = pair
    rng = np.random.default_rng(1)
    b, s = 2, 12
    toks = rng.integers(3, tokenizer.VOCAB_SIZE, size=(b, s)).astype(np.int32)
    pre = prefix(tcfg, b)
    kw = {}
    if packed:
        kw = dict(segment_ids=np.array([[2] * 5 + [3] * 7, [0] * 12], np.int32),
                  positions=np.array([list(range(5)) + list(range(7)), list(range(12))],
                                     np.int32))
    jl, _ = jmodel.forward(params, jnp.asarray(toks), prefix_embeds=jnp.asarray(pre),
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, aux = model.forward(t(toks), prefix_embeds=t(pre), **{k: t(v) for k, v in kw.items()})
    assert tl.shape == (b, tcfg.n_prefix_tokens + s, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert all(aux[k].item() == 0 for k in aux)
    jh, _ = jmodel.hidden_states(params, jnp.asarray(toks), prefix_embeds=jnp.asarray(pre),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    th, _ = model.hidden_states(t(toks), prefix_embeds=t(pre), **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=TOL, rtol=TOL)


def test_prefill_with_prefix_then_decode(pair):
    """Right-padded rows behind the prefix, then decode steps: logits and
    the ring cache against the reference at 1e-5, and against the full
    forward over prefix + tokens at 5e-4."""
    jmodel, params, tcfg, _, model = pair
    rng = np.random.default_rng(2)
    b, s, n_dec = 2, 10, 4
    p = tcfg.n_prefix_tokens
    full = rng.integers(3, tokenizer.VOCAB_SIZE, size=(b, s + n_dec)).astype(np.int32)
    length = np.array([6, 10], np.int32)
    toks = full[:, :s].copy()
    toks[0, 6:] = 0                                        # row 0: 6 tokens, then padding
    pre = prefix(tcfg, b, seed=3)
    jcache = jmodel.init_cache(b, 64)
    cache = model.init_cache(b, 64)
    jl, jcache = jmodel.prefill(params, jnp.asarray(toks), jcache, length=jnp.asarray(length),
                                prefix_embeds=jnp.asarray(pre))
    tl, cache = model.prefill(t(toks), cache, length=t(length), prefix_embeds=t(pre))
    np.testing.assert_array_equal(cache["t"].numpy(), length + p)

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        ju = jcache["units"][0]
        for name in ("k", "v", "pos"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(ju[name]), atol=TOL,
                                       rtol=TOL)
        np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))
    check(jl, tl)
    # each row continues from its own length: row 0's tokens 6.. follow
    seqs = [list(full[0, :6]) + list(full[0, s:]), list(full[1])]
    steps = [tl]
    for i in range(n_dec):
        tok = np.array([seqs[0][6 + i], seqs[1][s + i]], np.int32)
        jl, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache)
        tl, cache = model.decode_step(t(tok), cache)
        check(jl, tl)
        steps.append(tl)
    for r, n in enumerate(length):
        seq = np.array([seqs[r][:n + n_dec]], np.int32)
        fl, _ = model.forward(t(seq), prefix_embeds=t(pre[r:r + 1]))
        want = fl[0, p + n - 1:p + n + n_dec].detach().numpy()
        got = np.stack([x[r].numpy() for x in steps])
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def gumbel_of(seed):
    key = jax.random.key(seed)

    def noise(*args):
        *ids, shape = args
        k = key
        for i in ids:
            k = jax.random.fold_in(k, i)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    return noise


def test_run_training_vlm_matches_reference():
    loop = dict(steps=2, batch_size=8, answers_per_prompt=4, n_slots=8, seed=1,
                log_every=1 << 30, final_eval=False)
    ref_ctl, _, _ = jax_run_training("internvl2-2b", **loop)
    jcfg, tcfg = configs()
    jcfg = dataclasses.replace(jcfg, name=jcfg.name + "-math")
    tcfg = dataclasses.replace(tcfg, name=tcfg.name + "-math")
    params = jax_build_model(jcfg, remat=False).init(jax.random.key(loop["seed"]))
    model = params_from_jax(tcfg, flat_params(params), device="cpu")
    ctl, trainer, _ = run_training("internvl2-2b", device="cpu", model=model,
                                   noise=gumbel_of(loop["seed"]), **loop)
    assert trainer.version == loop["steps"] and ctl.engine.model.projector is not None
    got = [tuple(getattr(h, f) for f in INT_FIELDS) for h in ctl.history]
    want = [tuple(getattr(h, f) for f in INT_FIELDS) for h in ref_ctl.history]
    assert got == want and len(got) == loop["steps"]
    np.testing.assert_allclose([h.loss for h in ctl.history],
                               [h.loss for h in ref_ctl.history], rtol=0, atol=1e-5)
    for g, w in zip(ctl.history, ref_ctl.history, strict=True):
        assert g.clock == pytest.approx(w.clock, rel=1e-9, abs=0)

"""The RG-LRU hybrid on the paged cache and in chunked prefill, in the
PyTorch port, against the JAX reference.

The model is ``tests/test_rollout.py``'s hybrid: pattern ``("rec",
"local")``, local window 4, 2 layers (3 for the LM methods, so that a
remainder layer follows the stacked unit).  The reference initialises
the weights and ``params_from_jax`` loads them.

  * ``conv_history_update``, ``causal_conv1d_apply(history=)`` and
    ``rglru_prefill_state(state=)`` against the reference's functions, on
    spans of different real lengths continued from a nonzero state.
  * ``LM.prefill_chunk``, ``prefill_paged``, ``prefill_chunk_paged`` and
    ``decode_step_paged`` on the hybrid against the reference's LM:
    logits and every cache leaf after a prompt ingested in spans of 3
    through the ring and the pool, then decode steps with one row held
    back.
  * the engine, ring chunked, paged monolithic and paged chunked (blocks
    of 4, chunk 3), the two paged ones also with the fused decode tail,
    against the reference's engine across two
    changed-weights updates, greedy and under the reference's Gumbel
    noise: trajectories, version tags and integer counters equal,
    logprobs within 1e-4 (f32, another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.rollout import RolloutEngine as JaxRolloutEngine
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.models import layers, rglru
from repro_torch.models.convert import params_from_jax

HYBRID = dict(name="t", family="hybrid", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab_size=tokenizer.VOCAB_SIZE, block_pattern=("rec", "local"),
              local_window=4)
ENGINES = {
    "ring-chunked": dict(prefill_chunk=3),
    "paged": dict(cache="paged", block_size=4),
    "paged-chunked": dict(cache="paged", block_size=4, prefill_chunk=3),
    "paged-fused": dict(cache="paged", block_size=4, fused_decode="fused"),
    "paged-chunked-fused": dict(cache="paged", block_size=4, prefill_chunk=3,
                                fused_decode="fused"),
}
INT_STATS = ("tokens_generated", "interruptions", "prefill_tokens", "reprefill_tokens",
             "prefix_reused_blocks", "deferred", "evictions", "revivals",
             "decode_steps_during_prefill", "ingest_backlog_tokens", "decode_dispatches")


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
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the conv's left context and the RG-LRU continued from a state
# ---------------------------------------------------------------------------

def test_conv_history_update_and_conv_with_history():
    rng = np.random.default_rng(0)
    hist = rng.standard_normal((3, 3, 8), dtype=np.float32)
    x = rng.standard_normal((3, 5, 8), dtype=np.float32)
    w = rng.standard_normal((4, 8), dtype=np.float32)
    length = np.array([5, 2, 0], np.int32)
    got = layers.conv_history_update(t(hist), t(x), t(length))
    want = jlayers.conv_history_update(jnp.asarray(hist), jnp.asarray(x), jnp.asarray(length))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = layers.causal_conv1d_apply(t(w), t(x), history=t(hist))
    want = jlayers.causal_conv1d_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                                       history=jnp.asarray(hist))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("with_valid", [True, False])
def test_rglru_prefill_state_continues_a_state(with_valid):
    cfg = dict(HYBRID, n_layers=3)
    jm = jax_build_model(JaxModelConfig(**cfg), remat=False)
    params = jm.init(jax.random.key(3))
    model = params_from_jax(ModelConfig(**cfg), flat_params(params), device="cpu")
    jp = params["units"][0]["rec"]
    jp = jax.tree.map(lambda a: a[0], jp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, cfg["d_model"]), dtype=np.float32)
    state = {"h": rng.standard_normal((3, model.cfg.lru_width), dtype=np.float32),
             "conv": rng.standard_normal((3, model.cfg.conv1d_width - 1, model.cfg.lru_width),
                                         dtype=np.float32)}
    valid = np.arange(5)[None, :] < np.array([5, 3, 1])[:, None] if with_valid else None
    out, new = rglru.rglru_prefill_state(
        model.cfg, model.blocks[0].rec, t(x), state={k: t(v) for k, v in state.items()},
        valid=None if valid is None else t(valid))
    jout, jnew = jrglru.rglru_prefill_state(
        JaxModelConfig(**cfg), jp, jnp.asarray(x),
        state={k: jnp.asarray(v) for k, v in state.items()},
        valid=None if valid is None else jnp.asarray(valid))
    rows = slice(None) if valid is None else valid
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(jout)[rows], atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), atol=1e-5)


# ---------------------------------------------------------------------------
# the LM's chunk and paged methods on the hybrid
# ---------------------------------------------------------------------------

def leaves(cache, model):
    """The reference's cache as the port's stacks: layer i of kind k is
    stack entry stack_index[i] (units, then the remainder)."""
    out = {}
    p = len(model.pattern)
    for i, kind in enumerate(model.kinds):
        c = cache["units"][i % p] if i < model.n_units * p else cache["rem"][i - model.n_units * p]
        unit = i // p if i < model.n_units * p else None
        for name, leaf in c.items():
            a = np.asarray(leaf)
            out.setdefault(name, []).append(a[unit] if unit is not None else a)
    return {name: np.stack(v) for name, v in out.items()} | {"t": np.asarray(cache["t"])}


def test_lm_chunk_and_paged_methods_match_reference():
    cfg = dict(HYBRID, n_layers=3)
    jm = jax_build_model(JaxModelConfig(**cfg), remat=False)
    params = jm.init(jax.random.key(5))
    model = params_from_jax(ModelConfig(**cfg), flat_params(params), device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(3, tokenizer.VOCAB_SIZE, size=(2, 7)).astype(np.int32)
    lens = np.array([7, 5], np.int32)
    b, n_blocks, bs = 2, 8, 4
    tables = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)

    # ring: the prompt in spans of 3, both rows at once
    jcache = jm.init_cache(b, 12)
    cache = model.init_cache(b, 12)
    sids = np.arange(b, dtype=np.int32)
    # paged: the same spans through the pool
    jpc = jm.init_paged_cache(b, n_blocks, bs)
    pc = model.init_paged_cache(b, n_blocks, bs)
    for s0 in range(0, 7, 3):
        span = toks[:, s0:s0 + 3]
        span = np.pad(span, ((0, 0), (0, 3 - span.shape[1])))
        start = np.full(b, s0, np.int32)
        length = np.clip(lens - s0, 0, 3).astype(np.int32)
        jl, jcache = jm.prefill_chunk(params, jnp.asarray(span), jcache, jnp.asarray(sids),
                                      jnp.asarray(start), jnp.asarray(length), all_logits=True)
        tl, _ = model.prefill_chunk(t(span), cache, t(sids), t(start), t(length),
                                    all_logits=True)
        real = np.arange(3)[None, :] < length[:, None]
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=1e-4)
        pos = start[:, None] + np.arange(3)[None, :]
        dest = np.where(np.arange(3)[None, :] < length[:, None],
                        np.take_along_axis(tables, np.minimum(pos // bs, 3), axis=1), -1)
        jl, jpc = jm.prefill_chunk_paged(params, jnp.asarray(span), jpc, jnp.asarray(tables),
                                         jnp.asarray(dest.astype(np.int32)), jnp.asarray(sids),
                                         jnp.asarray(start), jnp.asarray(length))
        tl, _ = model.prefill_chunk_paged(t(span), pc, t(tables), t(dest.astype(np.int32)),
                                          t(sids), t(start), t(length))
        rows = length > 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], atol=1e-4)
    for name, want in leaves(jcache, model).items():
        np.testing.assert_allclose(cache[name].numpy(), want, atol=1e-5, err_msg=name)
    want = leaves(jpc, model)
    for name in ("h", "conv", "t"):
        np.testing.assert_allclose(pc[name].numpy(), want[name], atol=1e-5, err_msg=name)

    # a monolithic paged prefill into fresh slots gives the same state
    pc2 = model.init_paged_cache(b, n_blocks, bs)
    dest = np.where(np.arange(7)[None, :] < lens[:, None],
                    np.take_along_axis(tables, np.arange(7)[None, :] // bs, axis=1), -1)
    jl, jpc2 = jm.prefill_paged(params, jnp.asarray(toks), jm.init_paged_cache(b, n_blocks, bs),
                                jnp.asarray(dest.astype(np.int32)), jnp.asarray(sids),
                                length=jnp.asarray(lens))
    tl, _ = model.prefill_paged(t(toks), pc2, t(dest.astype(np.int32)), t(sids), length=t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    want = leaves(jpc2, model)
    for name in ("h", "conv", "t"):
        np.testing.assert_allclose(pc2[name].numpy(), want[name], atol=1e-5, err_msg=name)

    # decode steps with row 1 held back, and a truncated draft step
    active = np.array([True, False])
    tok = np.array([5, 9], np.int32)
    for draft in (None, 1):
        jl, jpc = jm.decode_step_paged(params, jnp.asarray(tok), jpc, jnp.asarray(tables),
                                       jnp.asarray(active), draft_units=draft)
        tl, _ = model.decode_step_paged(t(tok), pc, t(tables), t(active), draft_units=draft)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        jl, jcache = jm.decode_step(params, jnp.asarray(tok), jcache, jnp.asarray(active),
                                    draft_units=draft)
        tl, _ = model.decode_step(t(tok), cache, t(active), draft_units=draft)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name, want in leaves(jcache, model).items():
        np.testing.assert_allclose(cache[name].numpy(), want, atol=1e-5, err_msg=name)
    want = leaves(jpc, model)
    for name in ("h", "conv", "t"):
        np.testing.assert_allclose(pc[name].numpy(), want[name], atol=1e-5, err_msg=name)
    # the pools at every written position
    for name in ("k_pool", "v_pool"):
        for i in range(b):
            for p in range(int(pc["t"][i])):
                blk, off = tables[i, min(p // bs, 3)], p % bs
                if blk < 0:
                    continue
                np.testing.assert_allclose(pc[name][:, blk, off].numpy(),
                                           want[name][:, blk, off], atol=1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def requests(seed=0):
    """Two prompts of 5-9 tokens, sampled twice each (prefix blocks
    shared on the paged cache), and two more."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(4):
        prompt = rng.integers(3, tokenizer.VOCAB_SIZE, size=int(rng.integers(5, 10))).tolist()
        out += [{"rid": len(out) + k, "prompt_id": g, "answer": None, "prompt": prompt}
                for k in range(2 if g < 2 else 1)]
    return out


def drive(engine, reqs, updates):
    done, pending, step = {}, list(reqs), 0
    while len(done) < len(reqs):
        n = engine.admit(pending)
        pending = pending[n:]
        if step in updates:
            engine.update_weights(*updates[step])
        for f in engine.step():
            done[f.rid] = f
        step += 1
        assert step < 300
    return done


def gumbel(seed):
    """The reference's Gumbel noise: key fold_in(key(seed), step) per
    step, or fold_in(fold_in(key(seed), rid), draw) per request."""
    key = jax.random.key(seed)

    def noise(*args):
        *ids, shape = args
        k = key
        for i in ids:
            k = jax.random.fold_in(k, i)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    return noise


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "gumbel"])
@pytest.mark.parametrize("name", list(ENGINES))
def test_hybrid_engine_matches_reference(name, temperature):
    jm = jax_build_model(JaxModelConfig(**HYBRID), remat=False)
    p0 = jm.init(jax.random.key(7))
    p1 = jax.tree.map(lambda x: x * 1.01, p0)
    p2 = jax.tree.map(lambda x: x * 0.99, p0)
    seed = 3
    kw = dict(n_slots=4, prompt_len=10, max_gen_len=6, seed=seed, temperature=temperature,
              **ENGINES[name])
    updates = {1: 1, 4: 2}
    jeng = JaxRolloutEngine(jm, p0, cfg=JaxEngineConfig(**kw))
    jdone = drive(jeng, requests(), {s: ((p0, p1, p2)[v], v) for s, v in updates.items()})
    models = [params_from_jax(ModelConfig(**HYBRID), flat_params(p), device="cpu")
              for p in (p0, p1, p2)]
    cfg = EngineConfig(**kw)
    noise = gumbel(seed) if temperature > 0 else None
    teng = RolloutEngine(models[0], cfg, device="cpu", noise=noise)
    tdone = drive(teng, requests(), {s: (models[v], v) for s, v in updates.items()})
    assert sorted(tdone) == sorted(jdone)
    for rid, want in jdone.items():
        got = tdone[rid]
        assert got.response == want.response, rid
        assert got.versions == want.versions, rid
        np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4, rtol=1e-4)
    jst, tst = jeng.stats(), teng.stats()
    assert {c: tst[c] for c in INT_STATS} == {c: jst[c] for c in INT_STATS}
    assert tst["interruptions"] == 2
    if "paged" in name:
        assert tst["prefix_reused_blocks"] > 0
        np.testing.assert_array_equal(teng.tables, jeng.tables)


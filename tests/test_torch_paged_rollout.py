"""The PyTorch port's paged ``RolloutEngine`` against the JAX engine, and
the port's own identities of the paged engine.

Both engines run live side by side on the same weights (the reference
initialises them; ``params_from_jax`` loads them into the port) over the
same GRPO-style grouped requests, whose full prompt blocks are shared in
the pool, and the same mid-flight weight updates with new weights.
Three configurations: paged with monolithic prefill, paged with chunked
prefill (chunk 3, which divides neither the prompts nor the block size)
in a pool small enough that admissions defer and parked prefix blocks
are evicted (``evict="lru"``), and chunked with the fused decode tail.
Finished trajectories must be token-identical and carry the same version
tags, logprobs agree within 1e-4 (f32, different summation order), and
the integer counters, block tables and blocks in use are equal.  Under temperature
1.0 the port is fed the reference's own Gumbel draws: per request,
``jax.random.categorical(key, lf)`` is ``argmax(lf + gumbel(key,
lf.shape))`` with key = ``fold_in(fold_in(key(seed), rid), draw)``; per
step, key = ``fold_in(key(seed), step)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.rollout import RolloutEngine as JaxRolloutEngine
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine, request_seed
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

ENGINE = dict(n_slots=4, prompt_len=10, max_gen_len=6, cache="paged", block_size=4)
PAGED = {
    "monolithic": {},
    "chunked-small-lru-pool": {"prefill_chunk": 3, "n_blocks": 9, "evict": "lru"},
    "chunked-fused": {"prefill_chunk": 3, "fused_decode": "fused"},
}
INT_STATS = ("tokens_generated", "interruptions", "prefill_tokens", "reprefill_tokens",
             "prefix_reused_blocks", "deferred", "deferred_last", "evictions", "revivals",
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


def configs():
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE)
    return (dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")), **kw),
            dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), **kw))


def group_requests(n_groups=3, group=3, seed=0):
    """``group`` samples of each of ``n_groups`` prompts of 5-10 tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(n_groups):
        prompt = rng.integers(3, tokenizer.VOCAB_SIZE, size=int(rng.integers(5, 11))).tolist()
        out += [{"rid": g * group + k, "prompt_id": g, "answer": None, "prompt": prompt}
                for k in range(group)]
    return out


def drive(engine, reqs, updates=None):
    """Admit what the engine takes as slots and blocks free up, apply
    ``updates[step] = (weights, version)`` before that step, run until
    all finish.  Returns (finished by rid, deferrals seen)."""
    updates = updates or {}
    done, pending, step, deferrals = {}, list(reqs), 0, 0
    while len(done) < len(reqs):
        n = engine.admit(pending)
        pending = pending[n:]
        deferrals += engine.deferred_last
        if step in updates:
            engine.update_weights(*updates[step])
        for f in engine.step():
            done[f.rid] = f
        step += 1
        assert step < 300
    return done, deferrals


def step_gumbel(seed):
    key = jax.random.key(seed)

    def noise(step, shape):
        return torch.from_numpy(np.array(
            jax.random.gumbel(jax.random.fold_in(key, step), shape, jnp.float32)))
    return noise


def request_gumbel(seed):
    key = jax.random.key(seed)

    def noise(rid, draw, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, rid), draw)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    return noise


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "gumbel"])
@pytest.mark.parametrize("name", list(PAGED))
def test_paged_engine_matches_reference_across_changed_weights(name, temperature):
    jcfg, tcfg = configs()
    jmodel = jax_build_model(jcfg, remat=False)
    p0 = jmodel.init(jax.random.key(7))
    p1 = jax.tree.map(lambda x: x * 1.01, p0)
    p2 = jax.tree.map(lambda x: x * 0.99, p0)
    seed = 3
    kw = {**ENGINE, **PAGED[name], "seed": seed, "temperature": temperature}
    jeng = JaxRolloutEngine(jmodel, p0, cfg=JaxEngineConfig(**kw))
    updates = {1: 1, 5: 2}
    jdone, jdef = drive(jeng, group_requests(), {s: ((p0, p1, p2)[v], v)
                                                 for s, v in updates.items()})

    models = [params_from_jax(tcfg, flat_params(p), device="cpu") for p in (p0, p1, p2)]
    cfg = EngineConfig(**kw)
    noise = None
    if temperature > 0:
        noise = request_gumbel(seed) if cfg.resolved_rng == "request" else step_gumbel(seed)
    teng = RolloutEngine(models[0], cfg, device="cpu", noise=noise)
    tdone, tdef = drive(teng, group_requests(), {s: (models[v], v) for s, v in updates.items()})

    assert sorted(tdone) == sorted(jdone)
    for rid, want in jdone.items():
        got = tdone[rid]
        assert got.response == want.response, rid
        assert got.versions == want.versions, rid
        assert (got.truncated, got.behavior_version, got.prompt) == \
            (want.truncated, want.behavior_version, want.prompt), rid
        np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4, rtol=1e-4)
    jst, tst = jeng.stats(), teng.stats()
    assert {c: tst[c] for c in INT_STATS} == {c: jst[c] for c in INT_STATS}
    assert tst["interruptions"] == 2 and tst["prefix_reused_blocks"] > 0
    assert any(len(set(f.versions)) > 1 for f in tdone.values())
    assert tdef == jdef
    if "small" in name:
        assert tst["deferred"] > 0 and tst["evictions"] > 0
    assert teng.blocks_in_use() == jeng.blocks_in_use()
    np.testing.assert_array_equal(teng.tables, jeng.tables)


# ---------------------------------------------------------------------------
# the port's own identities
# ---------------------------------------------------------------------------

def small_model(seed=0):
    _, tcfg = configs()
    return build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(seed))


def engine(model, **kw):
    return RolloutEngine(model, EngineConfig(**{**ENGINE, "seed": 4, **kw}), device="cpu")


def test_chunked_equals_monolithic_under_request_rng():
    """With per-request streams of the port's own generator, chunked
    ingestion (with same-weights interrupts landing mid-ingest) gives the
    monolithic engine's trajectories."""
    model = small_model()
    reqs = group_requests(seed=1)
    mono, _ = drive(engine(model, rng="request"), reqs)
    chunked, _ = drive(engine(model, prefill_chunk=3), reqs)
    e = engine(model, prefill_chunk=3)
    interrupted, _ = drive(e, reqs, {0: (model, 0), 2: (model, 0)})
    assert e.interruptions == 2
    for rid, f in mono.items():
        for other in (chunked, interrupted):
            assert other[rid].response == f.response
            np.testing.assert_allclose(other[rid].logprobs, f.logprobs, atol=1e-5)


def test_paged_engine_matches_ring_engine():
    model = small_model(1)
    reqs = group_requests(seed=2)
    ring, _ = drive(RolloutEngine(model, EngineConfig(
        **{**ENGINE, "cache": "ring", "seed": 4}), device="cpu"), reqs)
    e = engine(model)
    paged, _ = drive(e, reqs)
    for rid, f in ring.items():
        assert paged[rid].response == f.response
        np.testing.assert_allclose(paged[rid].logprobs, f.logprobs, atol=1e-5)
    assert e.prefix_reused_blocks > 0 and e.allocator.n_live == 0


def test_fused_split_and_default_give_equal_trajectories():
    model = small_model(2)
    reqs = group_requests(seed=3)
    runs = {}
    for mode in (None, "fused", "split"):
        e = engine(model, fused_decode=mode)
        runs[mode] = (drive(e, reqs)[0], e.decode_dispatches)
    base, dispatches = runs[None]
    for rid, f in base.items():
        for mode in ("fused", "split"):
            assert runs[mode][0][rid].response == f.response
            np.testing.assert_allclose(runs[mode][0][rid].logprobs, f.logprobs, atol=1e-5)
    assert runs["fused"][1] == dispatches and runs["split"][1] == 2 * dispatches


def test_request_streams_do_not_depend_on_batch_layout():
    """A request samples the same tokens alone as beside others."""
    model = small_model(3)
    reqs = group_requests(seed=4)
    together, _ = drive(engine(model, rng="request"), reqs)
    for r in reqs[:3]:
        alone, _ = drive(engine(model, rng="request"), [r])
        assert alone[r["rid"]].response == together[r["rid"]].response
    assert request_seed(0, 1, 2) != request_seed(0, 2, 1)


def test_lru_parks_and_revives_prefix_blocks():
    """A group admitted after its prompt's slots finished revives the
    parked prefix blocks instead of recomputing them."""
    model = small_model()
    e = engine(model, evict="lru", temperature=0.0)
    group = [r for r in group_requests(seed=5) if r["prompt_id"] == 0]
    drive(e, group[:1])
    assert e.allocator.n_cached > 0 and e.blocks_in_use() == e.allocator.n_cached
    before = e.prefix_reused_blocks
    drive(e, group[1:])
    assert e.allocator.revivals > 0 and e.prefix_reused_blocks > before

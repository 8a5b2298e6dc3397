"""The PyTorch port's ring-cache ``RolloutEngine`` against the JAX engine.

Both engines run live side by side on the same weights (the reference
initialises them; ``params_from_jax`` loads them into the port) over the
same requests and the same mid-flight weight updates, with new weights,
so each update interrupts in-flight requests and re-prefills them.
Finished trajectories must be token-identical and carry the same
version tags; logprobs agree within 1e-4 (f32, different summation
order); the integer counters are equal.  Under temperature 1.0 the port
is fed the reference's own Gumbel draws: ``jax.random.categorical(key,
lf)`` is ``argmax(lf + gumbel(key, lf.shape))`` with key =
``fold_in(key(seed), step)``.
"""
import dataclasses
import threading

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
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

ENGINE = dict(n_slots=4, prompt_len=8, max_gen_len=6)
COUNTERS = ("tokens_generated", "interruptions", "prefill_tokens", "reprefill_tokens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread each, so this file does not
    crowd the processes that other test files run beside it."""
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


def requests(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, tokenizer.VOCAB_SIZE,
                                    size=int(rng.integers(2, 9))).tolist()}
            for i in range(n)]


def drive(engine, reqs, updates=None):
    """Admit as slots free up, apply ``updates[step] = (weights,
    version)`` before that decode step, run until all finish."""
    updates = updates or {}
    done, pending, step = {}, list(reqs), 0
    while len(done) < len(reqs):
        n = engine.admit(pending)
        pending = pending[n:]
        if step in updates:
            engine.update_weights(*updates[step])
        for f in engine.step():
            done[f.rid] = f
        step += 1
        assert step < 200
    return done


def gumbel_of(seed):
    """The reference engine's Gumbel noise for step counter ``step``."""
    key = jax.random.key(seed)

    def noise(step, shape):
        g = jax.random.gumbel(jax.random.fold_in(key, step), shape, jnp.float32)
        return torch.from_numpy(np.array(g))
    return noise


def port_engine(model, noise=None, **kw):
    return RolloutEngine(model, EngineConfig(**{**ENGINE, **kw}), device="cpu", noise=noise)


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "gumbel"])
def test_engine_matches_reference_across_changed_weights(temperature):
    jcfg, tcfg = configs()
    jmodel = jax_build_model(jcfg, remat=False)
    p0 = jmodel.init(jax.random.key(7))
    p1 = jax.tree.map(lambda x: x * 1.01, p0)
    p2 = jax.tree.map(lambda x: x * 0.99, p0)
    seed = 3
    jeng = JaxRolloutEngine(jmodel, p0, cfg=JaxEngineConfig(**ENGINE, seed=seed,
                                                           temperature=temperature))
    jdone = drive(jeng, requests(), {1: (p1, 1), 4: (p2, 2)})

    models = [params_from_jax(tcfg, flat_params(p), device="cpu") for p in (p0, p1, p2)]
    teng = port_engine(models[0], noise=gumbel_of(seed) if temperature > 0 else None,
                       seed=seed, temperature=temperature)
    tdone = drive(teng, requests(), {1: (models[1], 1), 4: (models[2], 2)})

    assert sorted(tdone) == sorted(jdone)
    for rid, want in jdone.items():
        got = tdone[rid]
        assert got.response == want.response, rid
        assert got.versions == want.versions, rid
        assert (got.truncated, got.behavior_version, got.prompt) == \
            (want.truncated, want.behavior_version, want.prompt), rid
        np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4, rtol=1e-4)
    jst, tst = jeng.stats(), teng.stats()
    assert {c: tst[c] for c in COUNTERS} == {c: jst[c] for c in COUNTERS}
    assert tst["interruptions"] == 2
    assert any(len(set(f.versions)) > 1 for f in tdone.values())


def small_model(seed=0):
    _, tcfg = configs()
    return build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(seed))


def test_same_weights_interrupt_is_identity():
    """Proposition 1: re-prefilling under unchanged weights draws no noise
    and leaves every trajectory as it would have been."""
    model = small_model()
    d1 = drive(port_engine(model, seed=5), requests(seed=1))
    e2 = port_engine(model, seed=5)
    d2 = drive(e2, requests(seed=1), {1: (model, 0), 3: (model, 0)})
    assert e2.interruptions == 2
    for rid in d1:
        assert d1[rid].response == d2[rid].response
        np.testing.assert_allclose(d1[rid].logprobs, d2[rid].logprobs, atol=1e-5)


def test_non_interruptible_update_defers_until_drain():
    model = small_model()
    e = port_engine(model, n_slots=2)
    e.admit(requests(2))
    e.step()
    new = small_model(seed=1)
    assert not e.update_weights(new, version=1, interruptible=False)
    assert e.has_pending_weights and e.version == 0 and e.model is model
    assert not e.maybe_apply_pending()
    while e.n_active:
        e.step()
    assert e.maybe_apply_pending()
    assert e.version == 1 and e.model is model and not e.has_pending_weights
    # the engine copied the new weights into its own model
    assert all(torch.equal(a, b) for a, b in zip(e.model.parameters(), new.parameters()))
    assert e.interruptions == 0


def test_empty_prompt_is_fed_as_one_pad_token_on_reprefill():
    model = small_model()
    reqs = [{"rid": 0, "prompt": [], "answer": None},
            {"rid": 1, "prompt": [1, 4, 5], "answer": None}]
    d1 = drive(port_engine(model, seed=2), reqs)
    e = port_engine(model, seed=2)
    e.admit(reqs)
    assert e.stats()["prefill_tokens"] == 1 + 3
    assert e.inflight_tokens() == 0 + 3
    e.update_weights(model, 0)
    # histories re-fed: [pad] and the 3-token prompt (one response token,
    # still pending)
    assert e.stats()["reprefill_tokens"] == 1 + 3
    d2 = {}
    while e.n_active:
        for f in e.step():
            d2[f.rid] = f
    assert {r: f.response for r, f in d1.items()} == {r: f.response for r, f in d2.items()}


@pytest.mark.parametrize("kw", [
    {"prefill_chunk": 4}, {"spec_decode": 2, "temperature": 0.0},
    {"cache": "paged", "prefill_chunk": 4, "continuation": lambda fin, turn, budget: None},
    {"cache": "paged", "fused_decode": "fused"},
], ids=["chunked", "spec", "paged-chunked-continuation", "hybrid-fused"])
def test_later_slices_raise_not_implemented(kw):
    """What earlier parts of the port refused now runs: chunked prefill,
    ring or paged, of a model with recurrent blocks and speculative
    decoding give the trajectories of the plain engine (the ring engine
    without chunking, under the same per-request streams; greedy for
    speculation).  The fused decode tail on the hybrid (its local
    attention at head_dim 256 on the card), the last refusal, is held
    against the live reference's engine with the same config from the
    same weights, across a changed-weights update under the reference's
    Gumbel noise: responses and version tags equal, logprobs within
    1e-4, the counters equal."""
    if "spec_decode" in kw:
        model, plain = small_model(), {"temperature": 0.0}
    else:
        cfg = dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")),
                                  vocab_size=tokenizer.VOCAB_SIZE)
        model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        plain = {"rng": "request"}
    if "fused_decode" in kw:
        jcfg = dataclasses.replace(jax_reduced(jax_config("recurrentgemma-9b")),
                                   vocab_size=tokenizer.VOCAB_SIZE)
        jmodel = jax_build_model(jcfg, remat=False)
        p0 = jmodel.init(jax.random.key(4))
        p1 = jax.tree.map(lambda x: x * 1.01, p0)
        jeng = JaxRolloutEngine(jmodel, p0, cfg=JaxEngineConfig(**ENGINE, seed=2, **kw))
        want = drive(jeng, requests(seed=2), {2: (p1, 1)})
        models = [params_from_jax(model.cfg, flat_params(p), device="cpu") for p in (p0, p1)]
        e = port_engine(models[0], noise=gumbel_of(2), seed=2, **kw)
        got = drive(e, requests(seed=2), {2: (models[1], 1)})
        assert e.fused_decode == "fused" and e.stats()["interruptions"] == 1
        assert {c: e.stats()[c] for c in COUNTERS} == {c: jeng.stats()[c] for c in COUNTERS}
        for rid, f in want.items():
            assert (got[rid].response, got[rid].versions) == (f.response, f.versions), rid
            np.testing.assert_allclose(got[rid].logprobs, f.logprobs, atol=1e-4, rtol=1e-4)
        return
    want = drive(port_engine(model, seed=2, **plain), requests(seed=2))
    e = port_engine(model, seed=2, **kw)
    got = drive(e, requests(seed=2))
    assert e.stats()["spec_rounds" if "spec_decode" in kw else "prefill_tokens"] > 0
    for rid, f in want.items():
        assert got[rid].response == f.response, rid
        np.testing.assert_allclose(got[rid].logprobs, f.logprobs, atol=1e-4)


def test_single_driver_contract():
    e = port_engine(small_model())
    e.admit(requests(1))
    err = []
    th = threading.Thread(target=lambda: err.append(pytest.raises(RuntimeError, e.step)))
    th.start()
    th.join()
    assert err and "single-driver" in str(err[0].value)
    e.release_driver()
    th = threading.Thread(target=e.step)
    th.start()
    th.join()
    assert e.stats()["tokens_generated"] == 1

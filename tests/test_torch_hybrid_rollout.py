"""The PyTorch port's ring-cache ``RolloutEngine`` serving the RG-LRU
hybrid, against the JAX engine.

The config is ``tests/test_rollout.py``'s hybrid: pattern ``("rec",
"local")``, 2 layers, local window 4.  Both engines run live side by side
on the same weights (the reference initialises them; ``params_from_jax``
loads them) over the same requests and two mid-flight weight updates
with new weights, so each update interrupts in-flight requests and
re-prefills their histories through the recurrent blocks.  Finished
trajectories must be token-identical with the same version tags;
logprobs agree within 1e-4 (f32, another summation order); the integer
counters are equal.  Under temperature 1.0 the port is fed the
reference's own Gumbel draws (``fold_in(key(seed), step)``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.rollout import RolloutEngine as JaxRolloutEngine
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

HYBRID = dict(name="t", family="hybrid", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab_size=tokenizer.VOCAB_SIZE, block_pattern=("rec", "local"),
              local_window=4)
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


def requests(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, tokenizer.VOCAB_SIZE,
                                    size=int(rng.integers(2, 9))).tolist()}
            for i in range(n)]


def drive(engine, reqs, updates):
    """Admit as slots free up, apply ``updates[step] = (weights,
    version)`` before that decode step, run until all finish."""
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


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "gumbel"])
def test_hybrid_engine_matches_reference_across_changed_weights(temperature):
    jmodel = jax_build_model(JaxModelConfig(**HYBRID), remat=False)
    p0 = jmodel.init(jax.random.key(7))
    p1 = jax.tree.map(lambda x: x * 1.01, p0)
    p2 = jax.tree.map(lambda x: x * 0.99, p0)
    seed = 3
    jeng = JaxRolloutEngine(jmodel, p0, cfg=JaxEngineConfig(**ENGINE, seed=seed,
                                                           temperature=temperature))
    jdone = drive(jeng, requests(), {1: (p1, 1), 4: (p2, 2)})

    cfg = ModelConfig(**HYBRID)
    models = [params_from_jax(cfg, flat_params(p), device="cpu") for p in (p0, p1, p2)]
    teng = RolloutEngine(models[0], EngineConfig(**ENGINE, seed=seed, temperature=temperature),
                         device="cpu", noise=gumbel_of(seed) if temperature > 0 else None)
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


def test_same_weights_interrupt_is_identity_for_the_hybrid():
    """Proposition 1 through the recurrent state: re-prefilling under
    unchanged weights rebuilds h and the conv history exactly as decoding
    left them."""
    model = build_model(ModelConfig(**HYBRID), device="cpu").init(
        torch.Generator().manual_seed(0))
    cfg = EngineConfig(**ENGINE, seed=5, temperature=1.0)
    d1 = drive(RolloutEngine(model, cfg, device="cpu"), requests(seed=1), {})
    e2 = RolloutEngine(model, cfg, device="cpu")
    d2 = drive(e2, requests(seed=1), {1: (model, 0), 3: (model, 0)})
    assert e2.interruptions == 2
    for rid in d1:
        assert d1[rid].response == d2[rid].response
        np.testing.assert_allclose(d1[rid].logprobs, d2[rid].logprobs, atol=1e-5)


def test_paged_engine_on_the_hybrid_raises():
    model = build_model(ModelConfig(**HYBRID), device="cpu").init(
        torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="recurrent blocks.*later part"):
        RolloutEngine(model, EngineConfig(**ENGINE, cache="paged", block_size=4), device="cpu")

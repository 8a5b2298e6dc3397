"""The PyTorch port's engines serving an xLSTM model, against the JAX engine.

The config is ``tests/test_rollout.py``'s ssm model (pattern ``("mlstm",
"slstm")``, d 32, 4 heads) at 4 layers, so that a speculative draft of
one unit runs half the model.  The reference runs every engine
configuration on it: the ring and paged caches, monolithic and chunked
prefill (spans of 3), the fused decode tail (the paged engine's flag: an
xLSTM has no attention layer, so its decode is the recurrent step), and
speculative decoding on both caches.  In each, both engines run live side
by side from one init (the reference initialises, ``params_from_jax``
loads) over grouped requests and one mid-flight update to new weights
(re-prefilling every history through the recurrent state), greedy and
under the reference's own Gumbel keys.  Finished trajectories must be
token-identical with equal version tags, logprobs agree within 1e-4 (f32,
another summation order), and the integer counters (and, paged, the
block tables) are equal.
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

SSM = dict(name="t", family="ssm", n_layers=4, d_model=32, n_heads=4, n_kv_heads=4, d_ff=0,
           vocab_size=tokenizer.VOCAB_SIZE, block_pattern=("mlstm", "slstm"))
ENGINE = dict(n_slots=4, prompt_len=8, max_gen_len=6, block_size=4)
SETUPS = {
    "ring": {},
    "ring-chunked": {"prefill_chunk": 3},
    "paged": {"cache": "paged"},
    "paged-chunked": {"cache": "paged", "prefill_chunk": 3},
    "paged-fused": {"cache": "paged", "fused_decode": "fused"},
    "paged-chunked-fused": {"cache": "paged", "prefill_chunk": 3, "fused_decode": "fused"},
    "ring-spec": {"spec_decode": 2},
    "paged-spec-chunked": {"cache": "paged", "spec_decode": 3, "prefill_chunk": 3},
}
CASES = [("ring", 0.0), ("ring", 1.0), ("ring-chunked", 1.0), ("paged", 0.0),
         ("paged-chunked", 1.0), ("paged-fused", 0.0), ("paged-chunked-fused", 1.0),
         ("ring-spec", 0.0), ("paged-spec-chunked", 0.0)]
INT_STATS = ("tokens_generated", "interruptions", "prefill_tokens", "reprefill_tokens",
             "prefix_reused_blocks", "deferred", "decode_steps_during_prefill",
             "ingest_backlog_tokens", "decode_dispatches", "spec_rounds", "drafted_tokens",
             "accepted_tokens")


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


def group_requests(n_groups=3, group=2, seed=0):
    """``group`` samples of each of ``n_groups`` prompts of 3-8 tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(n_groups):
        prompt = rng.integers(3, tokenizer.VOCAB_SIZE, size=int(rng.integers(3, 9))).tolist()
        out += [{"rid": g * group + k, "prompt_id": g, "answer": None, "prompt": prompt}
                for k in range(group)]
    return out


def drive(engine, reqs, updates):
    done, pending, step = {}, list(reqs), 0
    while len(done) < len(reqs):
        pending = pending[engine.admit(pending):]
        if step in updates:
            engine.update_weights(*updates[step])
        for f in engine.step():
            done[f.rid] = f
        step += 1
        assert step < 300
    return done


def gumbel(seed, per_request):
    key = jax.random.key(seed)
    if per_request:
        def noise(rid, draw, shape):
            k = jax.random.fold_in(jax.random.fold_in(key, rid), draw)
            return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    else:
        def noise(step, shape):
            return torch.from_numpy(np.array(
                jax.random.gumbel(jax.random.fold_in(key, step), shape, jnp.float32)))
    return noise


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_build_model(JaxModelConfig(**SSM), remat=False)
    p0 = jmodel.init(jax.random.key(5))
    p1 = jax.tree.map(lambda x: x * 1.01, p0)
    cfg = ModelConfig(**SSM)
    return jmodel, (p0, p1), cfg


@pytest.mark.parametrize("name,temperature", CASES,
                         ids=[f"{n}-{'gumbel' if t else 'greedy'}" for n, t in CASES])
def test_xlstm_engine_matches_reference_across_changed_weights(weights, name, temperature):
    jmodel, (p0, p1), cfg = weights
    seed = 3
    kw = {**ENGINE, **SETUPS[name], "seed": seed, "temperature": temperature}
    jeng = JaxRolloutEngine(jmodel, p0, cfg=JaxEngineConfig(**kw))
    want = drive(jeng, group_requests(), {2: (p1, 1)})

    models = [params_from_jax(cfg, flat_params(p), device="cpu") for p in (p0, p1)]
    ecfg = EngineConfig(**kw)
    noise = gumbel(seed, ecfg.resolved_rng == "request") if temperature else None
    teng = RolloutEngine(models[0], ecfg, device="cpu", noise=noise)
    assert "mlstm" in teng.model.kinds and "slstm" in teng.model.kinds
    got = drive(teng, group_requests(), {2: (models[1], 1)})

    assert sorted(got) == sorted(want)
    for rid, f in want.items():
        assert (got[rid].response, got[rid].versions) == (f.response, f.versions), rid
        np.testing.assert_allclose(got[rid].logprobs, f.logprobs, atol=1e-4, rtol=1e-4)
    jst, tst = jeng.stats(), teng.stats()
    assert {c: tst[c] for c in INT_STATS if c in jst} == {c: jst[c] for c in INT_STATS if c in jst}
    assert tst["interruptions"] == 1
    assert any(len(set(f.versions)) > 1 for f in got.values())
    if teng.cache_mode == "paged":
        np.testing.assert_array_equal(teng.tables, jeng.tables)
    if teng.spec_decode:
        assert tst["spec_rounds"] > 0 and tst["accepted_tokens"] > 0

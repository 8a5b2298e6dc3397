"""The port's serving path below the gateway against the JAX reference:
ring-cache chunked prefill (``LM.prefill_chunk`` and the ring engine
with ``prefill_chunk > 0``), multi-turn continuation, the Perfetto
export of a traced run, and ``launch/serve.py`` offline.

Both sides run live on the same weights (the reference initialises them;
``params_from_jax`` loads them into the port).  Under temperature 1.0 the
port is fed the reference's own Gumbel draws: per request, key =
``fold_in(fold_in(key(seed), rid), draw)``.  Trajectories must be
token-identical; logits and logprobs agree within 1e-5 (f32, the same
operations in another summation order); cache positions exactly.
"""
import argparse
import dataclasses
import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.rollout import RolloutEngine as JaxRolloutEngine
from repro.env import MultiTurnEnv as JaxMultiTurnEnv
from repro.launch import serve as jax_serve
from repro.models.model import build_model as jax_build_model
from repro.obs import export as jax_export
from repro.obs import trace as jax_trace
from repro_torch.configs import get_model_config, reduced
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.env import MultiTurnEnv
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import export
from repro_torch.obs import trace

TOL = 1e-5
COUNTERS = ("tokens_generated", "interruptions", "prefill_tokens", "reprefill_tokens",
            "prefix_reused_blocks", "deferred", "evictions", "revivals",
            "decode_steps_during_prefill", "ingest_backlog_tokens", "continuations",
            "continuation_tokens", "decode_dispatches")


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


def configs(**extra):
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE, **extra)
    return (dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")), **kw),
            dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), **kw))


def pair(seed=7, **extra):
    """(JAX model, its params, the port's LM of the same weights)."""
    jcfg, tcfg = configs(**extra)
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(seed))
    return jmodel, params, params_from_jax(tcfg, flat_params(params), device="cpu")


def request_gumbel(seed):
    key = jax.random.key(seed)

    def noise(rid, draw, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, rid), draw)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    return noise


# ---------------------------------------------------------------------------
# LM.prefill_chunk
# ---------------------------------------------------------------------------

# (slot ids, starts, lengths) of each call, spans of C = 6: row j feeds
# tokens [start, start + length) of slot j's history, the rest padding
SPANS = [([0, 2], [0, 0], [6, 3]),
         ([2, 0, 1], [3, 6, 0], [6, 2, 5]),
         ([1, 2], [5, 9], [1, 6])]


@pytest.mark.parametrize("extra", [{}, {"sliding_window": 4, "block_pattern": ("swa",)}],
                         ids=["attn", "swa-wraps"])
def test_prefill_chunk_matches_reference(extra):
    """Spans at several watermarks, rows with padding tokens, and (swa)
    a ring of width 4 under spans of 6, so the span's last 4 valid
    tokens are what it keeps."""
    jmodel, params, model = pair(**extra)
    rng = np.random.default_rng(0)
    n_slots, max_len, c = 3, 20, 6
    hist = rng.integers(3, tokenizer.VOCAB_SIZE, size=(n_slots, max_len)).astype(np.int32)
    jcache = jmodel.init_cache(n_slots, max_len)
    cache = model.init_cache(n_slots, max_len)
    if extra:
        assert cache["k"].shape[2] == 4 < c
    for slots, starts, lengths in SPANS:
        toks = np.zeros((len(slots), c), np.int32)
        for j, (i, b, n) in enumerate(zip(slots, starts, lengths)):
            toks[j, :n] = hist[i, b:b + n]
        args = [np.asarray(x, np.int32) for x in (slots, starts, lengths)]
        jlogits, jcache = jmodel.prefill_chunk(params, jnp.asarray(toks), jcache,
                                               *map(jnp.asarray, args))
        logits, cache = model.prefill_chunk(torch.from_numpy(toks).long(), cache,
                                            *map(torch.from_numpy, args))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
        ju = jcache["units"][0]
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ju["pos"]))
        np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(ju[name]),
                                       rtol=TOL, atol=TOL)


def test_reset_slot_rows_empties_ring_rows():
    _, _, model = pair()
    cache = model.init_cache(3, 8)
    toks = torch.arange(3, 9).reshape(1, 6)
    model.prefill_chunk(toks, cache, torch.tensor([1]), torch.tensor([0], dtype=torch.int32),
                        torch.tensor([6], dtype=torch.int32))
    assert cache["t"].tolist() == [0, 6, 0] and bool((cache["pos"][:, 1, :6] >= 0).all())
    model.reset_slot_rows(cache, torch.tensor([1]))
    assert cache["t"].tolist() == [0, 0, 0] and bool((cache["pos"] == -1).all())
    assert not cache["k"].any() and not cache["v"].any()


# ---------------------------------------------------------------------------
# the ring engine with chunked prefill
# ---------------------------------------------------------------------------

def requests(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, tokenizer.VOCAB_SIZE,
                                    size=int(rng.integers(2, 9))).tolist()}
            for i in range(n)]


def drive(engine, reqs, updates=None):
    """Admit as slots free up, apply ``updates[step] = (weights,
    version)`` before that step, run until all finish."""
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
        assert step < 300
    return done


def assert_same_runs(tdone, jdone, teng, jeng):
    assert sorted(tdone) == sorted(jdone)
    for rid, want in jdone.items():
        got = tdone[rid]
        assert (got.response, got.versions, got.prompt, got.truncated, got.turns,
                got.loss_mask) == (want.response, want.versions, want.prompt,
                                   want.truncated, want.turns, want.loss_mask), rid
        np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=TOL, atol=TOL)
    tst, jst = teng.stats(), jeng.stats()
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "gumbel"])
def test_ring_chunked_engine_matches_reference(temperature):
    """Spans of 3 (dividing no prompt), 4 slots for 6 requests, and two
    updates to new weights that land mid-ingest and mid-decode."""
    jmodel, p0, m0 = pair()
    p1 = jax.tree.map(lambda x: x * 1.01, p0)
    p2 = jax.tree.map(lambda x: x * 0.99, p0)
    _, tcfg = configs()
    models = [m0] + [params_from_jax(tcfg, flat_params(p), device="cpu") for p in (p1, p2)]
    kw = dict(n_slots=4, prompt_len=8, max_gen_len=6, prefill_chunk=3, seed=3,
              temperature=temperature)
    jeng = JaxRolloutEngine(jmodel, p0, cfg=JaxEngineConfig(**kw))
    jdone = drive(jeng, requests(), {1: (p1, 1), 6: (p2, 2)})
    teng = RolloutEngine(models[0], EngineConfig(**kw), device="cpu",
                         noise=request_gumbel(3) if temperature else None)
    tdone = drive(teng, requests(), {1: (models[1], 1), 6: (models[2], 2)})
    assert_same_runs(tdone, jdone, teng, jeng)
    assert teng.interruptions == 2 and teng.stats()["reprefill_tokens"] > 0
    assert any(len(set(f.versions)) > 1 for f in tdone.values())


# ---------------------------------------------------------------------------
# multi-turn continuation
# ---------------------------------------------------------------------------

def multiturn_run(make, env, *, cache, eos, interrupt_at=(), n=4):
    """The multi-turn environment's prompts and continuation hook, with
    ``eos`` a token the run samples early, so that turns end and the
    environment answers back."""
    eng = make(dict(n_slots=3, prompt_len=16, max_gen_len=32, seed=0, cache=cache,
                    block_size=4, prefill_chunk=4, eos_id=eos,
                    continuation=env.continuation_hook()))
    reqs = [{"rid": i, "prompt_id": i, "prompt": p.prompt_tokens, "answer": p.answer}
            for i, p in enumerate(env.sample() for _ in range(n))]
    done, pending, step = {}, list(reqs), 0
    while len(done) < len(reqs):
        k = eng.admit(pending)
        pending = pending[k:]
        if step in interrupt_at:           # same weights: a re-ingest only
            eng.update_weights(getattr(eng, "params", None) or eng.model, eng.version)
        for f in eng.step():
            done[f.rid] = f
        step += 1
        assert step < 1000
    return eng, done


@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_multiturn_matches_reference(cache):
    jmodel, params, model = pair()
    make_j = lambda kw: JaxRolloutEngine(jmodel, params, cfg=JaxEngineConfig(**kw))
    make_t = lambda kw: RolloutEngine(model, EngineConfig(**kw), device="cpu",
                                      noise=request_gumbel(0))
    # a token the run samples early ends each turn: the env answers back
    _, probe = multiturn_run(make_j, JaxMultiTurnEnv(seed=5), cache=cache, eos=-1)
    eos = probe[0].response[1]
    jeng, jdone = multiturn_run(make_j, JaxMultiTurnEnv(seed=5), cache=cache, eos=eos,
                                interrupt_at=(5, 11))
    teng, tdone = multiturn_run(make_t, MultiTurnEnv(seed=5), cache=cache, eos=eos,
                                interrupt_at=(5, 11))
    assert_same_runs(tdone, jdone, teng, jeng)
    st = teng.stats()
    assert st["continuations"] >= 1 and st["interruptions"] == 2
    multi = [f for f in tdone.values() if f.turns > 1]
    assert multi
    for f in multi:
        assert len(f.loss_mask) == len(f.response) and 0.0 in f.loss_mask
        assert all(lp == 0.0 for lp, m in zip(f.logprobs, f.loss_mask) if m == 0.0)


# ---------------------------------------------------------------------------
# the trace export
# ---------------------------------------------------------------------------

class _Ticks:
    """A clock that advances one unit a reading: both sides' tracers read
    it once an event, so equal runs give equal timestamps."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1
        return float(self.t)


def test_chrome_trace_matches_reference():
    """One traced chunked run on each side (admission, spans, decode
    steps, finishes, a weight flip): the exported Chrome trace has the
    same events, in the same order, with the same names, phases, lanes,
    timestamps and arguments."""
    jmodel, params, model = pair()
    kw = dict(n_slots=2, prompt_len=8, max_gen_len=5, prefill_chunk=3, seed=1,
              cache="paged", block_size=4)
    out = {}
    for side, tr, ex in (("ref", jax_trace, jax_export), ("port", trace, export)):
        tracer = tr.get()
        tracer.drain()
        tracer.configure(enabled=True, clock=_Ticks(), actor="serve")
        try:
            if side == "ref":
                eng = JaxRolloutEngine(jmodel, params, cfg=JaxEngineConfig(**kw))
                drive(eng, requests(3), {4: (params, 0)})
            else:
                eng = RolloutEngine(model, EngineConfig(**kw), device="cpu",
                                    noise=request_gumbel(1))
                drive(eng, requests(3), {4: (model, 0)})
            events = tracer.drain()
        finally:
            tracer.configure(enabled=False, clock=time.perf_counter, actor="main")
        out[side] = json.loads(json.dumps(ex.chrome_trace(events)))
    names = [e["name"] for e in out["port"]["traceEvents"]]
    for want in ("engine.admit", "engine.ingest", "engine.step", "engine.finished",
                 "engine.weight_flip"):
        assert want in names
    assert out["port"] == out["ref"]


def test_disabled_tracer_records_nothing():
    _, _, model = pair()
    tracer = trace.get()
    assert not tracer.enabled
    tracer.drain()
    eng = RolloutEngine(model, EngineConfig(n_slots=2, prompt_len=8, max_gen_len=4,
                                            prefill_chunk=3), device="cpu")
    drive(eng, requests(2))
    assert tracer.event_count() == 0


# ---------------------------------------------------------------------------
# launch/serve.py offline
# ---------------------------------------------------------------------------

SERVE_ARGS = {
    "ring-math": [],
    "paged-multiturn-sessions": ["--cache", "paged", "--evict", "lru", "--block-size", "4",
                                 "--prefill-chunk", "8", "--env", "multiturn",
                                 "--sessions", "3", "--max-gen", "32", "--slots", "4"],
}


@pytest.mark.parametrize("name", list(SERVE_ARGS))
def test_serve_offline_matches_reference(name):
    """``build_gateway`` + ``run_offline`` on each side, from the flags
    of ``launch/serve.py``: the summary equal but for ``tokens_per_s``
    (the port serves the reference's weights and draws its noise)."""
    argv = ["--requests", "12", "--device", "cpu"] + SERVE_ARGS[name]
    ap = argparse.ArgumentParser()
    serve.add_flags(ap)
    args = ap.parse_args(argv)
    jargs = SimpleNamespace(**vars(args))
    jgw, jenv = jax_serve.build_gateway(jargs)
    want = jax_serve.run_offline(jgw, jenv, jargs)
    _, tcfg = configs()
    model = params_from_jax(tcfg, flat_params(jgw.engine.params), device="cpu")
    gw, env = serve.build_gateway(args, model=model)
    gw.engine.noise = request_gumbel(args.seed)
    got = serve.run_offline(gw, env, args)
    for out in (got, want):
        out.pop("tokens_per_s")
    assert got == want
    if "multiturn" in name:
        assert got["continuations"] > 0 and got["evictions"] > 0


def test_obs_package_exports_the_perfetto_export():
    """``repro_torch.obs`` imports ``export`` and lists it, as the
    reference's ``repro/obs/__init__.py`` does: the same ``__all__``,
    exactly."""
    import repro.obs as jax_obs
    import repro_torch.obs as obs
    assert obs.export is export
    assert obs.__all__ == jax_obs.__all__
    for name in obs.__all__:
        assert getattr(obs, name).__name__ == f"repro_torch.obs.{name}"

"""Self-speculative decoding in the PyTorch port's ``RolloutEngine``,
against the JAX engine and against the port's own plain engine.

The configurations and requests are ``tests/test_rollout.py``'s: a dense
model and the RG-LRU hybrid (pattern ``("rec", "local")``, local window
4), 3 layers, 4 slots, prompts of 4 tokens, 6 generated, greedy.  The
reference initialises the weights and ``params_from_jax`` loads them into
the port.  Over the matrix {dense, hybrid} x {ring, paged} x
{prefill_chunk 0, 3} with ``spec_decode=3``:

  * the port's speculative engine equals its plain engine token for
    token, logprobs within 1e-4 (verify scores a position by chunk
    attention, the plain engine by a decode step: another summation
    order);
  * it equals the live JAX speculative engine token for token, with
    every speculative counter of ``stats()`` equal.

Then the reference's other speculative tests on the port (an
interrupting ``update_weights`` between draft and verify, the
validation, the stats surface), and what the port adds because its
caches are updated in place: a draft step leaves every cache tensor as
it found it, bit for bit in f32, and a verify+commit leaves what the
commit alone would have left, bit for bit, over a wrapped ring, the
recurrent state and a pool whose slots share a prompt block; and the
caches stay within 1e-5 of the plain engine's at the committed
positions (bitwise equality there is not to be had: the commit runs
the span through chunk attention and the scan, the plain engine
through decode steps).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.rollout import RolloutEngine as JaxRolloutEngine
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.core.batching import span_dest_blocks
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

FAMILIES = {"dense": {}, "hybrid": {"block_pattern": ("rec", "local"), "local_window": 4}}
SPEC_STATS = ("tokens_generated", "decode_dispatches", "drafted_tokens", "accepted_tokens",
              "spec_rounds", "draft_acceptance_rate", "accepted_tokens_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(family, **kw):
    base = dict(name="t", family=family, n_layers=3, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=tokenizer.VOCAB_SIZE, **FAMILIES[family])
    base.update(kw)
    return base


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def engine_kw(cache, prefill_chunk=0, **kw):
    return dict(n_slots=4, prompt_len=8, max_gen_len=6, seed=3, temperature=0.0, cache=cache,
                block_size=4, prefill_chunk=prefill_chunk,
                rng="request" if prefill_chunk else "auto", **kw)


def reqs(n, start=0):
    return [{"rid": start + i, "prompt_id": start + i, "prompt": [1, 4 + i, 5, 6],
             "answer": None} for i in range(n)]


def run(engine, requests, interrupt=None):
    """Admit as slots free up and step to the end; ``interrupt(engine)``
    runs before each step."""
    done, pending, step = {}, list(requests), 0
    while len(done) < len(requests):
        n = engine.admit(pending)
        pending = pending[n:]
        if interrupt is not None:
            interrupt(engine)
        for f in engine.step():
            done[f.rid] = f
        step += 1
        assert step < 500
    return done


def pair(family, **kw):
    """The reference's model and weights (key 7), and the port's LM
    holding them."""
    jmodel = jax_build_model(JaxModelConfig(**tiny(family, **kw)), remat=False)
    params = jmodel.init(jax.random.key(7))
    model = params_from_jax(ModelConfig(**tiny(family, **kw)), flat_params(params),
                            device="cpu")
    return jmodel, params, model


@pytest.mark.parametrize("prefill_chunk", [0, 3])
@pytest.mark.parametrize("cache", ["ring", "paged"])
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_spec_matches_plain_engine_and_reference(family, cache, prefill_chunk):
    jmodel, params, model = pair(family)
    jeng = JaxRolloutEngine(jmodel, params, cfg=JaxEngineConfig(
        **engine_kw(cache, prefill_chunk, spec_decode=3)))
    jdone = run(jeng, reqs(6))
    plain = run(RolloutEngine(model, EngineConfig(**engine_kw(cache, prefill_chunk)),
                              device="cpu"), reqs(6))
    eng = RolloutEngine(model, EngineConfig(**engine_kw(cache, prefill_chunk, spec_decode=3)),
                        device="cpu")
    done = run(eng, reqs(6))
    assert eng.spec_rounds > 0 and eng.drafted_tokens > 0
    assert eng.accepted_tokens == eng.tokens_generated
    assert 0.0 <= eng.draft_acceptance_rate <= 1.0
    for rid, want in plain.items():
        assert done[rid].response == want.response, rid
        np.testing.assert_allclose(done[rid].logprobs, want.logprobs, atol=1e-4)
    for rid, want in jdone.items():
        assert done[rid].response == want.response, rid
        assert done[rid].versions == want.versions, rid
        np.testing.assert_allclose(done[rid].logprobs, want.logprobs, atol=1e-4)
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in SPEC_STATS} == {k: jst[k] for k in SPEC_STATS}


@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_spec_interrupt_mid_draft_is_identity(cache):
    """A same-weights update landing between the draft and the verify
    step discards the drafted round, never committed state: trajectories
    equal the uninterrupted plain engine's, and the round is drafted
    again."""
    _, _, model = pair("dense")
    want = run(RolloutEngine(model, EngineConfig(**engine_kw(cache)), device="cpu"), reqs(5))
    eng = RolloutEngine(model, EngineConfig(**engine_kw(cache, spec_decode=3)), device="cpu")
    hits = []

    def interrupt(e):
        # the first few drafted rounds only: interrupting every one would
        # never commit
        if e.spec_pending and len(hits) < 3:
            hits.append(e.spec_rounds)
            e.update_weights(e.model, e.version)
            assert not e.spec_pending
    done = run(eng, reqs(5), interrupt)
    assert hits and eng.interruptions == len(hits)
    for rid in want:
        assert done[rid].response == want[rid].response
        np.testing.assert_allclose(done[rid].logprobs, want[rid].logprobs, atol=1e-4)


def test_decode_fastpath_validation():
    """The spec cases of the reference's ``test_decode_fastpath_validation``."""
    model = build_model(ModelConfig(**tiny("dense")), device="cpu")

    def make(**kw):
        return RolloutEngine(model, EngineConfig(n_slots=2, prompt_len=8, max_gen_len=6, **kw),
                             device="cpu")

    with pytest.raises(ValueError, match="temperature"):
        make(spec_decode=3)
    with pytest.raises(ValueError, match=">= 2"):
        make(spec_decode=1, temperature=0.0)
    with pytest.raises(ValueError, match="one"):
        make(cache="paged", fused_decode="fused", spec_decode=3, temperature=0.0)
    with pytest.raises(ValueError, match="spec_draft_units"):
        make(spec_decode=3, temperature=0.0, spec_draft_units=99)
    assert make(spec_decode=3, temperature=0.0)._spec_draft_units == model.n_units - 1


def test_spec_stats_surface():
    """stats() exposes the speculative counters that the fleet's liveness
    line reads."""
    _, _, model = pair("dense")
    eng = RolloutEngine(model, EngineConfig(**engine_kw("paged", spec_decode=3)),
                        device="cpu")
    run(eng, reqs(4))
    st = eng.stats()
    for key in ("decode_dispatches", "drafted_tokens", "accepted_tokens", "spec_rounds",
                "draft_acceptance_rate", "accepted_tokens_per_step"):
        assert key in st, key
    assert st["drafted_tokens"] > 0


# ---------------------------------------------------------------------------
# discard semantics on caches updated in place
# ---------------------------------------------------------------------------

DISCARD = {   # family, config overrides, cache: each a cache the draft could spoil
    "ring-swa": ("dense", {"sliding_window": 4}, "ring"),      # wrapped ring, W = 4
    "ring-hybrid": ("hybrid", {}, "ring"),                     # wrapped local ring, h, conv
    "paged-dense": ("dense", {}, "paged"),                     # a shared prompt block
    "paged-hybrid": ("hybrid", {}, "paged"),
}
BS = 4


def clone(cache):
    return {name: x.clone() for name, x in cache.items()}


def committed_rows(cache, tables, t):
    """Each slot's pool rows at positions < t, the positions a query of
    the slot reads, (L, sum t, Hkv, hd) per pool."""
    rows = [(int(tables[i, p // BS]), p % BS) for i in range(len(t)) for p in range(int(t[i]))]
    blk = torch.tensor([r[0] for r in rows], dtype=torch.long)
    off = torch.tensor([r[1] for r in rows], dtype=torch.long)
    return {name: cache[name][:, blk, off] for name in ("k_pool", "v_pool") if name in cache}


def assert_same(got, want, tables=None, t=None, what=""):
    """Every tensor bit for bit; a pool at the slots' read positions."""
    for name, x in want.items():
        if name in ("k_pool", "v_pool"):
            continue
        assert torch.equal(got[name], x), (what, name)
    if tables is not None:
        g, w = committed_rows(got, tables, t), committed_rows(want, tables, t)
        for name in w:
            assert torch.equal(g[name], w[name]), (what, name)


@pytest.mark.parametrize("case", list(DISCARD))
def test_spec_round_leaves_only_its_commit(case):
    family, extra, cache = DISCARD[case]
    _, _, model = pair(family, **extra)
    prompt = [1, 4, 5, 6, 7]                     # a full block of 4, and past W = 4
    requests = [{"rid": i, "prompt": p, "answer": None}
                for i, p in enumerate([prompt, prompt, [2, 9, 3, 8, 8, 3]])]
    eng = RolloutEngine(model, EngineConfig(n_slots=3, prompt_len=8, max_gen_len=10, seed=3,
                                            temperature=0.0, cache=cache, block_size=BS,
                                            spec_decode=3), device="cpu")
    assert eng.admit(requests) == 3
    paged = cache == "paged"
    if paged:
        assert eng.tables[0, 0] == eng.tables[1, 0]            # the shared prompt block
        shared = int(eng.tables[0, 0])
        block0 = (eng.cache["k_pool"][:, shared].clone(), eng.cache["v_pool"][:, shared].clone())
    rejected = 0
    while eng.n_active:
        tables = eng.tables.copy() if paged else None
        before = clone(eng.cache)
        assert eng.step() == [] and eng.spec_pending              # the draft
        rnd = dict(eng._draft)
        assert_same(eng.cache, before, tables, before["t"], "draft")
        members = np.nonzero(rnd["members"])[0]
        lens = {i: len(eng.slots[i].response) for i in members}
        fin = {f.rid: f for f in eng.step()}                       # verify + commit
        acc = np.array([len(eng.slots[i].response) - lens[i] if eng.slots[i].active
                        else len(fin[i].response) - lens[i] for i in members], np.int32)
        rejected += int(np.sum((acc < 3) & (acc < 10 - np.array(list(lens.values())))))
        # the commit alone, from the cache the round started from
        want = before
        toks = torch.from_numpy(np.concatenate([rnd["pend"][members, None],
                                                rnd["drafts"][:, members].T], axis=1))
        start, sid = torch.from_numpy(rnd["t0"][members]), torch.from_numpy(members)
        if paged:
            dest = span_dest_blocks(tables[members], rnd["t0"][members], acc, BS, 3)
            model.prefill_chunk_paged(toks, want, torch.from_numpy(tables[members]),
                                      torch.from_numpy(dest), sid, start, torch.from_numpy(acc))
        else:
            model.prefill_chunk(toks, want, sid, start, torch.from_numpy(acc))
        assert_same(eng.cache, want, tables, want["t"], "verify+commit")
    assert rejected > 0
    if paged:
        assert torch.equal(eng.cache["k_pool"][:, shared], block0[0])
        assert torch.equal(eng.cache["v_pool"][:, shared], block0[1])


@pytest.mark.parametrize("case", list(DISCARD))
def test_spec_cache_tracks_the_plain_engine(case):
    """One slot, so that the plain engine can be stepped to each round's
    committed length: every cache tensor (ring entries, recurrent state,
    the pool at positions below t) within 1e-5 of the plain engine's."""
    family, extra, cache = DISCARD[case]
    _, _, model = pair(family, **extra)
    kw = dict(n_slots=1, prompt_len=8, max_gen_len=12, seed=3, temperature=0.0, cache=cache,
              block_size=BS, eos_id=-1)
    plain = RolloutEngine(model, EngineConfig(**kw), device="cpu")
    eng = RolloutEngine(model, EngineConfig(**kw, spec_decode=3), device="cpu")
    req = [{"rid": 0, "prompt": [1, 4, 5, 6, 7], "answer": None}]
    plain.admit(req)
    eng.admit(req)
    rounds = 0
    while True:
        eng.step()
        fin = eng.step()
        if fin:
            break
        rounds += 1
        n = len(eng.slots[0].response)
        while len(plain.slots[0].response) < n:
            plain.step()
        assert plain.slots[0].response == eng.slots[0].response
        t = eng.cache["t"].clone()
        assert torch.equal(plain.cache["t"], t)
        for name, x in plain.cache.items():
            if name not in ("k_pool", "v_pool"):
                torch.testing.assert_close(eng.cache[name], x, atol=1e-5, rtol=0)
        if cache == "paged":
            got, want = committed_rows(eng.cache, eng.tables, t), committed_rows(
                plain.cache, plain.tables, t)
            for name in want:
                torch.testing.assert_close(got[name], want[name], atol=1e-5, rtol=0)
    assert rounds > 2


def test_a_draft_step_past_the_table_writes_nothing():
    """Near the end of a generation a draft step can sit at a position
    past the slot's block table.  The reference clamps the lookup to the
    last entry (harmless there: it drops the draft's writes); the port
    writes in place, so such a step must write nothing, or it would
    overwrite a committed row of the last block."""
    from repro_torch.models import attention
    tables = torch.tensor([[5, 6], [7, -1]], dtype=torch.int32)
    dest = attention.decode_dest_blocks(torch.tensor([7, 8], dtype=torch.int32), tables, 4)
    assert dest.tolist() == [6, -1]
    dest = attention.decode_dest_blocks(torch.tensor([8, 3], dtype=torch.int32), tables, 4,
                                        active=torch.tensor([True, False]))
    assert dest.tolist() == [-1, -1]
    _, _, model = pair("dense")
    cache = model.init_paged_cache(2, 8, 4)
    cache["k_pool"].normal_()
    before = cache["k_pool"].clone()
    cache["t"].copy_(torch.tensor([8, 8], dtype=torch.int32))     # E * bs = 8: past the table
    model.decode_step_paged(torch.tensor([3, 4]), cache, tables, draft_units=1)
    assert torch.equal(cache["k_pool"], before)

"""The port's serving gateway against the JAX reference's.

Each engine-backed test of ``tests/test_gateway.py`` runs its scenario
twice: through the reference's ``Gateway`` over the JAX engine, and
through the port's over the port's engine on the same weights
(``params_from_jax``), fed the reference's own Gumbel draws (per
request, key = ``fold_in(fold_in(key(seed), rid), draw)``).  Each
request's streamed tokens and ``Finished`` response, and every counter
of ``Gateway.stats()`` (TTFT and ITL in gateway ticks included), must be
equal on both sides; the port's preempted run must also equal its
unpreempted twin token for token, and its Prometheus text must carry the
reference's ``repro_gateway_*`` names.  The HTTP front-end runs on the
port alone (its threads make the tick clock a wall clock).  The card's
cases are in ``tests/test_torch_gateway_cuda.py``.
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
from repro.serve import Gateway as JaxGateway
from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Gateway
from test_torch_gateway_cuda import check_http, http_waves

CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=64, vocab_size=tokenizer.VOCAB_SIZE)
BASE = dict(n_slots=2, prompt_len=8, max_gen_len=6, seed=0, cache="paged", block_size=4,
            evict="lru", prefill_chunk=4)


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


def request_gumbel(seed):
    key = jax.random.key(seed)

    def noise(rid, draw, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, rid), draw)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    return noise


@pytest.fixture(scope="module")
def tiny():
    """``tests/test_gateway.py``'s tiny model: the reference's init from
    key 7, and the port's LM of the same weights."""
    jmodel = jax_build_model(JaxModelConfig(**CFG), remat=False)
    params = jmodel.init(jax.random.key(7))
    return jmodel, params, params_from_jax(ModelConfig(**CFG), flat_params(params),
                                           device="cpu")


def port_engine(tiny, **kw):
    cfg = {**BASE, **kw}
    return RolloutEngine(tiny[2], EngineConfig(**cfg), device="cpu",
                         noise=request_gumbel(cfg["seed"]))


def both(tiny, scenario, **kw):
    """``scenario(gateway_class, engine)`` on the reference and on the
    port; returns (reference's result, port's result)."""
    jmodel, params, _ = tiny
    ref = scenario(JaxGateway, JaxRolloutEngine(jmodel, params,
                                                cfg=JaxEngineConfig(**{**BASE, **kw})))
    return ref, scenario(Gateway, port_engine(tiny, **kw))


def drained(gw, rids):
    """Each rid's streamed tokens and its end record."""
    out = {}
    for r in rids:
        d = gw.drain(r)
        assert d["end"] is not None, r
        assert d["tokens"] == d["end"]["tokens"], r       # streamed == finished
        out[r] = (tuple(d["tokens"]), d["end"])
    return out


def test_gateway_requires_chunked_engine(tiny):
    with pytest.raises(ValueError, match="prefill_chunk"):
        Gateway(port_engine(tiny, prefill_chunk=0, evict="off", cache="ring"))


def preemption_scenario(with_urgent):
    def run(gateway, engine):
        gw = gateway(engine)
        rids = [gw.submit([1, 4 + i, 5, 6], priority=2) for i in range(3)]
        for _ in range(3):                 # let generation get underway
            gw.pump()
        if with_urgent:
            rids.append(gw.submit([1, 9, 5, 6], priority=0, sla=50))
        gw.run_until_idle()
        return drained(gw, rids), gw.stats()
    return run


def test_preempted_request_resumes_bit_exact(tiny):
    """An urgent arrival preempts a busy slot; every request's tokens,
    the preempted one's included, equal the run without urgent traffic,
    and both runs equal the reference's."""
    (jbase, jst0), (base, st0) = both(tiny, preemption_scenario(False))
    (jsame, jst1), (same, st1) = both(tiny, preemption_scenario(True))
    assert (base, st0) == (jbase, jst0) and (same, st1) == (jsame, jst1)
    assert st0["preemptions"] == 0
    assert st1["preemptions"] >= 1 and st1["resumes"] == st1["preemptions"]
    assert st1["completed"] == 4
    assert {r: same[r][0] for r in base} == {r: v[0] for r, v in base.items()}
    assert any(end["preempted"] for _, end in same.values())


def test_gateway_stats_and_metrics_under_preemption(tiny):
    """The stats and the online histograms through a preempt/resume
    cycle; the Prometheus text carries the reference's gateway names."""
    def run(gateway, engine):
        gw = gateway(engine)
        rids = [gw.submit([1, 4 + i, 5, 6], priority=2) for i in range(3)]
        for _ in range(3):
            gw.pump()
        rids.append(gw.submit([1, 9, 5, 6], priority=0, sla=50))
        gw.run_until_idle()
        out = drained(gw, rids)
        reg = gw.metrics_registry()
        counts = (gw._h_queue_wait.count, gw._h_ttft.count, gw._h_itl.count)
        snap = {k: v for k, v in reg.snapshot().items() if k.startswith("gateway.")}
        names = {ln.split("{")[0].split(" ")[0] for ln in gw.prometheus_text().splitlines()
                 if ln.startswith("repro_gateway_")}
        return out, gw.stats(), counts, snap, names

    want, got = both(tiny, run)
    assert got == want
    _, st, counts, snap, names = got
    assert st["preemptions"] >= 1 and st["resumes"] >= 1 and st["completed"] == 4
    assert st["queued"] == 0 and st["running"] == 0 and st["parked"] == 0
    assert st["ttft_p50"] > 0 and st["ttft_p99"] >= st["ttft_p50"]
    assert st["itl_p99"] >= st["itl_p50"] > 0
    assert counts[:2] == (4, 4) and counts[2] > 0
    assert snap["gateway.completed"] == 4.0 and snap["gateway.ttft"]["count"] == 4
    assert {"repro_gateway_preemptions", "repro_gateway_queue_wait_bucket",
            "repro_gateway_ttft_bucket"} <= names


def test_same_tier_never_preempts(tiny):
    def run(gateway, engine):
        gw = gateway(engine)
        rids = [gw.submit([1, 4 + i, 5, 6], priority=1) for i in range(4)]
        gw.run_until_idle()
        return drained(gw, rids), gw.stats()

    want, got = both(tiny, run)
    assert got == want
    assert got[1]["preemptions"] == 0 and got[1]["completed"] == 4


def lru_run(gateway, engine):
    shared = [1, 4, 5, 6]                  # one full shared block
    gw = gateway(engine, preempt=False)
    rids = []
    for i in range(6):                     # staggered: park/revive/evict
        rids.append(gw.submit(shared + [7 + i, 8, 9, 10]))
        gw.pump()
        gw.pump()
    gw.run_until_idle()
    return drained(gw, rids), gw.stats()


def test_lru_recompute_on_miss_trajectory_identity(tiny):
    """Undersized pool + LRU: evictions happen, every request completes,
    and every trajectory equals the ample pool's: recompute on a miss is
    exact."""
    (jsmall, jst_small), (small, st_small) = both(tiny, lru_run, n_blocks=9)
    (jample, jst_ample), (ample, st_ample) = both(tiny, lru_run, n_blocks=64)
    assert (small, st_small) == (jsmall, jst_small) and (ample, st_ample) == (jample, jst_ample)
    assert st_small["evictions"] > 0
    assert st_small["completed"] == 6 and st_ample["completed"] == 6
    assert {r: v[0] for r, v in small.items()} == {r: v[0] for r, v in ample.items()}


def test_gateway_pressure_leaks_no_refcounts(tiny):
    """After an undersized-pool run drains, every pool block is back to
    refcount zero and free + parked covers the whole pool."""
    def run(gateway, engine):
        gw = gateway(engine, preempt=False)
        rids = []
        for i in range(6):
            rids.append(gw.submit([1, 4, 5, 6, 7 + i, 8, 9, 10]))
            gw.pump()
        gw.run_until_idle()
        al = engine.allocator
        return (drained(gw, rids), gw.stats(), [al.refcount(b) for b in range(al.n_blocks)],
                (al.n_free, al.n_cached, al.n_blocks))

    want, got = both(tiny, run, n_slots=2, n_blocks=9)
    assert got == want
    _, st, refcounts, (n_free, n_cached, n_blocks) = got
    assert st["completed"] == 6 and not any(refcounts) and n_free + n_cached == n_blocks


def test_session_followup_extends_context_and_marks_hit(tiny):
    def run(gateway, engine):
        gw = gateway(engine)
        r1 = gw.submit([1, 4, 5], session="u")
        gw.run_until_idle()
        first = drained(gw, [r1])
        r2 = gw.submit([1, 6], session="u")
        gw.run_until_idle()
        return first, drained(gw, [r2]), dict(gw.sessions), gw.stats()

    want, got = both(tiny, run)
    assert got == want
    assert got[3]["session_hits"] == 1


def test_sla_miss_is_counted(tiny):
    def run(gateway, engine):
        gw = gateway(engine)
        rid = gw.submit([1, 4, 5, 6], sla=1)   # one tick: cannot finish
        gw.run_until_idle()
        return drained(gw, [rid]), gw.stats()

    want, got = both(tiny, run)
    assert got == want
    (_, end), = got[0].values()
    assert end["sla_missed"] is True and got[1]["sla_misses"] == 1


# ---------------------------------------------------------------------------
# HTTP front-end: concurrent streamed completions share the prefix cache
# ---------------------------------------------------------------------------

def test_http_concurrent_sessions_hit_prefix_cache(tiny):
    check_http(*http_waves(Gateway(port_engine(tiny, n_slots=4, prompt_len=12))))

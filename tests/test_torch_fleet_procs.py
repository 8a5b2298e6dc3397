"""The port's process fleet (``repro_torch.core.fleet``) with real worker
processes on the CPU: the multi-process cases of ``tests/test_fleet.py``.

* A tiny LM (2 layers, d 64) under 2 rollout workers and a trainer
  replica for 2 steps: every rid both runs consumed has the same tokens
  as under the port's ``ThreadedRuntime`` on the same seed, with at
  least one full batch in common (the reference's criterion);
  ``tests/test_torch_runtime.py`` holds that runtime against the JAX
  package's.
* A SIGKILLed worker's requests are requeued and it is respawned; a
  SIGSTOPped (hung) worker is respawned and a slow one is not; an
  elastic shrink drains with nothing unscored dropped (simulator stubs);
  a kill in the middle of a ``delta`` weight stream never applies a torn
  version.
* ``run_training(runtime="fleet", device="cpu")`` and the training
  launcher's ``--runtime fleet``.

Spawned workers import the factories below from this module, so it
imports nothing of the JAX package.  Every run is bounded by
``run(timeout=...)`` and closed in ``finally``; no assertion depends on
how soon a worker comes up.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.core.fleet import FleetRuntime, build_engine, build_trainer
from repro_torch.core.runtime import ThreadedRuntime
from repro_torch.core.scheduler import AsyncScheduler
from repro_torch.core.simulator import SimEngine, SimPromptStream, SimTrainer
from repro_torch.data import tokenizer
from repro_torch.env import (AsyncRewardService, DelayEnv, Environment, EnvPromptStream,
                             MathEnv, Verdict)
from repro_torch.launch.train import run_training

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parent.parent
RUN_TIMEOUT = 120.0
ANSWERS = 4
# one intra-op thread a worker: three processes of tiny tensors each
WORKER_ENV = {"OMP_NUM_THREADS": "1"}


def _sched(*, eta=4, batch=8, answers=ANSWERS, prompt_len=8):
    rl = RLConfig(batch_size=batch, max_staleness=eta, interruptible=True)
    return AsyncScheduler(prompt_stream=SimPromptStream(prompt_len, answers_per_prompt=answers),
                          rl=rl)


def _capture(sched):
    """Record every consumed trajectory (what actually trained)."""
    cap = []
    orig = sched.record_consumed

    def wrapper(batch):
        cap.extend(batch)
        return orig(batch)

    sched.record_consumed = wrapper
    return cap


def _once(cap):
    rids = [t.rid for t in cap]
    return len(set(rids)) == len(rids)


def _strike(rt, ready, action, deadline_s=60.0):
    """Start a thread that applies ``action(handle)`` to the first ready
    rollout worker for which ``ready(handle)`` holds; returns the dict it
    fills in."""
    hit = {}

    def run():
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and not rt._stop.is_set():
            for h in rt.registry.ready("rollout"):
                if ready(h):
                    hit.update(pid=h.proc.pid, worker_id=h.worker_id, stats=dict(h.stats))
                    action(h)
                    return
            time.sleep(0.005)

    threading.Thread(target=run, daemon=True).start()
    return hit


def _sigkill(h):
    os.kill(h.proc.pid, signal.SIGKILL)


# ---- simulator-stub workers ---------------------------------------------------

class _SlowEngine:
    """SimEngine proxy whose decode steps take wall time, so kill and
    drain windows are wide enough to hit."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self._delay_s = delay_s

    def step(self):
        time.sleep(self._delay_s)
        return self._inner.step()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def sim_engine_factory(*, n_slots=4, mean_len=12, max_len=32, prompt_len=8, seed=0,
                       slow_step_s=0.0):
    eng = SimEngine(n_slots=n_slots, mean_len=mean_len, max_len=max_len,
                    prompt_len=prompt_len, seed=seed)
    return _SlowEngine(eng, slow_step_s) if slow_step_s else eng


def sim_trainer_factory():
    return SimTrainer()


def _fleet(sched, **kw):
    defaults = dict(scheduler=sched, engine_factory=sim_engine_factory,
                    engine_factory_kwargs={"n_slots": 4},
                    trainer_factory=sim_trainer_factory,
                    trainer_factory_kwargs={}, n_slots=4, rollout_workers=2,
                    heartbeat_s=0.05, heartbeat_timeout=5.0, worker_env=WORKER_ENV)
    defaults.update(kw)
    return FleetRuntime(**defaults)


def test_sigkilled_worker_is_requeued_and_respawned(tmp_path):
    sched = _sched(eta=4, batch=8)
    cap = _capture(sched)
    rt = _fleet(sched, flightrec_dir=str(tmp_path),
                engine_factory_kwargs={"n_slots": 4, "mean_len": 16, "max_len": 48,
                                       "slow_step_s": 0.05})
    killed = _strike(rt, lambda h: h.beats > 0 and rt.sched.inflight_of(h.worker_id),
                     _sigkill)
    try:
        rt.run(3, timeout=RUN_TIMEOUT)
    finally:
        rt.close()
    assert killed, "the killer never found a worker with requests in flight"
    assert rt.respawns >= 1 and rt.requeued >= 1
    assert len(cap) == 24 and _once(cap) and rt.duplicates_dropped == 0
    assert any(e["reason"] == "crashed" for e in rt.registry.events_of("worker-dead"))
    # the SIGKILL post-mortem: the victim's recorder tail, shipped on its
    # heartbeats, outlives it and is dumped on failure
    victim = killed["worker_id"]
    assert "start" in {e[2] for e in rt.flight_recorder(victim).tail(256)}
    events = json.loads((tmp_path / f"{victim}-crashed.json").read_text())
    assert events and events[0]["kind"] == "start"
    # every process reported its launches and its threads to the end
    assert all(h.last_stats.get("threads") == 1 for h in rt.registry.workers()
               if h.last_stats)


def test_hung_worker_is_respawned():
    # SIGSTOP keeps the process alive but silent; the supervisor
    # diagnoses 'hung' and forces it out (SIGKILL works on a stopped one)
    sched = _sched(eta=4, batch=8)
    rt = _fleet(sched, engine_factory_kwargs={"n_slots": 4, "mean_len": 16, "max_len": 48,
                                              "slow_step_s": 0.05},
                heartbeat_timeout=1.0)
    stopped = _strike(rt, lambda h: h.beats > 5,
                      lambda h: os.kill(h.proc.pid, signal.SIGSTOP))
    try:
        rt.run(2, timeout=RUN_TIMEOUT)
    finally:
        rt.close()
    assert stopped, "the stopper never found a beating worker"
    assert any(e.get("hung") for e in rt.registry.events_of("worker-dead"))
    assert rt.respawns >= 1


def test_slow_but_alive_worker_is_not_respawned():
    # a step takes a quarter of the heartbeat timeout and an episode
    # several of them, but the beat thread keeps beating
    sched = _sched(eta=4, batch=4, answers=2)
    rt = _fleet(sched, rollout_workers=1, heartbeat_timeout=1.0,
                engine_factory_kwargs={"n_slots": 2, "mean_len": 8, "max_len": 10,
                                       "slow_step_s": 0.25})
    try:
        rt.run(1, timeout=RUN_TIMEOUT)
    finally:
        rt.close()
    assert rt.respawns == 0 and rt.registry.events_of("worker-dead") == []


class _AlwaysRight(Environment):
    name = "always-right"

    def verify(self, fin) -> Verdict:
        return Verdict(ok=True)


def test_elastic_shrink_drains_with_nothing_unscored_dropped():
    rl = RLConfig(batch_size=8, max_staleness=8, interruptible=True)
    svc = AsyncRewardService(DelayEnv(_AlwaysRight(), 0.10), n_workers=1, max_backlog=4)
    sched = AsyncScheduler(prompt_stream=SimPromptStream(8, answers_per_prompt=ANSWERS),
                           rl=rl, reward_service=svc)
    cap = _capture(sched)
    rt = _fleet(sched, rollout_workers=2, elastic=True, min_workers=1, elastic_interval=0.1,
                engine_factory_kwargs={"n_slots": 4, "mean_len": 10, "max_len": 16,
                                       "slow_step_s": 0.01})
    try:
        rt.run(3, timeout=RUN_TIMEOUT)
    finally:
        rt.close()
        svc.close()
    assert rt.registry.events_of("shrink"), "the reward backlog never triggered a shrink"
    assert len(cap) == 24 and _once(cap)
    st = svc.stats()
    assert st["n_scored"] == st["n_submitted"]     # every delivery was scored


# ---- a tiny real model ------------------------------------------------------------

TINY = ModelConfig(name="fleet-tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=tokenizer.VOCAB_SIZE)


def _tiny_rl(eta=2):
    # lr=0: the AdamW update is exactly zero, so the weights are bitwise
    # stable across versions and per-request RNG makes every rid's tokens
    # a function of (seed, rid): any executor, interleaving, interrupt
    # point or staleness bound gives the same trajectories
    return RLConfig(batch_size=4, answers_per_prompt=2, max_staleness=eta, interruptible=True,
                    ppo_minibatches=1, microbatch_token_budget=64, lr=0.0,
                    max_prompt_len=16, max_gen_len=8)


def tiny_engine_factory(*, seed=0, n_slots=2):
    return build_engine(model_cfg=TINY, seed=seed, device="cpu",
                        engine_kwargs=dict(n_slots=n_slots, prompt_len=16, max_gen_len=8,
                                           rng="request"))


def tiny_trainer_factory(*, seed=0):
    return build_trainer(model_cfg=TINY, rl=_tiny_rl(), seed=seed, device="cpu")


def _math_sched(rl):
    return AsyncScheduler(prompt_stream=EnvPromptStream(MathEnv(seed=3, max_operand=9),
                                                        answers_per_prompt=2),
                          rl=rl, env=MathEnv(seed=3, max_operand=9))


def _by_rid(cap):
    return {t.rid: (tuple(t.prompt_tokens), tuple(t.response_tokens)) for t in cap}


_REF = {}


def _threaded_reference():
    """Consumed trajectories of a ThreadedRuntime on the same seed and
    settings, in this process (computed once)."""
    if not _REF:
        sched = _math_sched(_tiny_rl())
        cap = _capture(sched)
        rt = ThreadedRuntime(engine=tiny_engine_factory(), trainer=tiny_trainer_factory(),
                             scheduler=sched)
        rt.run(2, timeout=RUN_TIMEOUT)
        _REF.update(_by_rid(cap))
    return _REF


def _tiny_fleet(eta=2, **kw):
    sched = _math_sched(_tiny_rl(eta))
    cap = _capture(sched)
    rt = FleetRuntime(scheduler=sched, engine_factory=tiny_engine_factory,
                      engine_factory_kwargs={}, trainer_factory=tiny_trainer_factory,
                      trainer_factory_kwargs={}, n_slots=2, rollout_workers=2,
                      heartbeat_s=0.05, heartbeat_timeout=30.0, worker_env=WORKER_ENV, **kw)
    return rt, cap


def _agree(ref, got, min_common):
    common = set(ref) & set(got)
    assert len(common) >= min_common
    for rid in sorted(common):
        assert ref[rid] == got[rid], f"rid {rid} diverged"


def test_fleet_trajectories_match_threaded_same_seed():
    ref = _threaded_reference()
    rt, cap = _tiny_fleet()
    try:
        rt.run(2, timeout=RUN_TIMEOUT)
    finally:
        rt.close()
    got = _by_rid(cap)
    assert len(got) == 8                          # 2 steps x B=4
    _agree(ref, got, 4)                           # at least one full batch in common
    trainer = [h for h in rt.registry.workers("trainer")][0].last_stats
    assert trainer["steps"] == 2 and len(trainer["step_s"]) == 2
    assert rt.trainer.version == 2 and set(rt.trainer.params) == set(
        tiny_trainer_factory().model.state_dict())


def test_kill_mid_weight_stream_never_applies_a_torn_version():
    """SIGKILL a worker that has received some, not all, chunks of a
    publication stream: the partial version dies with it, its
    replacement starts from the supervisor's full weights, and every
    delivered trajectory equals the threaded run's.  Chunks of 64
    elements fed one a decode step make v1's base-free stream hundreds
    of steps long, and eta 4 keeps requests in flight when it arrives:
    'mid-stream' is a wide window."""
    ref = _threaded_reference()
    rt, cap = _tiny_fleet(eta=4, weight_stream="delta", stream_chunk_elems=64,
                          stream_chunks_per_step=1)
    killed = _strike(rt, lambda h: (h.stats.get("stream_chunks_received", 0) >= 1
                                    and h.stats.get("stream_active", 0)
                                    and rt.sched.inflight_of(h.worker_id)), _sigkill)
    try:
        rt.run(3, timeout=RUN_TIMEOUT)
    finally:
        rt.close()
    assert killed, "the killer never saw a worker mid-stream"
    assert killed["stats"]["stream_chunks_received"] >= 1
    assert _once(cap) and rt.duplicates_dropped == 0
    _agree(ref, _by_rid(cap), 1)


# ---- the launcher ---------------------------------------------------------------

def test_run_training_fleet_on_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the workers' intra-op threads
    ctl, trainer, _ = run_training(steps=2, device="cpu", runtime="fleet", batch_size=8,
                                   answers_per_prompt=4, n_slots=8, log_every=1 << 30,
                                   run_timeout=RUN_TIMEOUT)
    assert [h.version for h in ctl.history] == [1, 2]
    assert max(h.staleness_max for h in ctl.history) <= 4
    assert ctl.buffer.total_consumed == 16 and ctl.respawns == 0
    assert trainer.version == 2 and ctl.final_eval.n == 64
    rollout = [h.last_stats for h in ctl.registry.workers("rollout") if h.last_stats]
    # on the CPU no kernel launches; every process reports its own peak RSS
    assert rollout and all(st["launches.flash_attention"] == 0 for st in rollout)
    assert all(st["peak_rss_bytes"] > 0 for st in rollout)
    assert sum(st["tokens_generated"] for st in rollout) > 0


def test_train_launcher_runs_the_fleet(tmp_path):
    """The launcher's flags are ``launch/cli.py``'s, the reference's
    (``--runtime fleet``, ``--metrics-snapshot``), and it prints the
    fleet's fields."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    snap = tmp_path / "metrics.json"
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--runtime",
                          "fleet", "--device", "cpu", "--steps", "1", "--batch-size", "8",
                          "--slots", "8", "--no-final-eval", "--run-timeout",
                          str(RUN_TIMEOUT), "--metrics-snapshot", str(snap)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=RUN_TIMEOUT + 30)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["runtime"] == "fleet" and rec["steps"] == 1
    assert rec["respawns"] == 0 and rec["requeued"] >= 0 and rec["fleet_events"] >= 3
    assert rec["metrics"] == str(snap) and "scheduler" in snap.read_text()

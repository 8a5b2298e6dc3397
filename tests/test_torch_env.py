"""The port's environments and async reward service (``repro_torch.env``)
against the JAX package's (``repro.env``, which needs no JAX itself).

The verdicts of ``MathEnv`` and ``CodeEnv`` (its sandboxed subprocess
included) equal the reference's on the same ``Finished``; both sample
the same tasks from a seed; the reward service scores off the caller's
thread and the scheduler buffers a trajectory only once it is scored;
and the threaded runtime stays live with a slow verifier and fails fast
with a hanging one (``tests/test_env.py``'s cases, on the port).
"""
import time

import pytest

from repro.core.rollout import Finished as JFinished
from repro.env import CodeEnv as JCodeEnv
from repro.env import CodeTaskGenerator as JCodeTaskGenerator
from repro.env import MathEnv as JMathEnv
from repro_torch.configs.base import RLConfig
from repro_torch.core.rollout import Finished
from repro_torch.core.runtime import ThreadedRuntime
from repro_torch.core.scheduler import AsyncScheduler
from repro_torch.core.simulator import SimEngine, SimPromptStream, SimTrainer
from repro_torch.data import tokenizer
from repro_torch.env import (AsyncRewardService, CodeEnv, CodeTaskGenerator, DelayEnv,
                             Environment, EnvPromptStream, MathEnv, make_env, run_snippet)
from repro_torch.launch.train import run_training


def _fins(rid, response_text, answer, prompt_text="<q> 1 + 1 = ?"):
    """The same finished generation as the port's and the reference's."""
    kw = dict(rid=rid, prompt_id=rid, prompt=tokenizer.encode(prompt_text, bos=True),
              response=tokenizer.encode(response_text), logprobs=[0.0], versions=[0],
              behavior_version=0, answer=answer, submit_time=0.0, truncated=False)
    return Finished(**kw), JFinished(**kw)


MATH_CASES = [("= 7", 7), ("= 07", 7), ("=7", 7), ("the sum = 12", 12), ("= 12 = 3", 3),
              ("= -4", -4), ("", 5), ("= 99999", 3), ("=", 0), ("= 5", None)]


@pytest.mark.parametrize("text,answer", MATH_CASES)
def test_math_env_verdicts_equal_the_reference(text, answer):
    mine, theirs = _fins(0, text, answer)
    got, want = MathEnv(seed=1).verify(mine), JMathEnv(seed=1).verify(theirs)
    assert (got.ok, got.info) == (want.ok, want.info)


CODE_CASES = [("x * 3 + 2", "x * 3 + 2"), ("2 + x * 3", "x * 3 + 2"), ("x * 3", "x * 3 + 2"),
              ("__import__('os')", "x * 1 + 0"), ("x *", "x * 2 + 1"), ("", "x * 2 + 1")]


@pytest.mark.parametrize("text,answer", CODE_CASES)
def test_code_env_verdicts_equal_the_reference(text, answer):
    mine, theirs = _fins(0, text, answer, prompt_text="<q> code f(x) = ?")
    got, want = CodeEnv(seed=1).verify(mine), JCodeEnv(seed=1).verify(theirs)
    assert (got.ok, got.info) == (want.ok, want.info)


def test_code_sandbox_kills_a_spinning_snippet():
    v = run_snippet("[i for i in range(10 ** 12)]", [(1, 1)], timeout_s=0.5)
    assert not v.ok and v.info["reason"] in ("timeout", "failed-tests")


@pytest.mark.parametrize("seed", [1, 4])
def test_environments_sample_the_reference_tasks(seed):
    for mine, theirs in ((MathEnv(seed=seed, max_operand=9), JMathEnv(seed=seed, max_operand=9)),
                         (CodeTaskGenerator(seed=seed), JCodeTaskGenerator(seed=seed))):
        for _ in range(5):
            a, b = mine.sample(), theirs.sample()
            assert (a.pid, a.prompt_text, a.answer, list(a.prompt_tokens)) == \
                (b.pid, b.prompt_text, b.answer, list(b.prompt_tokens))


def test_env_prompt_stream_groups():
    s = EnvPromptStream(MathEnv(seed=1), answers_per_prompt=3)
    assert [s.next_request()[1] for _ in range(9)] == [0] * 3 + [1] * 3 + [2] * 3


def test_make_env_factory_and_the_multiturn_refusal():
    """Every ``--env`` name builds (the multi-turn environment, refused
    until the engine had its continuation, included); others refuse."""
    from repro_torch.env import MultiTurnEnv
    assert isinstance(make_env("math"), MathEnv)
    assert isinstance(make_env("code"), CodeEnv)
    assert isinstance(make_env("multiturn"), MultiTurnEnv)
    with pytest.raises(ValueError):
        make_env("nope")
    assert MathEnv().continuation_hook() is None and CodeEnv().continuation_hook() is None


# ---- AsyncRewardService -------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.got = []

    def deposit_scored(self, fin, verdict, finish_time):
        self.got.append((fin.rid, verdict.ok, finish_time))


def test_service_scores_off_caller_thread_and_close_drains():
    env = MathEnv(seed=5)
    svc = AsyncRewardService(DelayEnv(env, 0.2), n_workers=3, max_backlog=8)
    sink = _Sink()
    svc.bind(sink)
    fins = []
    for i in range(9):
        p = env.sample()
        fins.append(_fins(i, f"= {p.answer}", p.answer)[0])
    t0 = time.perf_counter()
    svc.submit(fins, finish_time=1.5)
    assert time.perf_counter() - t0 < 0.15    # enqueue only
    assert svc.close()
    assert sorted(r for r, _, _ in sink.got) == list(range(9))
    assert all(ok and ft == 1.5 for _, ok, ft in sink.got)
    st = svc.stats()
    assert st["n_scored"] == 9 and st["backlog"] == 0
    assert st["per_env"]["delay(math)"]["mean_s"] >= 0.2


def test_service_verify_exception_scores_as_miss():
    class Boom(Environment):
        name = "boom"

        def verify(self, fin):
            raise RuntimeError("verifier crashed")

    svc = AsyncRewardService(Boom(), n_workers=1)
    sink = _Sink()
    svc.bind(sink)
    svc.submit([_fins(0, "x", "1")[0]], 0.0)
    assert svc.close()
    assert sink.got == [(0, False, 0.0)] and svc.errors == []


def test_async_scoring_buffers_only_once_scored():
    env = MathEnv(seed=5)
    svc = AsyncRewardService(DelayEnv(env, 0.3), n_workers=1)
    rl = RLConfig(batch_size=8, max_staleness=1, interruptible=True)
    sched = AsyncScheduler(prompt_stream=SimPromptStream(16), rl=rl, env=env,
                           reward_service=svc)
    p = env.sample()
    sched.collect([_fins(0, f"= {p.answer}", p.answer)[0]], finish_time=2.0)
    assert len(sched.buffer) == 0 and sched.pending_rewards() == 1
    assert svc.close()
    assert len(sched.buffer) == 1 and sched.pending_rewards() == 0
    assert sched.buffer.pop_batch(1)[0].reward == sched.reward.reward_correct


# ---- the threaded runtime with reward workers ------------------------------------------

def _threaded(env, *, workers, backlog=32, eta=4, batch=16, n_slots=16):
    rl = RLConfig(batch_size=batch, max_staleness=eta, interruptible=True)
    eng = SimEngine(n_slots=n_slots, mean_len=30, max_len=2048, prompt_len=64, seed=7)
    svc = AsyncRewardService(env, n_workers=workers, max_backlog=backlog)
    sched = AsyncScheduler(prompt_stream=SimPromptStream(64), rl=rl, reward_service=svc)
    return ThreadedRuntime(engine=eng, trainer=SimTrainer(), scheduler=sched), svc


def test_threaded_runtime_with_slow_verifier_stays_live():
    rt, svc = _threaded(DelayEnv(MathEnv(seed=1), 0.02), workers=4)
    hist = rt.run(3, timeout=120)
    assert [h.version for h in hist] == [1, 2, 3]
    assert rt.buffer.total_consumed == 3 * 16
    st = svc.stats()
    assert st["n_scored"] >= rt.buffer.total_consumed
    assert st["backlog_peak"] <= st["max_backlog"] + 16
    assert svc.close() and svc.backlog() == 0


def test_threaded_runtime_hanging_verifier_fails_fast_not_deadlocks():
    rt, svc = _threaded(DelayEnv(MathEnv(seed=1), 3600.0), workers=1, backlog=4)
    with pytest.raises(TimeoutError) as ei:
        rt.run(1, timeout=1.5)
    assert "unscored=" in str(ei.value)
    assert not rt.buffer.closed
    assert not svc.close(timeout=0.2)


def test_run_training_scores_on_reward_workers():
    ctl, trainer, _ = run_training(steps=2, runtime="threaded", env="math", reward_workers=2,
                                   device="cpu", final_eval=False, run_timeout=120,
                                   log_every=1 << 30)
    svc = ctl.sched.reward_service
    assert isinstance(svc, AsyncRewardService) and isinstance(ctl.sched.env, MathEnv)
    assert svc.stats()["n_scored"] >= ctl.buffer.total_consumed == 2 * 32
    assert svc.close()
    assert trainer.version == 2


def test_run_training_refuses_reward_workers_off_the_threaded_runtime():
    with pytest.raises(ValueError, match="reward_latency"):
        run_training(steps=1, reward_workers=2, device="cpu")

"""The port's virtual-clock training loop against the JAX reference.

The modules the loop carries over (tasks, prompt stream, reward,
staleness, timing model, scheduler, controller) are copies: each is held
against its original, both imported.  The port's ``AsyncRLController``
driving the port's simulator stubs must log the same ``StepLog``s as the
reference's controller driving the reference's stubs.  ``ParameterStore``
keeps a copy of what it publishes.  Then ``run_training`` at the
quickstart's settings (3 steps, seed 1) on the CPU, started from
``params_from_jax`` of the reference's init and fed the reference's
Gumbel noise, against a live run of the reference: the batches each
trainer consumed token for token (behavior logprobs to 1e-4), the integer
``StepLog`` fields, rewards and accuracy exactly, the virtual clock to
1e-9 relative, the loss to 1e-5 (``test_torch_trainer.py``'s metric
tolerance), the staleness histogram and the final eval exactly.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import RLConfig as JaxRLConfig
from repro.core import controller as jctl
from repro.core import reward as jreward
from repro.core import simulator as jsim
from repro.core import staleness as jstal
from repro.core.trainer import PPOTrainer as JaxPPOTrainer
from repro.data import dataset as jdataset
from repro.data import tasks as jtasks
from repro.launch.train import run_training as jax_run_training
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core import controller as tctl
from repro_torch.core import reward as treward
from repro_torch.core import simulator as tsim
from repro_torch.core import staleness as tstal
from repro_torch.core.buffer import Trajectory
from repro_torch.core.trainer import PPOTrainer
from repro_torch.core.weights import ParameterStore, VersionEvicted
from repro_torch.data import dataset as tdataset
from repro_torch.data import tasks as ttasks
from repro_torch.data import tokenizer
from repro_torch.launch.train import run_training
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

QUICKSTART = dict(steps=3, eta=4, batch_size=32, answers_per_prompt=4, n_slots=16,
                  max_operand=9, lr=3e-4, seed=1)


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


def gumbel_of(seed):
    """The reference engine's Gumbel noise for step counter ``step``."""
    key = jax.random.key(seed)

    def noise(step, shape):
        g = jax.random.gumbel(jax.random.fold_in(key, step), shape, jnp.float32)
        return torch.from_numpy(np.array(g))
    return noise


# ---------------------------------------------------------------------------
# the carried-over modules against their originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n_ops", [1, 2])
def test_prompt_stream_and_task_generator_agree(seed, n_ops):
    jg = jtasks.MathTaskGenerator(seed=seed, max_operand=9, n_ops=n_ops)
    tg = ttasks.MathTaskGenerator(seed=seed, max_operand=9, n_ops=n_ops)
    for _ in range(50):
        a, b = jg.sample(), tg.sample()
        assert (a.pid, a.prompt_text, a.answer, a.prompt_tokens) == \
            (b.pid, b.prompt_text, b.answer, b.prompt_tokens)
    js = jdataset.PromptStream(seed=seed, answers_per_prompt=4, max_operand=20, n_ops=n_ops)
    ts = tdataset.PromptStream(seed=seed, answers_per_prompt=4, max_operand=20, n_ops=n_ops)
    for _ in range(60):
        (jp, jgid), (tp, tgid) = js.next_request(), ts.next_request()
        assert (jgid, jp.prompt_text, jp.answer) == (tgid, tp.prompt_text, tp.answer)


VERIFY_TABLE = [("7", "7"), ("7", "8"), ("-3", "-3"), ("3 + 4 = 7", "7"), ("3 + 4 = 8", "7"),
                ("3 + 4 = ?", "7"), ("the answer is 12.", "12"), ("", "0"), ("x", "0"),
                ("= = 5", "5"), ("12 13", "13"), ("007", "7"), ("4-2", "4"), ("= -2", "-2")]


@pytest.mark.parametrize("text,answer", VERIFY_TABLE)
def test_verify_agrees(text, answer):
    assert ttasks.verify(text, answer) == jtasks.verify(text, answer)
    assert ttasks.extract_answer(text) == jtasks.extract_answer(text)


def test_reward_service_stats_agree():
    rng = np.random.default_rng(0)
    js, ts = jreward.RewardService(recent_window=16), treward.RewardService(recent_window=16)
    for _ in range(60):
        answer = str(int(rng.integers(-5, 20)))
        if rng.random() < 0.4:
            resp = tokenizer.encode(answer)
        else:
            resp = rng.integers(3, tokenizer.VOCAB_SIZE, int(rng.integers(0, 8))).tolist()
        ans = None if rng.random() < 0.1 else answer
        assert ts.score(resp, ans) == js.score(resp, ans)
    assert ts.record(True) == js.record(True)
    for attr in ("n_evaluated", "n_correct", "accuracy", "recent_accuracy"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert list(ts.recent) == list(js.recent)
    assert js.n_correct > 0


@pytest.mark.parametrize("eta", [0, 2, math.inf])
def test_staleness_controller_admissions_agree(eta):
    rng = np.random.default_rng(5)
    jc = jstal.StalenessController(batch_size=4, max_staleness=eta)
    tc = tstal.StalenessController(batch_size=4, max_staleness=eta)
    js, ts = jstal.StalenessStats(), tstal.StalenessStats()
    version = 0
    for _ in range(300):
        op = rng.integers(0, 4)
        if op < 2:
            n = int(rng.integers(1, 4))
            assert tc.can_submit(n) == jc.can_submit(n)
            assert tc.submit(n) == jc.submit(n)
        elif op == 2:
            version += 1
            jc.on_policy_update(version)
            tc.on_policy_update(version)
        else:
            b = int(rng.integers(0, version + 1))
            s = tc.sample_staleness(b)
            assert s == jc.sample_staleness(b)
            js.record(s)
            ts.record(s)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (ts.histogram(), ts.mean, ts.max) == (js.histogram(), js.mean, js.max)


@pytest.mark.parametrize("colocated", [False, True])
def test_llm_timing_costs_agree_exactly(colocated):
    n_params = float(get_model_config("areal-qwen-1.5b").param_count())
    assert n_params == float(jax_config("areal-qwen-1.5b").param_count())
    kw = dict(n_gen_devices=128 if colocated else 96,
              n_train_devices=128 if colocated else 32, colocated=colocated)
    jt = jsim.make_llm_timing(jsim.HardwareModel(), jsim.WorkloadModel(n_params=n_params), **kw)
    tt = tsim.make_llm_timing(tsim.HardwareModel(), tsim.WorkloadModel(n_params=n_params), **kw)
    assert (tt.weight_sync, tt.colocated, tt.reward_latency) == \
        (jt.weight_sync, jt.colocated, jt.reward_latency)
    for n in (0, 1, 7, 16, 96, 97, 1000, 100_000):
        assert tt.decode_step(n) == jt.decode_step(n)
        assert tt.prefill(n) == jt.prefill(n)
        assert tt.train_step(n) == jt.train_step(n)


@pytest.mark.parametrize("eta,interruptible", [(4, True), (0, True), (2, False)])
def test_controller_over_simulator_stubs_logs_the_same_steps(eta, interruptible):
    """The controller's logic with no model: the same stubs, the same
    timing model, the same StepLogs."""
    def run(sim, ctl_mod, rl_cls):
        rl = rl_cls(batch_size=16, answers_per_prompt=4, max_staleness=eta,
                    interruptible=interruptible)
        timing = sim.make_llm_timing(sim.HardwareModel(), sim.WorkloadModel(n_params=1.5e9),
                                     n_gen_devices=96, n_train_devices=32)
        timing.reward_latency = 0.002
        ctl = ctl_mod.AsyncRLController(
            engine=sim.SimEngine(n_slots=12, mean_len=40, max_len=120, seed=3),
            trainer=sim.SimTrainer(), rl=rl, timing=timing,
            prompt_stream=sim.SimPromptStream(prompt_len=64, answers_per_prompt=4))
        ctl.run(6)
        return ctl
    jc = run(jsim, jctl, JaxRLConfig)
    tc = run(tsim, tctl, RLConfig)
    assert len(tc.history) == 6
    assert [dataclasses.asdict(h) for h in tc.history] == \
        [dataclasses.asdict(h) for h in jc.history]
    assert (tc.clock, tc.stal_stats.histogram(), tc.engine.interruptions) == \
        (jc.clock, jc.stal_stats.histogram(), jc.engine.interruptions)
    assert tc.effective_throughput() == jc.effective_throughput()


# ---------------------------------------------------------------------------
# ParameterStore
# ---------------------------------------------------------------------------

def _small_lm(seed=0):
    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                              vocab_size=tokenizer.VOCAB_SIZE)
    return build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))


def _trajectories(n=8, group=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rlen = int(rng.integers(3, 12))
        out.append(Trajectory(
            rid=i, prompt_id=i // group,
            prompt_tokens=rng.integers(3, tokenizer.VOCAB_SIZE, 6).tolist(),
            response_tokens=rng.integers(3, tokenizer.VOCAB_SIZE, rlen).tolist(),
            behav_logprobs=(-4 * rng.random(rlen)).tolist(), versions=[0] * rlen,
            behavior_version=0, reward=float(i % 2)))
    return out


def test_published_version_is_unchanged_by_later_train_steps():
    """The trainer updates its LM in place: the store must hold a copy."""
    model = _small_lm()
    trainer = PPOTrainer(model, RLConfig(batch_size=2, answers_per_prompt=4, lr=1e-2,
                                         microbatch_token_budget=64, ppo_minibatches=2))
    store = ParameterStore()
    seen = []
    store.subscribe(lambda v, w: seen.append((v, w)))
    store.publish(0, trainer.params)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    trainer.train_step(_trajectories())
    snap = store.get(0)
    assert set(snap) == set(before)
    for name, t in snap.items():
        torch.testing.assert_close(t, before[name], rtol=0, atol=0)
    moved = [n for n, t in model.state_dict().items() if not torch.equal(t, before[n])]
    assert "embed.table" in moved and len(moved) > len(before) // 2
    assert seen == [(0, snap)] and store.latest() == (0, snap)


def test_store_keeps_two_versions_and_evicts_loudly():
    model = _small_lm()
    store = ParameterStore(keep=2)
    for v in range(1, 5):
        with torch.no_grad():
            model.embed.table.fill_(float(v))
        store.publish(v, model)
    assert store.publishes == 4 and store.latest()[0] == 4
    assert store.get(3)["embed.table"].flatten()[0].item() == 3.0
    assert store.get(4)["embed.table"].flatten()[0].item() == 4.0
    for v in (1, 2):
        with pytest.raises(VersionEvicted):
            store.get(v)
    assert store.get(9) is None


# ---------------------------------------------------------------------------
# run_training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(env="multiturn"), dict(fused_decode="fused"),
                                dict(spec_decode=2)],
                         ids=lambda kw: next(iter(kw)) + "=" + str(next(iter(kw.values()))))
def test_run_training_refuses_later_slices(kw):
    """What earlier parts of the port refused now runs one small step:
    the multi-turn environment (its continuation turns chunked prefill
    on), the fused decode tail (on the paged cache) and speculative
    decoding, which forces greedy sampling.  The speculative step is held
    against a live run of the reference from the same weights: its
    ``StepLog`` equal, the loss within 1e-5."""
    small = dict(steps=1, batch_size=8, answers_per_prompt=4, n_slots=8, log_every=1 << 30,
                 final_eval=False)
    if "spec_decode" in kw:
        ref, _, _ = jax_run_training("areal-qwen-1.5b", seed=1, **small, **kw)
        jcfg = dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")),
                                   vocab_size=tokenizer.VOCAB_SIZE)
        params = jax_build_model(jcfg, remat=False).init(jax.random.key(1))
        tcfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                                   vocab_size=tokenizer.VOCAB_SIZE)
        tcfg = dataclasses.replace(tcfg, name=tcfg.name + "-math")
        model = params_from_jax(tcfg, flat_params(params), device="cpu")
        ctl, _, _ = run_training(device="cpu", seed=1, model=model, **small, **kw)
        eng = ctl.engine
        assert (eng.spec_decode, eng.temperature) == (2, 0.0) and eng.spec_rounds > 0
        got, want = ctl.history, ref.history
        assert [tuple(getattr(h, f) for f in INT_FIELDS) for h in got] == \
            [tuple(getattr(h, f) for f in INT_FIELDS) for h in want]
        assert [(h.reward_mean, h.accuracy) for h in got] == \
            [(h.reward_mean, h.accuracy) for h in want]
        assert got[0].clock == pytest.approx(want[0].clock, rel=1e-9, abs=0)
        np.testing.assert_allclose([h.loss for h in got], [h.loss for h in want], atol=1e-5)
        return
    ctl, _, _ = run_training(device="cpu", **small, **kw)
    assert [h.version for h in ctl.history] == [1]
    eng = ctl.engine
    if "env" in kw:
        assert eng.continuation is not None and eng.prefill_chunk == 24
    else:
        assert (eng.cache_mode, eng.fused_decode) == ("paged", "fused")


def _recording(train_step, into):
    """``train_step``, recording each batch it trains on."""
    def recorded(self, batch, *a, **kw):
        into.append([(t.rid, t.prompt_id, list(t.prompt_tokens), list(t.response_tokens),
                      list(t.versions), t.behavior_version, t.reward,
                      list(t.behav_logprobs)) for t in batch])
        return train_step(self, batch, *a, **kw)
    return recorded


@pytest.fixture(scope="module")
def runs():
    """The reference's run_training and the port's at the quickstart's
    settings for 3 steps, from the same weights and the same noise, with
    the batches each trainer was given."""
    batches = {"ref": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        for cls, side in ((JaxPPOTrainer, "ref"), (PPOTrainer, "port")):
            mp.setattr(cls, "train_step", _recording(cls.train_step, batches[side]))
        ref_ctl, _, ref_reward = jax_run_training("areal-qwen-1.5b", **QUICKSTART)
        jcfg = dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")),
                                   vocab_size=tokenizer.VOCAB_SIZE)
        jcfg = dataclasses.replace(jcfg, name=jcfg.name + "-math")
        tcfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                                   vocab_size=tokenizer.VOCAB_SIZE)
        tcfg = dataclasses.replace(tcfg, name=tcfg.name + "-math")
        # the reference's run_training initialises its params this way
        params = jax_build_model(jcfg, remat=False).init(jax.random.key(QUICKSTART["seed"]))
        model = params_from_jax(tcfg, flat_params(params), device="cpu")
        ctl, trainer, reward = run_training("areal-qwen-1.5b", device="cpu", model=model,
                                            noise=gumbel_of(QUICKSTART["seed"]), **QUICKSTART)
    return dict(ref=ref_ctl, ref_reward=ref_reward, ctl=ctl, trainer=trainer, reward=reward,
                batches=batches)


def test_trained_batches_are_token_identical(runs):
    """Every trajectory each trainer consumed: the same tokens, version
    tags and rewards; behavior logprobs within 1e-4, as in
    ``test_torch_rollout.py``."""
    ref, port = runs["batches"]["ref"], runs["batches"]["port"]
    assert len(port) == len(ref) == QUICKSTART["steps"]
    for want_batch, got_batch in zip(ref, port):
        assert [t[:7] for t in got_batch] == [t[:7] for t in want_batch]
        for want, got in zip(want_batch, got_batch):
            np.testing.assert_allclose(got[7], want[7], atol=1e-4, rtol=1e-4)


INT_FIELDS = ("version", "n_tokens", "gen_tokens_total", "interruptions", "staleness_max")


def test_step_logs_integer_fields_match(runs):
    got = [tuple(getattr(h, f) for f in INT_FIELDS) for h in runs["ctl"].history]
    want = [tuple(getattr(h, f) for f in INT_FIELDS) for h in runs["ref"].history]
    assert got == want
    assert [h.version for h in runs["ctl"].history] == [1, 2, 3]
    assert runs["trainer"].version == 3


def test_step_logs_rewards_and_staleness_match(runs):
    for got, want in zip(runs["ctl"].history, runs["ref"].history, strict=True):
        assert (got.reward_mean, got.accuracy, got.staleness_mean) == \
            (want.reward_mean, want.accuracy, want.staleness_mean), got.version
    assert runs["ctl"].stal_stats.histogram() == runs["ref"].stal_stats.histogram()
    assert runs["reward"].recent_accuracy == runs["ref_reward"].recent_accuracy


def test_step_logs_virtual_clock_matches(runs):
    for got, want in zip(runs["ctl"].history, runs["ref"].history, strict=True):
        assert got.clock == pytest.approx(want.clock, rel=1e-9, abs=0)
    assert runs["ctl"].clock == pytest.approx(runs["ref"].clock, rel=1e-9, abs=0)


def test_step_logs_loss_matches(runs):
    losses = [h.loss for h in runs["ctl"].history]
    np.testing.assert_allclose(losses, [h.loss for h in runs["ref"].history], rtol=0, atol=1e-5)
    # some group got a right answer, so GRPO's advantages are not all 0
    assert any(abs(x) > 1e-4 for x in losses)
    for got, want in zip(runs["ctl"].history, runs["ref"].history, strict=True):
        assert set(got.diag) == set(want.diag)
        for k in got.diag:
            np.testing.assert_allclose(got.diag[k], want.diag[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_final_eval_matches(runs):
    got, want = runs["ctl"].final_eval, runs["ref"].final_eval
    assert (got.n, got.n_correct, got.mean_len) == (want.n, want.n_correct, want.mean_len)

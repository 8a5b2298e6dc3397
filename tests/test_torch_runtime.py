"""The port's threaded runtime (``repro_torch.core.runtime``) against the
JAX reference's.

* Over the port's simulator stubs, the cases of ``tests/test_runtime.py``:
  a threaded run consumes every trajectory once within the staleness
  slack, resumes, fails fast at its deadline with per-role liveness, and
  shares its engine with ``run_serial``.
* On the port's real engine and trainer (2 layers, d 48), the invariants
  ``tests/test_disaggregated.py`` holds threaded and virtual runs to.
* ``run_serial`` — deterministic, unlike ``run`` — against the
  reference's ``run_serial`` from the same weights (``params_from_jax``)
  and the same Gumbel noise, under ``weight_stream`` "full" and "delta":
  the batches each trainer consumed token for token, the integer StepLog
  fields and rewards exactly, losses within 1e-5.  No wall-clock field
  is compared.
* ``run_training(runtime="threaded")`` on the CPU, the launch counters
  under two threads, and no device-wide synchronise anywhere in the port.
"""
import ast
import os
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RLConfig as JRLConfig
from repro.core import AsyncScheduler as JAsyncScheduler
from repro.core import EngineConfig as JEngineConfig
from repro.core import PPOTrainer as JPPOTrainer
from repro.core import RolloutEngine as JRolloutEngine
from repro.core import ThreadedRuntime as JThreadedRuntime
from repro.data.dataset import PromptStream as JPromptStream
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.core.config import EngineConfig
from repro_torch.core.controller import AsyncRLController, TimingModel
from repro_torch.core.rollout import RolloutEngine
from repro_torch.core.runtime import (Executor, RoleLiveness, ThreadedRuntime,
                                      format_liveness)
from repro_torch.core.scheduler import AsyncScheduler
from repro_torch.core.simulator import SimEngine, SimPromptStream, SimTrainer
from repro_torch.core.trainer import PPOTrainer
from repro_torch.data import tokenizer
from repro_torch.data.dataset import PromptStream
from repro_torch.kernels import ops
from repro_torch.launch.disaggregated import split_devices
from repro_torch.launch.train import run_training
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread each, so this file does not
    crowd the processes that other test files run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- over the simulator's stubs ----------------------------------------------

def _sim_parts(*, eta=4, batch=64, n_slots=64, mean_len=200, seed=7):
    rl = RLConfig(batch_size=batch, max_staleness=eta, interruptible=True)
    eng = SimEngine(n_slots=n_slots, mean_len=mean_len, max_len=2048, prompt_len=64, seed=seed)
    sched = AsyncScheduler(prompt_stream=SimPromptStream(64), rl=rl)
    return eng, SimTrainer(), sched, rl


def test_threaded_runtime_on_simulator_stubs():
    eng, trainer, sched, rl = _sim_parts(batch=32, n_slots=32, mean_len=50)
    rt = ThreadedRuntime(engine=eng, trainer=trainer, scheduler=sched)
    assert isinstance(rt, Executor)
    hist = rt.run(5, timeout=60)
    assert [h.version for h in hist] == [1, 2, 3, 4, 5]
    assert rt.buffer.total_consumed == 5 * 32
    assert rt.buffer.total_added >= rt.buffer.total_consumed
    assert max(h.staleness_max for h in hist) <= 4 + 2
    assert rt.clock > 0 and rt.effective_throughput() > 0
    assert rt.rollout_stream is None and rt.trainer_stream is None    # no CUDA here


def test_threaded_runtime_resumable():
    eng, trainer, sched, rl = _sim_parts(batch=16, n_slots=16, mean_len=30)
    rt = ThreadedRuntime(engine=eng, trainer=trainer, scheduler=sched)
    rt.run(2, timeout=60)
    rt.run(3, timeout=60)
    assert [h.version for h in rt.history] == [1, 2, 3, 4, 5]
    assert rt.buffer.total_consumed == 5 * 16


def test_threaded_runtime_timeout_fails_fast_and_is_retryable():
    eng, trainer, sched, rl = _sim_parts(batch=64, n_slots=64, mean_len=30)
    sched.stal.n_submitted = 10**9             # exhaust the Eq. 3 budget
    rt = ThreadedRuntime(engine=eng, trainer=trainer, scheduler=sched)
    with pytest.raises(TimeoutError):
        rt.run(1, timeout=0.5)
    assert trainer.version == 0 and not rt.buffer.closed
    sched.stal.n_submitted = 0
    assert [h.version for h in rt.run(1, timeout=60)] == [1]


def test_serial_then_threaded_run_shares_engine():
    eng, trainer, sched, rl = _sim_parts(batch=16, n_slots=16, mean_len=30)
    rt = ThreadedRuntime(engine=eng, trainer=trainer, scheduler=sched)
    rt.run_serial(2)
    rt.run(2, timeout=60)
    rt.run_serial(1)
    assert rt.run(0) is rt.history             # zero steps start no thread
    assert [h.version for h in rt.history] == [1, 2, 3, 4, 5]


def test_virtual_and_threaded_share_legacy_surface():
    eng, trainer, sched, rl = _sim_parts(batch=16, n_slots=16, mean_len=30)
    rt = ThreadedRuntime(engine=eng, trainer=trainer, scheduler=sched)
    rt.run(1, timeout=60)
    for attr in ("buffer", "stal", "stal_stats", "reward", "history"):
        assert getattr(rt, attr) is not None
    assert rt.stal_stats.histogram()


def test_format_liveness_orders_dead_then_stalest_first():
    out = format_liveness([RoleLiveness("fresh", True, 0.1, "v=3"),
                           RoleLiveness("dead", False, 5.0, ""),
                           RoleLiveness("stale", True, 9.0, ""),
                           RoleLiveness("neverbeat", False, None, "")])
    order = [out.index(f"role={r}") for r in ("neverbeat", "dead", "stale", "fresh")]
    assert order == sorted(order)
    assert "role=dead DEAD last-beat 5.0s ago" in out
    assert "never beat" in out and "(v=3)" in out
    assert format_liveness([]) == "no roles running"


def test_threaded_timeout_reports_per_role_liveness():
    eng, trainer, sched, rl = _sim_parts(batch=64, n_slots=64, mean_len=200)
    sched.stal.n_submitted = 10 ** 9          # wedge admission: no batch
    rt = ThreadedRuntime(engine=eng, trainer=trainer, scheduler=sched)
    with pytest.raises(TimeoutError) as ei:
        rt.run(1, timeout=0.5)
    msg = str(ei.value)
    assert "unscored=" in msg and "role=rollout" in msg and "role=trainer" in msg
    assert "last-beat" in msg or "never beat" in msg
    assert "publication={" in msg and "'published'" in msg
    assert "stream=" in msg and "flight-recorder tail:" in msg


def test_unknown_weight_stream_is_refused():
    eng, trainer, sched, rl = _sim_parts()
    with pytest.raises(ValueError, match="weight_stream"):
        ThreadedRuntime(engine=eng, trainer=trainer, scheduler=sched, weight_stream="zip")


# ---- the port's real engine and trainer -----------------------------------------

CFG = dict(name="t", family="dense", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
           d_ff=96, vocab_size=tokenizer.VOCAB_SIZE)
ETA, STEPS, BATCH = 2, 3, 8
RL = dict(batch_size=BATCH, answers_per_prompt=2, max_staleness=ETA, interruptible=True,
          ppo_minibatches=2, microbatch_token_budget=128, lr=1e-3, max_prompt_len=16,
          max_gen_len=8)
ENGINE = dict(n_slots=4, prompt_len=16, max_gen_len=8)


def _port_parts(seed=5, model=None, noise=None):
    cfg = ModelConfig(**CFG)
    rl = RLConfig(**RL)
    if model is None:
        model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    serving = build_model(cfg, device="cpu")
    serving.load_state_dict(model.state_dict())
    engine = RolloutEngine(serving, EngineConfig(seed=seed, **ENGINE), device="cpu",
                           noise=noise)
    trainer = PPOTrainer(model, rl)
    sched = AsyncScheduler(prompt_stream=PromptStream(seed=seed, answers_per_prompt=2,
                                                      max_operand=9), rl=rl)
    return engine, trainer, sched, rl


def test_threaded_matches_virtual_semantics():
    """Same seed, same policy, different transport: both executors keep
    the staleness bound (with the reference's slack of 2 on the threaded
    side), consume every trajectory exactly once, and leave the engine at
    the trainer's version."""
    eng_v, tr_v, sched_v, rl_v = _port_parts()
    virtual = AsyncRLController(
        engine=eng_v, trainer=tr_v, scheduler=sched_v, rl=rl_v,
        timing=TimingModel(decode_step=lambda n: 0.01, prefill=lambda t: 1e-4 * t,
                           train_step=lambda t: 0.2, weight_sync=0.01))
    hist_v = virtual.run(STEPS)
    eng_t, tr_t, sched_t, _ = _port_parts()
    threaded = ThreadedRuntime(engine=eng_t, trainer=tr_t, scheduler=sched_t)
    hist_t = threaded.run(STEPS, timeout=300)

    inflight_v = len(virtual._train_batch or [])
    for name, ctl, hist, inflight in (("virtual", virtual, hist_v, inflight_v),
                                      ("threaded", threaded, hist_t, 0)):
        assert [h.version for h in hist] == list(range(1, STEPS + 1)), name
        assert max(h.staleness_max for h in hist) <= ETA + 2, name
        assert ctl.buffer.total_consumed == STEPS * BATCH + inflight, name
        assert ctl.buffer.total_added - ctl.buffer.total_consumed == len(ctl.buffer), name
    assert eng_v.version == STEPS and eng_t.version == STEPS
    # the engine serves exactly the trainer's weights after a threaded run
    for name, t in eng_t.model.state_dict().items():
        assert torch.equal(t, tr_t.model.state_dict()[name]), name
    last_v = sum(h.reward_mean for h in hist_v[-2:]) / 2
    last_t = sum(h.reward_mean for h in hist_t[-2:]) / 2
    assert abs(last_v - last_t) <= 2.5


# ---- run_serial against the reference's --------------------------------------------

def _flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def _gumbel_of(seed):
    """The reference engine's Gumbel noise for step counter ``step``."""
    key = jax.random.key(seed)

    def noise(step, shape):
        g = jax.random.gumbel(jax.random.fold_in(key, step), shape, jnp.float32)
        return torch.from_numpy(np.array(g))
    return noise


def _recording(cls, into, mp):
    train_step = cls.train_step

    def recorded(self, batch, *a, **kw):
        into.append([(t.rid, t.prompt_id, list(t.prompt_tokens), list(t.response_tokens),
                      list(t.versions), t.behavior_version, t.reward,
                      list(t.behav_logprobs)) for t in batch])
        return train_step(self, batch, *a, **kw)
    mp.setattr(cls, "train_step", recorded)


# The reference stacks the layers into one leaf and the port keeps a
# tensor a layer, so their delta streams have different chunk counts and
# a bounded feed would flip them at different ticks: a budget that takes
# a whole stream in one tick flips both at the first tick after it.
WHOLE_STREAM = 10 ** 6


def _reference_serial(weight_stream, seed=5):
    rl = JRLConfig(**RL)
    model = jax_build_model(JModelConfig(**CFG), remat=False)
    params = model.init(jax.random.key(seed))
    engine = JRolloutEngine(model, params, cfg=JEngineConfig(seed=seed, **ENGINE))
    trainer = JPPOTrainer(model, rl, params)
    sched = JAsyncScheduler(prompt_stream=JPromptStream(seed=seed, answers_per_prompt=2,
                                                        max_operand=9), rl=rl)
    rt = JThreadedRuntime(engine=engine, trainer=trainer, scheduler=sched,
                          weight_stream=weight_stream, stream_chunks_per_tick=WHOLE_STREAM)
    rt.run_serial(STEPS)
    return rt, params


@pytest.fixture(scope="module", params=["full", "delta"])
def serial_runs(request):
    ws, seed = request.param, 5
    batches = {"ref": [], "ref_again": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        _recording(JPPOTrainer, batches["ref"], mp)
        ref, params = _reference_serial(ws, seed)
    with pytest.MonkeyPatch.context() as mp:
        _recording(JPPOTrainer, batches["ref_again"], mp)
        ref_again, _ = _reference_serial(ws, seed)
    model = params_from_jax(ModelConfig(**CFG), _flat_params(params), device="cpu")
    engine, trainer, sched, _ = _port_parts(seed, model=model, noise=_gumbel_of(seed))
    port = ThreadedRuntime(engine=engine, trainer=trainer, scheduler=sched,
                           weight_stream=ws, stream_chunks_per_tick=WHOLE_STREAM)
    with pytest.MonkeyPatch.context() as mp:
        _recording(PPOTrainer, batches["port"], mp)
        port.run_serial(STEPS)
    return dict(ws=ws, ref=ref, ref_again=ref_again, port=port, batches=batches)


INT_FIELDS = ("version", "n_tokens", "gen_tokens_total", "interruptions", "staleness_max")


def _ints(rt):
    return [tuple(getattr(h, f) for f in INT_FIELDS) for h in rt.history]


def test_reference_run_serial_repeats_itself(serial_runs):
    assert serial_runs["batches"]["ref"] == serial_runs["batches"]["ref_again"]
    assert _ints(serial_runs["ref"]) == _ints(serial_runs["ref_again"])
    assert [h.loss for h in serial_runs["ref"].history] == \
        [h.loss for h in serial_runs["ref_again"].history]


def test_run_serial_batches_are_token_identical(serial_runs):
    ref, port = serial_runs["batches"]["ref"], serial_runs["batches"]["port"]
    assert len(port) == len(ref) == STEPS
    for want_batch, got_batch in zip(ref, port):
        assert [t[:7] for t in got_batch] == [t[:7] for t in want_batch]
        for want, got in zip(want_batch, got_batch):
            np.testing.assert_allclose(got[7], want[7], atol=1e-4, rtol=1e-4)


def test_run_serial_step_logs_match(serial_runs):
    ref, port = serial_runs["ref"], serial_runs["port"]
    assert _ints(port) == _ints(ref)
    assert [h.version for h in port.history] == list(range(1, STEPS + 1))
    for got, want in zip(port.history, ref.history, strict=True):
        assert (got.reward_mean, got.accuracy, got.staleness_mean) == \
            (want.reward_mean, want.accuracy, want.staleness_mean), got.version
    np.testing.assert_allclose([h.loss for h in port.history], [h.loss for h in ref.history],
                               rtol=0, atol=1e-5)
    assert port.stal_stats.histogram() == ref.stal_stats.histogram()


def test_run_serial_pickups_match(serial_runs):
    """Each side picked up every version, by the path its mode names."""
    ref, port = serial_runs["ref"], serial_runs["port"]
    assert port.engine.version == ref.engine.version == STEPS
    assert port.engine.interruptions == ref.engine.interruptions
    got, want = port.engine.stream_stats(), ref.engine.stream_stats()
    assert got["streams_completed"] == want["streams_completed"] == \
        (STEPS if serial_runs["ws"] == "delta" else 0)
    assert got["streams_torn"] == want["streams_torn"] == 0
    for name, t in port.engine.model.state_dict().items():
        assert torch.equal(t, port.trainer.model.state_dict()[name]), name


# ---- the launcher ----------------------------------------------------------------------

@pytest.mark.parametrize("weight_stream", ["full", "delta-q"])
def test_run_training_threaded_on_the_cpu(weight_stream):
    ctl, trainer, reward = run_training(steps=2, runtime="threaded", device="cpu",
                                        weight_stream=weight_stream, final_eval=False,
                                        run_timeout=120, log_every=1 << 30)
    assert isinstance(ctl, ThreadedRuntime)
    assert [h.version for h in ctl.history] == [1, 2]
    assert ctl.engine.version == trainer.version == 2
    assert ctl.buffer.total_consumed == 2 * 32 and ctl.clock > 0
    if weight_stream != "full":
        assert ctl.engine.stream_stats()["streams_completed"] == 2
        assert [s["encoding"] for s in ctl.streams_sent] == ["full", "delta-q"]


def test_run_training_spills_checkpoints(tmp_path):
    from repro_torch import checkpoint
    ctl, trainer, _ = run_training(steps=10, runtime="threaded", device="cpu",
                                   ckpt_dir=str(tmp_path), final_eval=False, run_timeout=300,
                                   log_every=1 << 30)
    ctl.store.close()
    assert ctl.store.spills == 1
    got, _, meta = checkpoint.load(str(tmp_path / "v000010.npz"), trainer.model)
    assert meta["version"] == 10
    for name, t in trainer.model.state_dict().items():     # the trainer's last version
        assert torch.equal(got[name], t), name


def test_run_training_threaded_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_training(steps=1, runtime="threaded")


def test_split_devices_is_a_function_of_its_list():
    devs = [f"cuda:{i}" for i in range(4)]
    roll, train = split_devices(0.25, devs)
    assert roll == [torch.device(d) for d in devs[:3]] and train == [torch.device("cuda:3")]
    roll, train = split_devices(0.5, devs[:2])
    assert (roll, train) == ([torch.device("cuda:0")], [torch.device("cuda:1")])
    with pytest.raises(ValueError, match="too small"):
        split_devices(0.25, devs[:1])


# ---- two threads, one process ------------------------------------------------------------

@pytest.mark.parametrize("n_threads,n", [(2, 100_000), ((os.cpu_count() or 1) + 1, 20_000)])
def test_launch_counter_loses_no_count_under_threads(n_threads, n):
    """The rollout and trainer threads count launches at once: with the
    interpreter switching threads every microsecond, a read-modify-write
    without the lock would lose counts."""
    before = ops.LAUNCHES["flash_attention"]
    start = threading.Barrier(n_threads)

    def bump():
        start.wait()
        for _ in range(n):
            ops.count_launch("flash_attention")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ops.LAUNCHES["flash_attention"] == before + n_threads * n
    ops.reset_launches()
    assert set(ops.LAUNCHES.values()) == {0}


def _calls(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            yield node.func.attr, ast.unparse(node.func)


@pytest.mark.parametrize("path", sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_synchronises_the_whole_device(path):
    """The rollout and trainer loops share the card on two streams: no
    module may wait for the whole device or release its memory."""
    for attr, call in _calls(path):
        assert not (attr in ("synchronize", "empty_cache") and "cuda" in call), \
            f"{path.name} calls {call}"

"""The port's fleet supervisor (``repro_torch.core.fleet``) against the JAX
package's (``repro.core.fleet``), with no process spawned.

* The same scripted events drive both ``FleetRuntime``s through fake
  worker handles and transports (as ``tests/test_fleet.py`` builds
  them): ``_fail_worker`` called twice, a dead worker whose delivered
  ``finished`` results are salvaged, a ``need_full`` resynchronisation,
  the elastic tick's grow and shrink decisions, and ``liveness`` as
  ``format_liveness`` orders it.  The registry's events, the requeue,
  the scheduler's ``inflight_of`` and ``requeued_total``, the buffer
  and what each side sent must agree.
* The host form of a trainer replica's reply (``host_weights``, the
  AdamW state's, ``TrainMetrics``) pickles with no torch object inside,
  and loads back into an ``LM`` and its AdamW state in place, bit for
  bit; ``PipeTransport`` refuses a tensor and carries arrays out of band.
"""
import dataclasses
import pickle
import pickletools
import threading
import time
from multiprocessing import Pipe

import numpy as np
import pytest
import torch

from repro.configs.base import RLConfig as JRLConfig
from repro.core import fleet as jfleet
from repro.core.rollout import Finished as JFinished
from repro.core.runtime import format_liveness as jformat_liveness
from repro.core.scheduler import AsyncScheduler as JAsyncScheduler
from repro.core.simulator import SimPromptStream as JSimPromptStream
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core import fleet
from repro_torch.core.rollout import Finished
from repro_torch.core.runtime import Executor, format_liveness
from repro_torch.core.scheduler import AsyncScheduler
from repro_torch.core.simulator import SimPromptStream
from repro_torch.core.trainer import PPOTrainer, TrainMetrics
from repro_torch.launch.train import run_training
from repro_torch.models.model import build_model


def _unused_factory(**_):
    raise AssertionError("no worker is built in these tests")


class _StubService:
    """saturated()-only stand-in for AsyncRewardService."""
    env = None

    def __init__(self):
        self.sat = False

    def bind(self, sink):
        pass

    def saturated(self):
        return self.sat


class _FakeProc:
    pid = 0

    def __init__(self, alive=False):
        self.alive = alive

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.alive = False

    def kill(self):
        self.alive = False

    def join(self, timeout=None):
        pass


class _FakeTransport:
    """Delivers ``inbox`` then EOF (a dead peer's salvage); records what
    the supervisor sends, or refuses it like a closed pipe."""
    raw = None

    def __init__(self, inbox=(), refuse=False):
        self.inbox = list(inbox)
        self.sent = []
        self.refuse = refuse

    def send(self, msg):
        if self.refuse:
            raise OSError("peer gone")
        self.sent.append(msg)

    def recv(self, timeout=0.0):
        if self.inbox:
            return self.inbox.pop(0)
        raise EOFError

    def close(self):
        pass


class Side:
    """One side's classes: the JAX package's or the port's."""

    def __init__(self, jax_side: bool):
        self.mod = jfleet if jax_side else fleet
        self.rl_cls = JRLConfig if jax_side else RLConfig
        self.sched_cls = JAsyncScheduler if jax_side else AsyncScheduler
        self.stream_cls = JSimPromptStream if jax_side else SimPromptStream
        self.finished_cls = JFinished if jax_side else Finished
        self.format_liveness = jformat_liveness if jax_side else format_liveness

    def sched(self, *, eta=4, batch=4, service=None):
        rl = self.rl_cls(batch_size=batch, max_staleness=eta, interruptible=True)
        return self.sched_cls(prompt_stream=self.stream_cls(8, answers_per_prompt=4), rl=rl,
                              reward_service=service)

    def runtime(self, sched, **kw):
        kw = dict(dict(n_slots=4, rollout_workers=1), **kw)
        return self.mod.FleetRuntime(scheduler=sched, engine_factory=_unused_factory,
                                     engine_factory_kwargs={},
                                     trainer_factory=_unused_factory,
                                     trainer_factory_kwargs={}, **kw)

    def handle(self, rt, worker_id, *, state="ready", alive=False, transport=None):
        h = self.mod.WorkerHandle(worker_id=worker_id, role=worker_id.split("-")[0],
                                  proc=_FakeProc(alive), transport=transport or _FakeTransport())
        h.state = state
        rt.registry.add(h)
        return h

    def finished(self, req):
        return self.finished_cls(rid=req["rid"], prompt_id=req["prompt_id"],
                                 prompt=[1, 2, 3], response=[4, 5], logprobs=[-0.5, -0.25],
                                 versions=[0], behavior_version=0, answer=None,
                                 submit_time=0.0, truncated=False)


SIDES = {"jax": Side(True), "torch": Side(False)}


def _events(rt):
    """The registry's event log without times, paths or pids."""
    drop = ("t", "path", "pid", "traceback")
    return [{k: v for k, v in e.items() if k not in drop} for e in rt.registry.events]


def _on_both(script):
    out = {name: script(side) for name, side in SIDES.items()}
    assert out["jax"] == out["torch"]
    return out["torch"]


def test_fleet_runtime_is_an_executor():
    rt = SIDES["torch"].runtime(SIDES["torch"].sched())
    assert isinstance(rt, Executor)
    with pytest.raises(ValueError, match="weight_stream"):
        SIDES["torch"].runtime(SIDES["torch"].sched(), weight_stream="zip")


def test_fail_worker_twice_requeues_once_as_the_reference():
    def script(side):
        sched = side.sched()
        rt = side.runtime(sched)
        rt._stop.set()                    # suppress the respawn leg
        h = side.handle(rt, "rollout-0", transport=_FakeTransport(refuse=True))
        reqs = sched.plan_admission(3)
        sched.assign("rollout-0", reqs)
        rt._fail_worker(h, reason="crashed")
        first = (h.state, sched.requeued_total, rt._failures)
        rt._fail_worker(h, reason="error")
        return dict(first=first, second=(h.state, sched.requeued_total, rt._failures),
                    events=_events(rt), inflight=sched.inflight_of("rollout-0"),
                    requeued=[r["rid"] for r in sched.plan_admission(8)][:3])

    out = _on_both(script)
    assert out["first"] == out["second"] == ("dead", 3, 1)
    assert [e["kind"] for e in out["events"]].count("worker-dead") == 1


def test_dead_worker_delivered_results_are_salvaged_as_the_reference():
    """The dead worker acked 4 requests and delivered 2 before dying: the
    2 are collected, only the other 2 are requeued, and a duplicate
    delivery of one is dropped."""
    def script(side):
        sched = side.sched(batch=2)
        rt = side.runtime(sched)
        rt._stop.set()
        reqs = sched.plan_admission(4)
        done = [side.finished(r) for r in reqs[1:3]]
        inbox = [("admitted", "rollout-0", [r["rid"] for r in reqs], 4, 0),
                 ("finished", "rollout-0", done),
                 ("finished", "rollout-0", done[:1])]
        h = side.handle(rt, "rollout-0", transport=_FakeTransport(inbox))
        sched.assign("rollout-0", reqs)
        h.sent_admits.append(reqs)
        rt._fail_worker(h, reason="crashed")
        batch = sched.buffer.pop_batch(2, timeout=0.1)
        return dict(events=_events(rt), requeued=sched.requeued_total,
                    dropped=rt.duplicates_dropped, inflight=sched.inflight_of("rollout-0"),
                    buffered=sorted(t.rid for t in batch),
                    again=[r["rid"] for r in sched.plan_admission(8)][:2])

    out = _on_both(script)
    assert out["requeued"] == 2 and out["dropped"] == 1 and out["inflight"] == []
    requeue = [e for e in out["events"] if e["kind"] == "requeue"]
    assert requeue[0]["rids"] == out["again"]
    assert sorted(out["buffered"] + out["again"]) == list(range(4))


def test_need_full_resynchronises_with_the_full_tree_as_the_reference():
    def script(side):
        rt = side.runtime(side.sched())
        h = side.handle(rt, "rollout-0")
        rt._dispatch(h, ("need_full", "rollout-0"))     # nothing published yet
        rt._version, rt._params_np = 3, {"w": np.arange(4, dtype=np.float32)}
        rt._dispatch(h, ("need_full", "rollout-0"))
        rt._dispatch(h, ("register", "rollout-0", "rollout", 0))
        return [(m[0], m[1], {k: v.tolist() for k, v in m[2].items()})
                for m in h.transport.sent]

    assert _on_both(script) == [("weights", 3, {"w": [0.0, 1.0, 2.0, 3.0]})] * 2


def test_elastic_tick_grows_and_shrinks_as_the_reference():
    def script(side):
        svc = _StubService()
        sched = side.sched(eta=8, batch=4, service=svc)
        rt = side.runtime(sched, rollout_workers=2, elastic=True, min_workers=1)
        spawned = []

        def spawn(role):
            spawned.append(role)
            h = side.handle(rt, f"{role}-{len(rt.registry.workers(role))}", state="starting",
                            alive=True)
            rt.registry.note("spawn", worker=h.worker_id, role=role)
            return h
        rt._spawn = spawn
        a = side.handle(rt, "rollout-0", alive=True)
        b = side.handle(rt, "rollout-1", alive=True)
        ticks = []

        def tick():
            rt._last_elastic = 0.0
            rt._elastic_tick()
            ticks.append((rt._target_workers, a.state, b.state, list(spawned)))

        tick()                            # not full: nothing
        sched.assign("rollout-0", sched.plan_admission(4))
        sched.assign("rollout-1", sched.plan_admission(4))
        tick()                            # every ready worker full: grow
        tick()                            # a worker is still starting: wait
        rt.registry.get("rollout-2").state = "ready"
        sched.finished_inflight(sched.inflight_of("rollout-1")[0])
        svc.sat = True
        tick()                            # saturated: drain the least loaded
        tick()                            # one drain at a time
        return dict(ticks=ticks, events=_events(rt),
                    sent={h.worker_id: h.transport.sent for h in rt.registry.workers()})

    out = _on_both(script)
    assert [t[0] for t in out["ticks"]] == [2, 3, 3, 2, 2]
    assert [e["kind"] for e in out["events"]] == ["spawn", "grow", "shrink"]
    assert out["sent"]["rollout-2"] == [("drain",)]


def test_liveness_is_ordered_as_the_reference():
    def script(side):
        rt = side.runtime(side.sched(), rollout_workers=2)
        now = time.monotonic()
        for wid, alive, age, state in (("rollout-0", True, 0.5, "ready"),
                                       ("rollout-1", False, 3.0, "ready"),
                                       ("trainer-0", True, 9.0, "ready"),
                                       ("rollout-2", True, None, "starting"),
                                       ("rollout-3", False, 1.0, "stopped")):
            h = side.handle(rt, wid, state=state, alive=alive)
            h.last_beat = None if age is None else now - age
            h.stats = {"n_active": 2, "version": 1} if wid == "rollout-0" else {}
        text = side.format_liveness(rt.liveness())
        return [part.split(" ")[0] for part in text.split("; ")], "(state=ready active=2 v=1)" in text

    order, detail = _on_both(script)
    # dead before alive, then the stalest (never beat) first
    assert order == ["role=trainer-pump", "role=rollout:rollout-1", "role=rollout:rollout-2",
                     "role=trainer:trainer-0", "role=rollout:rollout-0"]
    assert detail


@pytest.mark.parametrize("kw", [dict(model=object()), dict(noise=lambda *a: None),
                                dict(env="multiturn")], ids=["model", "noise", "multiturn"])
def test_run_training_fleet_refuses_what_cannot_reach_its_workers(kw):
    """The test hooks ``model=`` / ``noise=`` and the multi-turn
    environment's continuation hook would have to live inside the worker
    processes: refused before anything is spawned."""
    with pytest.raises(ValueError, match="fleet"):
        run_training(steps=1, device="cpu", runtime="fleet", **kw)


def test_queued_beats_are_read_before_a_worker_is_declared_hung():
    """The port's supervisor reads a silent-looking worker's transport
    before failing it: its beats may sit unread behind a long message
    from another worker.  A worker with nothing queued is still hung."""
    side = SIDES["torch"]
    rt = side.runtime(side.sched(), heartbeat_timeout=1.0)
    rt._stop.set()                        # suppress the respawn leg
    beat = ("heartbeat", "rollout-0", 7, {"n_active": 0, "version": 0})
    late = side.handle(rt, "rollout-0", alive=True, transport=_FakeTransport([beat]))
    mute = side.handle(rt, "rollout-1", alive=True)
    late.last_beat = mute.last_beat = time.monotonic() - 5.0
    rt._check_liveness()
    assert late.state == "ready" and late.beats == 1 and late.max_gap >= 5.0
    assert mute.state == "dead"
    assert [e["worker"] for e in rt.registry.events_of("worker-dead")] == ["rollout-1"]
    assert rt.registry.events_of("worker-dead")[0]["hung"]


# ---- the host form of a trainer replica's reply -------------------------------

def _tiny():
    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), n_layers=2,
                              d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                              vocab_size=64)
    rl = RLConfig(batch_size=4, lr=1e-2, total_steps=4)
    return cfg, rl


def _torch_globals(payload: bytes):
    """Module names of every global a pickle refers to."""
    names, strings = set(), []
    for op, arg, _ in pickletools.genops(payload):
        if isinstance(arg, str):
            strings.append(arg)
        if op.name == "STACK_GLOBAL":
            names.add(strings[-2])
        elif op.name == "GLOBAL":
            names.add(arg.split(" ")[0])
    return {n for n in names if n == "torch" or n.startswith("torch.")}


def test_trainer_reply_host_form_round_trips_in_place_bit_for_bit():
    cfg, rl = _tiny()
    gen = torch.Generator().manual_seed(3)
    src = PPOTrainer(build_model(cfg, device="cpu").init(gen), rl)
    for m, v in zip(src.opt_state["m"], src.opt_state["v"]):
        m.normal_(generator=gen)
        v.uniform_(generator=gen)
    src.opt_state["step"] = 7
    metrics = TrainMetrics(version=1, loss=0.25, reward_mean=0.5, seq_len_mean=9.0,
                           staleness_mean=0.0, staleness_max=0, n_tokens=36,
                           n_microbatches=2, diag={"clip_frac": 0.125})
    reply = ("trained", "trainer-0", 1, metrics, fleet.host_weights(src.model),
             fleet.host_opt_state(src.opt_state))
    head, buffers = fleet.dumps(reply)
    assert _torch_globals(head) == set()
    assert _torch_globals(pickle.dumps(reply, protocol=4)) == set()
    got = pickle.loads(head, buffers=buffers)
    assert got[3] == metrics

    dst = PPOTrainer(build_model(cfg, device="cpu").init(torch.Generator().manual_seed(4)), rl)
    ptrs = [p.data_ptr() for p in dst._params]
    mv = [t.data_ptr() for t in dst.opt_state["m"] + dst.opt_state["v"]]
    fleet.load_host_weights(dst.model, got[4])
    fleet.load_host_opt_state(dst.opt_state, got[5])
    assert [p.data_ptr() for p in dst._params] == ptrs            # in place
    assert [t.data_ptr() for t in dst.opt_state["m"] + dst.opt_state["v"]] == mv
    for (name, a), b in zip(src.model.state_dict().items(), dst.model.state_dict().values()):
        assert torch.equal(a, b), name
    for key in ("m", "v"):
        for a, b in zip(src.opt_state[key], dst.opt_state[key]):
            assert torch.equal(a, b)
    assert dst.opt_state["step"] == 7


def test_bf16_weights_travel_as_their_bits():
    cfg, _ = _tiny()
    src = build_model(cfg, device="cpu", dtype=torch.bfloat16).init(
        torch.Generator().manual_seed(5))
    host = fleet.host_weights(src)
    assert {a.dtype for a in host.values()} <= {np.dtype(np.uint16), np.dtype(np.float32)}
    head, buffers = fleet.dumps(host)
    dst = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    fleet.load_host_weights(dst, pickle.loads(head, buffers=buffers))

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for a, b in zip(src.state_dict().values(), dst.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))
    # a rollout worker's form: new tensors, which the engine copies
    on_dev = fleet._to_device(host, dst)
    assert all(torch.equal(bits(on_dev[n]), bits(t)) for n, t in src.state_dict().items())
    assert all(on_dev[n].data_ptr() != t.data_ptr() for n, t in dst.state_dict().items())


def test_pipe_transport_refuses_torch_and_sends_arrays_out_of_band():
    a, b = Pipe(duplex=True)
    left, right = fleet.PipeTransport(a), fleet.PipeTransport(b)
    try:
        with pytest.raises(TypeError, match="would cross a Transport"):
            left.send(("weights", 1, {"w": torch.zeros(3)}))
        with pytest.raises(TypeError, match="would cross a Transport"):
            left.send(("train", torch.float32))
        assert right.recv(0.0) is None and left.bytes_sent == 0
        big = np.arange(1 << 20, dtype=np.float32).reshape(1024, 1024)
        msg = ("weights", 2, {"w": big, "b": np.ones(3, np.uint16)}, [1, 2.5, "x"])
        # more than the socket buffers hold: the receiver reads while it sends
        sender = threading.Thread(target=left.send, args=(msg,))
        sender.start()
        got = right.recv(5.0)
        sender.join(10.0)
        assert not sender.is_alive()
        assert got[0] == "weights" and got[1] == 2 and got[3] == [1, 2.5, "x"]
        assert np.array_equal(got[2]["w"], big) and got[2]["w"].flags.writeable
        assert got[2]["b"].dtype == np.uint16
        assert right.bytes_received == left.bytes_sent > big.nbytes
        assert left.bytes_sent < big.nbytes + 4096                     # one copy of the data
        right.send(("heartbeat", "w", 0, {}))
        assert left.recv(5.0) == ("heartbeat", "w", 0, {})
        right.close()
        with pytest.raises(EOFError):
            left.recv(5.0)
    finally:
        left.close()
        right.close()

"""Multi-process elastic rollout fleet (DESIGN.md §Fleet runtime), after
``repro/core/fleet.py``.

``ThreadedRuntime`` proves the async pipeline on two threads in one
process; this module is the step to the paper's actual deployment
shape — MANY rollout workers and trainer replicas as separate OS
processes that can crash, stall, join and leave independently, with the
transport-agnostic ``AsyncScheduler`` still the single policy core.

Process ownership (DESIGN.md §Process ownership):

    supervisor process (this module, main process)
    ├─ AsyncScheduler + ReplayBuffer + ParameterStore  (policy state)
    ├─ supervisor thread: transport receive, dispatch, liveness,
    │                     admission planning, elastic policy
    ├─ trainer-pump thread: pop_batch -> ship to a trainer replica ->
    │                       publish weights -> StepLog
    ├─ reward-service worker threads (when configured)
    │
    ├─ rollout worker process x N  (one RolloutEngine each,
    │       single-driver contract held by the worker's main loop;
    │       a daemon heartbeat thread only READS engine counters)
    └─ trainer replica process x M (one PPOTrainer each, stateless
            executors: params/opt-state ship with every batch, so M
            replicas reproduce single-trainer sequential semantics)

Transport (DESIGN.md §Fleet runtime): workers talk to the supervisor
over a ``Transport`` — a 3-method interface (send / recv(timeout) /
close) carrying picklable tuples.  The in-tree implementation is
``PipeTransport`` over ``multiprocessing.Pipe``; an RPC or socket
backend slots in by implementing the same interface, nothing else in
this module changes.  Messages per direction:

    worker -> supervisor: register, heartbeat, admitted, finished,
                          drained, stopped, error
    supervisor -> worker:  admit, weights, drain, stop
    supervisor -> trainer: train, stop;  trainer -> supervisor: trained

Heartbeats + supervision (DESIGN.md §Supervision state machine): every
worker runs a daemon thread beating ``heartbeat_s`` with progress
counters; the beat starts BEFORE the engine builds, so build time
never reads as death.  The supervisor declares a worker failed when its
process exits, when it reports an error, or when beats stop for
``heartbeat_timeout`` (a SIGSTOP-frozen process is alive but silent —
it is terminated and treated as crashed; a merely SLOW worker keeps
beating and is never respawned).  Failure handling: salvage whatever
the dead worker already delivered on its transport, requeue its
remaining in-flight requests through ``AsyncScheduler.requeue_worker``
(DESIGN.md §Requeue semantics — already-counted for Eq. 3, re-admitted
by ordinary ``plan_admission``, regenerated from the prompt by the
interrupt/re-prefill machinery on whichever worker picks them up), and
respawn a replacement up to ``max_respawns``.

Elastic mode (DESIGN.md §Elastic policy): the fleet grows while
admission is capacity-starved and shrinks while the reward service's
scoring backlog saturates (``AsyncScheduler.saturated()``).  A shrink
is a graceful drain — the victim stops taking admissions, finishes its
in-flight slots and delivers them before stopping — so an unscored
trajectory is never dropped.

Trajectory equivalence: with per-request RNG streams
(``EngineConfig(rng="request")``) every token depends only on
(seed, rid, draw index) and the weights — not on which worker, admission
timing or batch layout — so the fleet reproduces ``ThreadedRuntime``'s
per-request trajectories.

Where the port differs from the reference:

  * **Host forms on the wire.**  Every message holds numpy arrays,
    lists and Python scalars, never a torch object (``PipeTransport``
    refuses one).  A published version is ``host_weights`` of the
    trainer's ``LM`` (bf16 as its ``uint16`` bits); the optimizer state
    is ``{"m": [f32 arrays], "v": [f32 arrays], "step": int}`` in
    ``model.parameters()`` order.  A rollout worker turns a version
    into tensors on its device (``_to_device``) and hands them to
    ``RolloutEngine.update_weights``, which copies them; a trainer
    replica copies a shipped state INTO its ``LM``'s and AdamW's
    existing tensors, because ``PPOTrainer`` holds on to its parameter
    list.
  * **Framing.**  ``PipeTransport`` pickles with protocol 5 and sends
    each contiguous array's memory as it lies, out of band; the
    receiver reads each one straight into a new array.  The reference's
    ``Connection.send`` builds the whole pickle in memory and its
    ``recv`` reads it into a second buffer before unpickling, so a
    message of N bytes holds about 2N on each side: at full width a
    trainer round trip ships parameters plus m and v, 18.5 GB in f32
    each way.  The standard pickler is used, not ``ForkingPickler``,
    whose reductions ``import torch`` replaces.
  * **Launches and memory on the heartbeat.**  Each beat also carries
    the worker process's ``ops.LAUNCHES`` (as ``launches.<kernel>``),
    its intra-op thread count, the largest resident set its beats have
    sampled and, once it uses CUDA, its peak device memory; a rollout worker also counts the
    admissions that took requests (one prefill each) and a trainer
    replica its micro-batches and the seconds of each step's load,
    ``train_step`` and host copy.  The launch counts survive respawns
    and ``close`` like the token counters (``FleetRegistry.retired``),
    and each handle keeps its last stats when it retires
    (``WorkerHandle.last_stats``).  A worker's ``stopped`` carries its
    last stats, and ``close`` reads it.
  * **Liveness under large messages.**  The supervisor thread receives
    each message whole, so a trainer reply of gigabytes keeps it from
    the other workers' beats for seconds: before it declares a worker
    silent it reads what that worker has already sent.
"""
from __future__ import annotations

import collections
import contextlib
import io
import os
import pickle
import socket
import struct
import threading
import time
import traceback
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Any, Callable, Dict, List, Optional

import multiprocessing as mp
from multiprocessing import connection as mpc

import numpy as np
import torch

from repro_torch.core.runtime import RoleLiveness, format_liveness
from repro_torch.core.scheduler import AsyncScheduler, SchedulerExecutorMixin, StepLog
from repro_torch.core.weights import ENCODINGS, ParameterStore, encode_stream, host_weights
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace
from repro_torch.obs.recorder import FlightRecorder

LAUNCH_KEYS = tuple(f"launches.{name}" for name in ops.LAUNCHES)


# ---- transport --------------------------------------------------------------
class Transport:
    """Message transport interface between the supervisor and one worker
    (DESIGN.md §Fleet runtime).  Implementations carry picklable tuples,
    preserve per-connection FIFO order (the supervisor relies on
    'admitted' acks preceding 'finished' for the same requests), and
    must tolerate concurrent ``send`` from two threads (a worker's main
    loop and its heartbeat thread share one transport)."""

    def send(self, msg: tuple) -> None:
        raise NotImplementedError

    def recv(self, timeout: float = 0.0):
        """Next message, or None if none arrived within ``timeout``.
        Raises EOFError once the peer is gone and the buffer is dry."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class _HostPickler(pickle.Pickler):
    """Refuses torch objects: a CPU tensor would travel as a
    shared-memory handle and a CUDA one as an IPC handle that dies with
    the sender's tensor.  Messages carry host forms only."""

    def reducer_override(self, obj):
        module = type(obj).__module__
        if module == "torch" or module.startswith("torch."):
            raise TypeError(f"a {type(obj).__name__} would cross a Transport; "
                            "send its host form (numpy) instead")
        return NotImplemented


_HEAD = struct.Struct("<QI")              # pickle length, out-of-band buffers


def dumps(msg) -> tuple:
    """(pickle bytes, out-of-band buffers) of ``msg`` under protocol 5:
    each contiguous array's memory is a buffer of its own, not copied."""
    out, buffers = io.BytesIO(), []
    _HostPickler(out, protocol=5, buffer_callback=buffers.append).dump(msg)
    return out.getvalue(), [b.raw() for b in buffers]


class PipeTransport(Transport):
    """``multiprocessing.Pipe`` transport — the in-tree backend.  A frame
    is a header (pickle length, buffer count, each buffer's length), the
    pickle, then each out-of-band buffer's bytes; the receiver reads each
    buffer into a new array, and unpickles over them.  ``bytes_sent`` and
    ``bytes_received`` count the frames' bytes."""

    def __init__(self, conn):
        self.raw = conn                   # exposed for connection.wait()
        # a second handle on the pipe's socket, for sendall / MSG_WAITALL
        self._sock = socket.fromfd(conn.fileno(), socket.AF_UNIX, socket.SOCK_STREAM)
        self._send_lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0

    def send(self, msg: tuple) -> None:
        head, buffers = dumps(msg)
        sizes = [b.nbytes for b in buffers]
        frame = (_HEAD.pack(len(head), len(sizes))
                 + struct.pack(f"<{len(sizes)}Q", *sizes) + head)
        with self._send_lock:
            self._sock.sendall(frame)
            for b in buffers:
                self._sock.sendall(b)
            self.bytes_sent += len(frame) + sum(sizes)

    def _read_into(self, view: memoryview) -> None:
        got = 0
        while got < len(view):
            n = self._sock.recv_into(view[got:], len(view) - got, socket.MSG_WAITALL)
            if n == 0:
                raise EOFError("transport peer closed mid-message" if got else
                               "transport peer closed")
            got += n

    def _read(self, n: int) -> bytearray:
        out = bytearray(n)
        self._read_into(memoryview(out))
        return out

    def recv(self, timeout: float = 0.0):
        if not self.raw.poll(timeout):
            return None
        head_len, n_buf = _HEAD.unpack(self._read(_HEAD.size))
        sizes = struct.unpack(f"<{n_buf}Q", self._read(8 * n_buf)) if n_buf else ()
        head = self._read(head_len)
        buffers = []
        for size in sizes:
            buf = np.empty(size, np.uint8)
            self._read_into(memoryview(buf))
            buffers.append(buf)
        self.bytes_received += _HEAD.size + 8 * n_buf + head_len + sum(sizes)
        return pickle.loads(head, buffers=buffers)

    def close(self) -> None:
        for end in (self._sock, self.raw):
            try:
                end.close()
            except OSError:
                pass


# ---- host <-> device forms ---------------------------------------------------
def _host_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory (no copy): bf16 from its
    ``uint16`` bits (``core/weights.py::host_weights``'s form)."""
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_device(tree, model) -> Optional[Dict[str, torch.Tensor]]:
    """A host state dict as new tensors shaped, typed and placed like
    ``model``'s (what ``RolloutEngine.update_weights`` takes and copies);
    None stays None (the simulator's trainer publishes none)."""
    if tree is None:
        return None
    mine = model.state_dict()
    return {name: _host_tensor(arr, mine[name]).to(mine[name].device, mine[name].dtype,
                                                   copy=True)
            for name, arr in tree.items()}


@torch.no_grad()
def load_host_weights(model, tree: Dict[str, np.ndarray]) -> None:
    """Copy a host state dict into ``model``'s existing tensors, in place:
    a trainer holds on to its parameter list, so new tensors would leave
    its optimizer updating the old ones."""
    mine = model.state_dict()
    if set(tree) != set(mine):
        raise ValueError("the shipped weights do not fit the replica's model")
    for name, t in mine.items():
        t.copy_(_host_tensor(tree[name], t))


def host_opt_state(state: Optional[Dict]) -> Optional[Dict]:
    """AdamW state (``optim.init_state``'s m and v lists and step) as f32
    numpy arrays and an int."""
    if state is None:
        return None
    return {"m": [m.detach().to("cpu", copy=True).numpy() for m in state["m"]],
            "v": [v.detach().to("cpu", copy=True).numpy() for v in state["v"]],
            "step": int(state["step"])}


@torch.no_grad()
def load_host_opt_state(state: Dict, host: Dict) -> None:
    """Copy ``host_opt_state``'s form into AdamW's existing m and v
    tensors, in place, and set its step."""
    for key in ("m", "v"):
        if len(host[key]) != len(state[key]):
            raise ValueError("the shipped optimizer state does not fit the replica's")
        for t, arr in zip(state[key], host[key]):
            t.copy_(torch.from_numpy(arr))
    state["step"] = int(host["step"])


# ---- worker process mains ---------------------------------------------------
# Top-level functions (spawn start method pickles them by reference).
# Factories are likewise module-level callables: the child re-imports
# the factory's module, so tests define their own builders in modules
# that import no JAX.

def proc_status_bytes(key: str) -> int:
    """A size field of ``/proc/self/status`` (e.g. ``VmRSS``) in bytes, 0
    where there is none.  ``getrusage``'s ``ru_maxrss`` would not do for
    a worker: a spawned child inherits its parent's at fork and exec."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _process_stats(progress: Dict) -> Dict:
    """The worker process's own counters: kernel launches, intra-op
    threads, the largest resident set its beats have seen (bytes, kept
    in ``progress``) and, once it uses CUDA, peak device memory (bytes)."""
    progress["peak_rss_bytes"] = max(progress.get("peak_rss_bytes", 0),
                                     proc_status_bytes("VmRSS"))
    st = {f"launches.{name}": n for name, n in ops.LAUNCHES.items()}
    st["pid"] = os.getpid()
    st["threads"] = torch.get_num_threads()
    st["peak_rss_bytes"] = progress["peak_rss_bytes"]
    if torch.cuda.is_initialized():
        st["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return st


def _engine_stats(engine, progress: Dict) -> Dict:
    """Heartbeat payload: read-only engine counters + loop progress.
    Runs on the worker's heartbeat thread — reads, never drives, the
    engine (the main loop holds the single-driver contract)."""
    st = dict(progress)
    st.update(_process_stats(progress))
    if engine is None:
        st["phase"] = "building"
        return st
    st.update(n_active=engine.n_active, n_free=len(engine.free_slots()),
              version=engine.version,
              tokens_generated=engine.tokens_generated,
              interruptions=engine.interruptions)
    ingest = getattr(engine, "ingest_backlog_tokens", None)
    if callable(ingest):
        st["ingest_backlog_tokens"] = ingest()
    # decode fast-path counters: the liveness line shows the acceptance
    # rate, so an operator can see a draft model gone stale (the rate
    # collapsing toward 0)
    if getattr(engine, "decode_dispatches", None) is not None:
        st["decode_dispatches"] = engine.decode_dispatches
        st["drafted_tokens"] = engine.drafted_tokens
        st["accepted_tokens"] = engine.accepted_tokens
        st["draft_acceptance_rate"] = engine.draft_acceptance_rate
        st["accepted_tokens_per_step"] = engine.accepted_tokens_per_step
    # streaming pickup progress (DESIGN.md §Version fence)
    st.update(obs_metrics.scrape(engine, surfaces=("stream_stats",)))
    return st


@contextlib.contextmanager
def _heartbeat(transport: Transport, worker_id: str, stats_fn,
               heartbeat_s: float, stop: threading.Event):
    """Beat every ``heartbeat_s`` while the block runs; on leaving it,
    stop the beat and wait for it: a daemon thread still inside torch
    when the interpreter exits aborts the process."""
    def beat():
        seq = 0
        while not stop.is_set():
            try:
                transport.send(("heartbeat", worker_id, seq, stats_fn()))
            except (OSError, ValueError):
                return                    # supervisor is gone
            seq += 1
            stop.wait(heartbeat_s)

    t = threading.Thread(target=beat, name=f"beat-{worker_id}", daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join(1.0 + heartbeat_s)


def _stop_worker(transport: Transport, worker_id: str, stats_fn,
                 stop: threading.Event) -> None:
    """Answer 'stop' with 'stopped' and the worker's last stats (the
    counters since its previous beat), in one message."""
    stop.set()
    transport.send(("stopped", worker_id, stats_fn()))


def _rollout_worker_main(worker_id: str, conn, factory: Callable,
                         factory_kwargs: Dict, cfg: Dict) -> None:
    """Rollout worker process: build the engine, then loop
    receive-apply-step — the process analogue of ``ThreadedRuntime``'s
    rollout thread (DESIGN.md §Fleet runtime).  Registers and starts
    heartbeating BEFORE the (slow) engine build."""
    transport = PipeTransport(conn)
    stop = threading.Event()
    progress = {"steps": 0, "loops": 0, "admits": 0}
    holder: List[Any] = [None]            # engine, visible to the beat thread
    # crash flight recorder (DESIGN.md §Flight-recorder protocol): the
    # tail ships incrementally on each heartbeat, so the supervisor
    # holds this worker's recent past even after a SIGKILL
    rec = FlightRecorder(capacity=int(cfg.get("flightrec_cap", 256)))
    rec.record("start", pid=os.getpid())

    def stats_fn() -> Dict:
        st = _engine_stats(holder[0], progress)
        st["flightrec"] = rec.drain_new()
        return st

    transport.send(("register", worker_id, "rollout", os.getpid()))
    with _heartbeat(transport, worker_id, stats_fn, cfg["heartbeat_s"], stop):
        try:
            engine = holder[0] = factory(**factory_kwargs)
            rec.record("engine_built")
        except BaseException:                 # noqa: BLE001 — shipped upstream
            rec.record("build_error")
            transport.send(("error", worker_id, traceback.format_exc()))
            return
        pending_weights: Optional[tuple] = None
        admit_q: collections.deque = collections.deque()
        wmsg_q: collections.deque = collections.deque()
        chunks_per_step = int(cfg.get("stream_chunks_per_step", 8))
        draining = drained_sent = False
        try:
            while True:
                progress["loops"] += 1
                idle = engine.n_active == 0 and not admit_q and not wmsg_q
                msg = transport.recv(cfg["idle_sleep"] if idle else 0.0)
                while msg is not None:
                    kind = msg[0]
                    if kind == "admit":
                        admit_q.append((msg[1], msg[2]))
                    elif kind == "weights":   # keep only the newest version
                        pending_weights = (msg[1], msg[2])
                    elif kind == "wmsg":      # streamed chunk message
                        wmsg_q.append(msg[1])
                    elif kind == "drain":
                        rec.record("drain")
                        draining = True
                    elif kind == "stop":
                        rec.record("stop")
                        _stop_worker(transport, worker_id, stats_fn, stop)
                        return
                    msg = transport.recv(0.0)
                if (pending_weights is not None
                        and pending_weights[0] > engine.version):
                    version, params = pending_weights
                    engine.update_weights(_to_device(params, getattr(engine, "model", None)),
                                          version, interruptible=cfg["interruptible"])
                    rec.record("weights", version=version)
                pending_weights = None
                # streaming pickup (DESIGN.md §Version fence): feed a bounded
                # number of chunk messages per loop so staging overlaps the
                # decode step below; the engine's weights flip only when a
                # stream completes
                fed = 0
                while wmsg_q and fed < chunks_per_step:
                    if engine.feed_weight_message(
                            wmsg_q.popleft(),
                            interruptible=cfg["interruptible"]):
                        rec.record("stream_flip", version=engine.version)
                    fed += 1
                need_full = getattr(engine, "consume_stream_need_full", None)
                if callable(need_full) and need_full():
                    rec.record("need_full", version=engine.version)
                    # decoder lost the base (missed a publication): ask the
                    # supervisor for one full tree to resynchronize
                    # (DESIGN.md §Torn-stream recovery)
                    transport.send(("need_full", worker_id))
                engine.maybe_apply_pending()
                while admit_q and not engine.has_pending_weights:
                    reqs, clock = admit_q.popleft()
                    n = 0 if draining else engine.admit(reqs, clock=clock)
                    progress["admits"] += n > 0
                    rec.record("admit", rids=reqs_key(reqs), n=n)
                    transport.send(("admitted", worker_id, reqs_key(reqs), n,
                                    getattr(engine, "deferred_last", 0)))
                if engine.n_active:
                    finished = engine.step()
                    progress["steps"] += 1
                    if finished:
                        rec.record("finished", rids=[f.rid for f in finished])
                        transport.send(("finished", worker_id, finished))
                    drained_sent = False
                elif draining and not drained_sent and not admit_q:
                    rec.record("drained")
                    transport.send(("drained", worker_id))
                    drained_sent = True
        except (EOFError, BrokenPipeError, OSError):
            return                            # supervisor is gone: just exit
        except BaseException as e:            # noqa: BLE001 — shipped upstream
            rec.record("error", exc=type(e).__name__)
            try:
                transport.send(("error", worker_id, traceback.format_exc()))
            except (OSError, ValueError):
                pass


def _trainer_worker_main(worker_id: str, conn, factory: Callable,
                         factory_kwargs: Dict, cfg: Dict) -> None:
    """Trainer replica process: a stateless train-step executor.  Every
    'train' message carries the batch AND the canonical (weights,
    optimizer state, version) host state, copied into the replica's
    own tensors; the reply carries the updated state's host form back —
    so any replica can run any step and a replica crash loses nothing
    but the in-progress step, which the pump resends (DESIGN.md §Fleet
    runtime)."""
    transport = PipeTransport(conn)
    stop = threading.Event()
    # step_s: per step, the seconds of the shipped state's copy into the
    # replica, of its train_step and of the reply's host copy
    progress = {"steps": 0, "microbatches": 0, "step_s": []}
    rec = FlightRecorder(capacity=int(cfg.get("flightrec_cap", 256)))
    rec.record("start", pid=os.getpid())

    def stats_fn() -> Dict:
        st = dict(progress, step_s=list(progress["step_s"]))
        st.update(_process_stats(progress))
        st["flightrec"] = rec.drain_new()
        return st

    transport.send(("register", worker_id, "trainer", os.getpid()))
    with _heartbeat(transport, worker_id, stats_fn, cfg["heartbeat_s"], stop):
        try:
            trainer = factory(**factory_kwargs)
        except BaseException:                 # noqa: BLE001 — shipped upstream
            transport.send(("error", worker_id, traceback.format_exc()))
            return
        model = getattr(trainer, "model", None)
        try:
            while True:
                msg = transport.recv(0.5)
                if msg is None:
                    continue
                if msg[0] == "stop":
                    _stop_worker(transport, worker_id, stats_fn, stop)
                    return
                if msg[0] == "train":
                    _, batch, params, opt_state, version = msg
                    del msg
                    t0 = time.perf_counter()
                    if params is not None:
                        load_host_weights(model, params)
                    if opt_state is not None:
                        load_host_opt_state(trainer.opt_state, opt_state)
                    del params, opt_state     # the host copies go before the step
                    trainer.version = version
                    t1 = time.perf_counter()
                    metrics = trainer.train_step(batch)
                    t2 = time.perf_counter()
                    reply = ("trained", worker_id, trainer.version, metrics,
                             None if model is None else host_weights(model),
                             host_opt_state(getattr(trainer, "opt_state", None)))
                    progress["steps"] += 1
                    progress["microbatches"] += metrics.n_microbatches
                    progress["step_s"].append((t1 - t0, t2 - t1, time.perf_counter() - t2))
                    rec.record("train", version=trainer.version)
                    transport.send(reply)
                    del reply
        except (EOFError, BrokenPipeError, OSError):
            return
        except BaseException:                 # noqa: BLE001 — shipped upstream
            try:
                transport.send(("error", worker_id, traceback.format_exc()))
            except (OSError, ValueError):
                pass


def reqs_key(reqs: List[Dict]) -> List[int]:
    return [r["rid"] for r in reqs]


# ---- default factories (spawn-picklable builders for real models) ----------
def _model(model_cfg, seed: int, device, dtype):
    """The LM ``run_training`` builds, on ``device``: initialised from
    ``seed`` by a generator on that device, so every process on one
    device starts from the same weights with no initial broadcast."""
    from repro_torch.device import resolve
    from repro_torch.models.model import build_model

    dev = resolve(device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return build_model(model_cfg, device=dev, dtype=dtype).init(
        torch.Generator(device=dev).manual_seed(seed))


def build_engine(*, model_cfg, seed: int, engine_kwargs: Dict, device="cuda",
                 dtype="float32"):
    """Default rollout-engine factory: tiny-to-real models built from a
    picklable ``ModelConfig`` on ``device`` (the card unless the caller
    asks for the CPU), weights of ``dtype`` (a name, e.g. "float32")."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine

    model = _model(model_cfg, seed, device, dtype)
    return RolloutEngine(model, EngineConfig(seed=seed, **engine_kwargs),
                         device=model.device)


def build_trainer(*, model_cfg, rl, seed: int, pack_rows: int = 1, device="cuda"):
    """Default trainer-replica factory (see ``build_engine``; f32
    weights, as ``run_training`` trains)."""
    from repro_torch.core.trainer import PPOTrainer

    return PPOTrainer(_model(model_cfg, seed, device, torch.float32), rl,
                      pack_rows=pack_rows)


# ---- supervisor-side worker handle + registry -------------------------------
@dataclass
class WorkerHandle:
    """Supervisor-side record of one worker process (DESIGN.md
    §Supervision state machine).  ``state`` walks
    starting -> ready -> (draining -> drained ->) stopping -> stopped,
    with dead reachable from any live state.  ``max_gap`` is the longest
    time between two of its messages as the supervisor dispatched them;
    ``last_stats`` its stats when it retired."""
    worker_id: str
    role: str                             # "rollout" | "trainer"
    proc: Any
    transport: PipeTransport
    state: str = "starting"
    spawned: float = field(default_factory=time.monotonic)
    last_beat: Optional[float] = None     # None until the first message
    beats: int = 0
    max_gap: float = 0.0
    stats: Dict = field(default_factory=dict)
    last_stats: Dict = field(default_factory=dict)
    sent_admits: collections.deque = field(default_factory=collections.deque)

    @property
    def live(self) -> bool:
        return self.state in ("starting", "ready", "draining", "drained",
                              "stopping")


class FleetRegistry:
    """Service discovery for the fleet: who exists, in which role and
    state, when it last beat — plus the supervision event log the tests
    and diagnostics read (DESIGN.md §Supervision state machine)."""

    def __init__(self):
        self._workers: Dict[str, WorkerHandle] = {}
        self._lock = threading.RLock()
        self.events: List[Dict] = []
        # counters folded in from dead/stopped workers so fleet totals
        # survive respawns
        self.retired: Dict[str, int] = {"tokens_generated": 0, "interruptions": 0,
                                        **{k: 0 for k in LAUNCH_KEYS}}

    def add(self, h: WorkerHandle) -> None:
        with self._lock:
            self._workers[h.worker_id] = h

    def get(self, worker_id: str) -> Optional[WorkerHandle]:
        with self._lock:
            return self._workers.get(worker_id)

    def workers(self, role: Optional[str] = None) -> List[WorkerHandle]:
        with self._lock:
            return [h for h in self._workers.values()
                    if role is None or h.role == role]

    def live(self, role: Optional[str] = None) -> List[WorkerHandle]:
        return [h for h in self.workers(role) if h.live]

    def ready(self, role: Optional[str] = None) -> List[WorkerHandle]:
        return [h for h in self.workers(role) if h.state == "ready"]

    def retire(self, h: WorkerHandle, state: str) -> None:
        with self._lock:
            h.state = state
            for k in self.retired:
                self.retired[k] += int(h.stats.get(k, 0))
            if h.stats:
                h.last_stats = h.stats
            h.stats = {}

    def total(self, key: str) -> int:
        with self._lock:
            return (self.retired.get(key, 0)
                    + sum(int(h.stats.get(key, 0))
                          for h in self._workers.values() if h.live))

    def note(self, kind: str, **info) -> None:
        with self._lock:
            self.events.append({"kind": kind, "t": time.monotonic(), **info})

    def events_of(self, kind: str) -> List[Dict]:
        with self._lock:
            return [e for e in self.events if e["kind"] == kind]


# ---- the fleet runtime ------------------------------------------------------
class FleetRuntime(SchedulerExecutorMixin):
    """Process-backed executor for ``AsyncScheduler`` (DESIGN.md §Fleet
    runtime): N rollout worker processes + M trainer replicas under a
    supervising main process.  Implements the shared executor protocol
    (``core/runtime.py``): ``run(n_steps, timeout)`` -> StepLog history,
    plus the ``SchedulerExecutorMixin`` surface.

    Parameters
    ----------
    scheduler : the shared policy core.  Admission planning, Eq. 3
        accounting and requeue all happen HERE, in the supervisor.
    engine_factory / engine_factory_kwargs : module-level callable (and
        picklable kwargs) each rollout worker invokes to build its
        engine.  For trajectory equivalence with ``ThreadedRuntime``
        build the engine with ``rng="request"``.
    trainer_factory / trainer_factory_kwargs : same for trainer replicas.
    rollout_workers / trainer_procs : initial fleet size (N >= 1, M >= 1).
    elastic : enable grow/shrink between ``min_workers`` and
        ``max_workers`` driven by capacity starvation vs
        ``scheduler.saturated()`` (DESIGN.md §Elastic policy).
    heartbeat_s / heartbeat_timeout / startup_timeout : supervision
        cadence (DESIGN.md §Supervision state machine).
    max_respawns : unexpected worker failures tolerated before the run
        aborts (crash-loop guard).
    worker_env : extra environment variables for worker processes (e.g.
        ``OMP_NUM_THREADS``).
    weight_stream : ``"full"`` (default) broadcasts whole state dicts;
        ``"delta"`` / ``"delta-q"`` encode each publication once against
        the previous one and fan the chunk messages out to every worker
        (DESIGN.md §Streaming weight publication).  Late joiners still
        get a full tree at registration, and a worker whose decoder
        loses its base sends ``need_full`` to resynchronize.
    stream_chunk_elems : elements per chunk when streaming.
    stream_chunks_per_step : max chunk messages a worker feeds per loop.
    """

    def __init__(self, *, scheduler: AsyncScheduler,
                 engine_factory: Callable, engine_factory_kwargs: Dict,
                 trainer_factory: Callable, trainer_factory_kwargs: Dict,
                 n_slots: int, rollout_workers: int = 2,
                 trainer_procs: int = 1,
                 store: Optional[ParameterStore] = None,
                 elastic: bool = False, min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 elastic_interval: float = 0.25,
                 heartbeat_s: float = 0.05, heartbeat_timeout: float = 2.0,
                 startup_timeout: float = 120.0, max_respawns: int = 3,
                 worker_env: Optional[Dict[str, str]] = None,
                 idle_sleep: float = 1e-3,
                 weight_stream: str = "full",
                 stream_chunk_elems: int = 65536,
                 stream_chunks_per_step: int = 8,
                 flightrec_dir: Optional[str] = None):
        if rollout_workers < 1 or trainer_procs < 1:
            raise ValueError("a fleet needs at least one rollout worker and one "
                             "trainer replica")
        self.sched = scheduler
        self.rl = scheduler.rl
        self.engine_factory = engine_factory
        self.engine_factory_kwargs = engine_factory_kwargs
        self.trainer_factory = trainer_factory
        self.trainer_factory_kwargs = trainer_factory_kwargs
        self.n_slots = n_slots
        self.trainer_procs = trainer_procs
        self.store = store or ParameterStore()
        self.store.subscribe(self._broadcast_weights)
        self.elastic = elastic
        self.min_workers = min_workers
        self.max_workers = max_workers or max(rollout_workers * 2,
                                              rollout_workers + 1)
        self.elastic_interval = elastic_interval
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout = heartbeat_timeout
        self.startup_timeout = startup_timeout
        self.max_respawns = max_respawns
        self.worker_env = worker_env
        self.idle_sleep = idle_sleep
        if weight_stream not in ENCODINGS:
            raise ValueError(f"weight_stream must be one of {ENCODINGS}, "
                             f"got {weight_stream!r}")
        self.weight_stream = weight_stream
        self.stream_chunk_elems = stream_chunk_elems
        self.stream_chunks_per_step = stream_chunks_per_step
        self._stream_base = None          # previous published host tree
        self._stream_base_version: Optional[int] = None

        # supervisor-side accumulation of each worker's shipped
        # flight-recorder tail (DESIGN.md §Flight-recorder protocol);
        # dumped to ``flightrec_dir`` when a worker is failed
        import tempfile
        self.flightrec_dir = flightrec_dir or os.path.join(
            tempfile.gettempdir(), "repro-flightrec")
        self._flightrec: Dict[str, FlightRecorder] = {}

        self.registry = FleetRegistry()
        self._ctx = mp.get_context("spawn")   # never fork a CUDA process
        self._target_workers = rollout_workers
        self._next_idx: Dict[str, int] = {"rollout": 0, "trainer": 0}
        self._failures = 0
        self.respawns = 0
        self.duplicates_dropped = 0
        self._done_rids: set = set()

        self._version = 0                 # canonical policy version
        self._params_np = None            # canonical host-side state
        self._opt_np = None
        self._trained_q: Queue = Queue()
        self._stop = threading.Event()
        self._errors: List[BaseException] = []
        self._last_elastic = 0.0
        self._last_pump_beat: Optional[float] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._sup_thread: Optional[threading.Thread] = None

        self.clock = 0.0
        self._t0 = 0.0
        # overlap accounting, name-compatible with ThreadedRuntime
        self.trainer_busy_s = 0.0
        self.tokens_during_train = 0
        self._train_busy = False

    # ---- executor protocol surface ----------------------------------------
    @property
    def requeued(self) -> int:
        return self.sched.requeued_total

    @property
    def version(self) -> int:
        return self._version

    @property
    def trainer(self):
        """Duck-typed ``.version``/``.params`` view of the canonical trainer
        state, so launch code written against ``ThreadedRuntime.trainer``
        reads the version unchanged (``.params`` is the host state dict)."""
        return _TrainerView(self)

    def effective_throughput(self) -> float:
        return self.sched.tokens_consumed() / max(self.clock, 1e-9)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # ---- spawning ----------------------------------------------------------
    def _spawn(self, role: str) -> WorkerHandle:
        idx = self._next_idx[role]
        self._next_idx[role] = idx + 1
        worker_id = f"{role}-{idx}"
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        if role == "rollout":
            target, factory, kwargs = (_rollout_worker_main,
                                       self.engine_factory,
                                       self.engine_factory_kwargs)
        else:
            target, factory, kwargs = (_trainer_worker_main,
                                       self.trainer_factory,
                                       self.trainer_factory_kwargs)
        cfg = {"heartbeat_s": self.heartbeat_s,
               "idle_sleep": self.idle_sleep,
               "interruptible": self.rl.interruptible,
               "stream_chunks_per_step": self.stream_chunks_per_step}
        proc = self._ctx.Process(
            target=target, name=f"areal-{worker_id}",
            args=(worker_id, child_conn, factory, kwargs, cfg), daemon=True)
        saved = {}
        if self.worker_env:               # spawn inherits os.environ: set
            for k, v in self.worker_env.items():    # around start, restore
                saved[k] = os.environ.get(k)        # for the supervisor
                os.environ[k] = v
        try:
            proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        child_conn.close()                # supervisor keeps only its end
        h = WorkerHandle(worker_id=worker_id, role=role, proc=proc,
                         transport=PipeTransport(parent_conn))
        self.registry.add(h)
        self.registry.note("spawn", worker=worker_id, role=role,
                           pid=proc.pid)
        return h

    # ---- supervisor loop ----------------------------------------------------
    def _supervise_loop(self) -> None:
        try:
            while not self._stop.is_set():
                conns = {h.transport.raw: h
                         for h in self.registry.workers() if h.live}
                if conns:
                    for c in mpc.wait(list(conns), timeout=0.05):
                        self._drain_transport(conns[c])
                else:
                    time.sleep(0.05)
                self._check_liveness()
                self._plan_admissions()
                if self.elastic:
                    self._elastic_tick()
        except BaseException as e:        # noqa: BLE001 — surfaced in run()
            self._errors.append(e)
            self._stop.set()

    def _drain_transport(self, h: WorkerHandle) -> None:
        """Dispatch every message the worker has delivered.  EOF is not
        an error here: a crashed worker's already-delivered messages
        (e.g. a 'finished' sent just before dying) are salvaged so its
        trajectories are not regenerated (DESIGN.md §Requeue
        semantics)."""
        while True:
            try:
                msg = h.transport.recv(0.0)
            except (EOFError, OSError):
                return                    # peer gone; liveness check acts
            if msg is None:
                return
            self._dispatch(h, msg)

    def _dispatch(self, h: WorkerHandle, msg: tuple) -> None:
        kind = msg[0]
        now = time.monotonic()
        if h.last_beat is not None:
            h.max_gap = max(h.max_gap, now - h.last_beat)
        h.last_beat = now                 # any message proves liveness
        if kind == "heartbeat":
            h.beats += 1
            self._absorb(h, msg[3])
        elif kind == "register":
            if h.state == "starting":
                h.state = "ready"
            self.registry.note("register", worker=h.worker_id, role=h.role)
            if h.role == "rollout" and self._params_np is not None:
                try:
                    h.transport.send(("weights", self._version,
                                      self._params_np))
                except (OSError, ValueError):
                    pass
        elif kind == "admitted":
            _, _, rids, n, deferred = msg
            if h.sent_admits:
                reqs = h.sent_admits.popleft()
                self.sched.acked(h.worker_id, reqs, n, deferred=deferred)
        elif kind == "finished":
            kept = []
            for f in msg[2]:
                if f.rid in self._done_rids:
                    self.duplicates_dropped += 1
                    continue
                self._done_rids.add(f.rid)
                self.sched.finished_inflight(f.rid)
                kept.append(f)
            if kept:
                if self._train_busy:
                    self.tokens_during_train += sum(len(f.response)
                                                    for f in kept)
                self.sched.collect(kept, finish_time=self._now())
        elif kind == "drained":
            if h.state == "draining":
                self.registry.note("drained", worker=h.worker_id)
                h.state = "stopping"
                try:
                    h.transport.send(("stop",))
                except (OSError, ValueError):
                    pass
        elif kind == "stopped":
            self._absorb(h, msg[2])
            self.registry.retire(h, "stopped")
        elif kind == "need_full":
            # a streaming worker lost its delta base (missed or torn
            # publication): resynchronize it with one full tree
            # (DESIGN.md §Torn-stream recovery)
            if self._params_np is not None:
                try:
                    h.transport.send(("weights", self._version,
                                      self._params_np))
                except (OSError, ValueError):
                    pass
        elif kind == "trained":
            self._trained_q.put(msg)
        elif kind == "error":
            self.registry.note("worker-error", worker=h.worker_id,
                               traceback=msg[2])
            self._fail_worker(h, reason="error")

    def _absorb(self, h: WorkerHandle, stats: Dict) -> None:
        """Fold a worker's stats (a beat's, or its last with 'stopped')
        into its handle."""
        payload = dict(stats)
        entries = payload.pop("flightrec", None)
        if entries:                       # worker's shipped recorder tail
            self.flight_recorder(h.worker_id).extend(entries)
        prev_v = h.stats.get("version")
        h.stats.update(payload)
        new_v = h.stats.get("version")
        if new_v is not None and new_v != prev_v:
            # first heartbeat at a new version = publication pickup
            # observed (note_pickup ignores never-published versions,
            # e.g. the initial v0)
            self.sched.note_pickup(new_v, self._now(), who=h.worker_id)

    # ---- supervision: liveness, failure, requeue, respawn -------------------
    def _silent(self, h: WorkerHandle, now: float) -> bool:
        if h.last_beat is None:
            return now - h.spawned > self.startup_timeout
        return now - h.last_beat > self.heartbeat_timeout

    def _check_liveness(self) -> None:
        now = time.monotonic()
        for h in self.registry.workers():
            if not h.live:
                continue
            if h.state == "stopping":
                if not h.proc.is_alive():
                    self.registry.retire(h, "stopped")
                continue
            dead = not h.proc.is_alive()
            silent = self._silent(h, now)
            if silent and not dead:
                # beats may sit unread behind a large message this thread
                # was receiving from another worker: read them first
                self._drain_transport(h)
                silent = self._silent(h, time.monotonic())
            if dead or silent:
                self._fail_worker(h, reason="crashed" if dead else "hung")

    def _fail_worker(self, h: WorkerHandle, reason: str) -> None:
        """The supervision failure path (DESIGN.md §Supervision state
        machine): salvage delivered messages, kill what still runs,
        requeue what the worker owed, respawn a replacement.
        Idempotent per worker — a second diagnosis (e.g. an 'error'
        message salvaged while already handling the crash) is a no-op,
        which is what makes double-requeue impossible."""
        if h.state in ("dead", "stopped"):
            return
        h.state = "dead"                  # re-entrancy guard (see above)
        self._drain_transport(h)
        if h.proc.is_alive():             # hung (e.g. SIGSTOP): force out
            h.proc.terminate()
            h.proc.join(2.0)
            if h.proc.is_alive():
                h.proc.kill()
                h.proc.join(2.0)
        hung = reason == "hung"
        self.registry.note("worker-dead", worker=h.worker_id, role=h.role,
                           reason=reason, hung=hung)
        self._dump_flightrec(h.worker_id, reason)
        self.registry.retire(h, "dead")
        h.transport.close()
        h.sent_admits.clear()
        if h.role == "rollout":
            requeued = self.sched.requeue_worker(h.worker_id)
            if requeued:
                self.registry.note("requeue", worker=h.worker_id,
                                   rids=reqs_key(requeued))
        self._failures += 1
        if self._failures > self.max_respawns:
            self._errors.append(RuntimeError(
                f"fleet exceeded max_respawns={self.max_respawns}: "
                f"last failure {h.worker_id} ({reason})"))
            self._stop.set()
            return
        if self._stop.is_set():
            return
        if h.role == "rollout":
            alive = len(self.registry.live("rollout"))
            if alive < self._target_workers:
                self._spawn("rollout")
                self.respawns += 1
        else:
            alive = len(self.registry.live("trainer"))
            if alive < self.trainer_procs:
                self._spawn("trainer")
                self.respawns += 1

    # ---- admission planning -------------------------------------------------
    def _plan_admissions(self) -> None:
        for h in self.registry.ready("rollout"):
            cap = self.n_slots - len(self.sched.inflight_of(h.worker_id))
            if cap <= 0:
                continue
            reqs = self.sched.plan_admission(cap)
            if not reqs:
                return                    # nothing admissible fleet-wide
            self.sched.assign(h.worker_id, reqs)
            h.sent_admits.append(reqs)
            try:
                h.transport.send(("admit", reqs, self._now()))
            except (OSError, ValueError):
                pass                      # liveness check will requeue

    # ---- elastic policy -----------------------------------------------------
    def _elastic_tick(self) -> None:
        now = time.monotonic()
        if now - self._last_elastic < self.elastic_interval:
            return
        self._last_elastic = now
        ready = self.registry.ready("rollout")
        live = self.registry.live("rollout")
        draining = [h for h in live if h.state in ("draining", "drained",
                                                   "stopping")]
        if self.sched.saturated():
            # scoring is the bottleneck: shrink (graceful drain — the
            # victim delivers every in-flight trajectory before stopping,
            # so nothing unscored is dropped)
            if len(ready) > self.min_workers and not draining:
                victim = min(ready, key=lambda h: len(
                    self.sched.inflight_of(h.worker_id)))
                victim.state = "draining"
                self._target_workers = max(self.min_workers,
                                           self._target_workers - 1)
                self.registry.note("shrink", worker=victim.worker_id)
                try:
                    victim.transport.send(("drain",))
                except (OSError, ValueError):
                    pass
        else:
            # generation is the bottleneck: grow while every ready
            # worker is full and Eq. 3 still allows submissions
            active = [h for h in ready if h.state == "ready"]
            full = active and all(
                len(self.sched.inflight_of(h.worker_id)) >= self.n_slots
                for h in active)
            growing = any(h.state == "starting" for h in live)
            if (full and not growing and self.sched.stal.can_submit(1)
                    and len(live) - len(draining) < self.max_workers):
                self._target_workers = min(self.max_workers,
                                           self._target_workers + 1)
                self._spawn("rollout")
                self.registry.note("grow", fleet=len(live) + 1)

    # ---- trainer pump -------------------------------------------------------
    def _pick_trainer(self) -> Optional[WorkerHandle]:
        while not self._stop.is_set():
            ready = self.registry.ready("trainer")
            if ready:
                return ready[self._version % len(ready)]
            time.sleep(0.02)
        return None

    def _train_remote(self, batch) -> Optional[tuple]:
        """Ship one batch to a trainer replica and wait for the reply.
        The batch stays owned by the pump until a reply lands, so a
        replica crash mid-step costs a resend, never a lost batch."""
        msg_out = ("train", batch, self._params_np, self._opt_np,
                   self._version)
        while not self._stop.is_set():
            replica = self._pick_trainer()
            if replica is None:
                return None
            self._train_busy = True
            t0 = time.perf_counter()
            try:
                replica.transport.send(msg_out)
            except (OSError, ValueError):
                self._train_busy = False
                continue
            reply = None
            while reply is None:
                try:
                    reply = self._trained_q.get(timeout=0.2)
                except Empty:
                    if self._stop.is_set() or not replica.live:
                        break
            self._train_busy = False
            self.trainer_busy_s += time.perf_counter() - t0
            if reply is None:
                self.registry.note("train-resend", worker=replica.worker_id)
                continue                  # replica died mid-step: resend
            return reply
        return None

    def _pump_loop(self, target: int) -> None:
        try:
            while self._version < target and not self._stop.is_set():
                self._last_pump_beat = time.monotonic()
                batch = self.sched.buffer.pop_batch(self.rl.batch_size,
                                                    timeout=0.2)
                if batch is None:
                    if self.sched.buffer.closed:
                        break
                    continue
                self.sched.record_consumed(batch)
                with trace.span("trainer.train_step",
                                version=self._version + 1, n=len(batch)):
                    reply = self._train_remote(batch)
                if reply is None:
                    break
                _, _, new_version, metrics, params_np, opt_np = reply
                self._params_np, self._opt_np = params_np, opt_np
                self._version = new_version
                self.sched.note_published(new_version, self._now())
                self.store.publish(new_version, params_np)
                self.sched.note_policy_update(new_version)
                self.sched.log_step(
                    metrics, version=new_version, clock=self._now(),
                    gen_tokens_total=self.registry.total("tokens_generated"),
                    interruptions=self.registry.total("interruptions"))
        except BaseException as e:        # noqa: BLE001 — surfaced in run()
            self._errors.append(e)
        finally:
            self._stop.set()

    # ---- weight publication -------------------------------------------------
    def _broadcast_weights(self, version: int, params) -> None:
        """ParameterStore subscriber: fan one publication out to every
        live rollout worker (DESIGN.md §Weight-publication path; the
        multi-subscriber form of the threaded runtime's store poll).
        In stream mode the tree is delta-encoded ONCE against the
        previous publication and the chunk messages fan out individually
        (DESIGN.md §Streaming weight publication) — each worker feeds
        them into its version-fenced decoder between decode steps."""
        if params is not None:
            params = dict(params)         # the store's Published, as a plain dict
        msgs: List[tuple]
        if self.weight_stream != "full":
            stream = encode_stream(
                params, version=version, base=self._stream_base,
                base_version=self._stream_base_version,
                encoding=self.weight_stream,
                chunk_elems=self.stream_chunk_elems)
            self._stream_base = params
            self._stream_base_version = version
            msgs = [("wmsg", m) for m in stream]
        else:
            msgs = [("weights", version, params)]
        for h in self.registry.workers("rollout"):
            if h.state not in ("ready", "draining"):
                continue
            try:
                for m in msgs:
                    h.transport.send(m)
            except (OSError, ValueError):
                pass                      # liveness check handles the rest

    # ---- diagnostics --------------------------------------------------------
    def flight_recorder(self, worker_id: str) -> FlightRecorder:
        """Supervisor-side copy of one worker's flight-recorder tail,
        accumulated from heartbeats (DESIGN.md §Flight-recorder
        protocol).  Survives the worker's death — this is the record a
        SIGKILL post-mortem reads."""
        rec = self._flightrec.get(worker_id)
        if rec is None:
            rec = self._flightrec[worker_id] = FlightRecorder(capacity=256)
        return rec

    def _dump_flightrec(self, worker_id: str, reason: str) -> Optional[str]:
        """Dump one worker's tail to ``flightrec_dir`` on failure."""
        rec = self._flightrec.get(worker_id)
        if rec is None or not len(rec):
            return None
        path = os.path.join(self.flightrec_dir,
                            f"{worker_id}-{reason}.json")
        try:
            rec.dump(path)
        except OSError:
            return None
        self.registry.note("flightrec-dump", worker=worker_id,
                           path=path, events=len(rec))
        return path

    def _flightrec_tails(self, per_worker: int = 6) -> str:
        parts = [f"{wid}: {rec.format_tail(per_worker)}"
                 for wid, rec in sorted(self._flightrec.items()) if len(rec)]
        return "; ".join(parts) if parts else "(empty)"

    def liveness(self) -> List[RoleLiveness]:
        """Per-role liveness snapshot (shared diagnostic format with
        ``ThreadedRuntime.run``'s TimeoutError — DESIGN.md §Supervision
        state machine)."""
        now = time.monotonic()
        roles = []
        for h in self.registry.workers():
            if h.state in ("stopped",):
                continue
            age = None if h.last_beat is None else now - h.last_beat
            st = h.stats
            detail = f"state={h.state}"
            if h.role == "rollout" and st:
                detail += (f" active={st.get('n_active', '?')}"
                           f" v={st.get('version', '?')}")
                if st.get("drafted_tokens"):
                    detail += f" accept={st.get('draft_acceptance_rate', 0.0):.2f}"
            roles.append(RoleLiveness(f"{h.role}:{h.worker_id}",
                                      h.proc.is_alive(), age, detail))
        pump = self._pump_thread
        pump_age = (None if self._last_pump_beat is None
                    else now - self._last_pump_beat)
        roles.append(RoleLiveness(
            "trainer-pump", bool(pump and pump.is_alive()), pump_age,
            f"version={self._version}"))
        return roles

    # ---- entry point --------------------------------------------------------
    def run(self, n_steps: int,
            timeout: Optional[float] = None) -> List[StepLog]:
        """Run until the canonical trainer state advances ``n_steps``
        versions.  The fleet stays up between runs (workers keep their
        in-flight slots, exactly like ``ThreadedRuntime``'s engine) —
        call ``close()`` when done.  On ``timeout`` the whole fleet is
        torn down and TimeoutError carries the per-role liveness
        diagnostics (shared format with ``ThreadedRuntime.run``)."""
        target = self._version + n_steps
        self._stop.clear()
        self._errors.clear()
        svc = getattr(self.sched, "reward_service", None)
        if svc is not None:
            svc.start()
        self._t0 = time.perf_counter()
        for _ in range(self.trainer_procs
                       - len(self.registry.live("trainer"))):
            self._spawn("trainer")
        for _ in range(self._target_workers
                       - len(self.registry.live("rollout"))):
            self._spawn("rollout")
        self._sup_thread = threading.Thread(
            target=self._supervise_loop, name="areal-fleet-supervisor",
            daemon=True)
        self._pump_thread = threading.Thread(
            target=self._pump_loop, args=(target,),
            name="areal-fleet-pump", daemon=True)
        self._sup_thread.start()
        self._pump_thread.start()
        self._pump_thread.join(timeout)
        if self._pump_thread.is_alive():
            liveness = format_liveness(self.liveness())
            # per-worker streaming-pickup counters arrive on heartbeats;
            # aggregate them before teardown wipes handle stats
            stream = {k: self.registry.total(k)
                      for k in ("streams_completed", "streams_torn")}
            self._stop.set()
            self._pump_thread.join(10.0)
            self.close()
            for wid in list(self._flightrec):
                self._dump_flightrec(wid, "timeout")
            self.clock = time.perf_counter() - self._t0
            raise TimeoutError(
                f"fleet runtime exceeded {timeout}s at version "
                f"{self._version}/{target} "
                f"(buffered={len(self.sched.buffer)}, "
                f"unscored={self.sched.pending_rewards()}, "
                f"requeued={self.requeued}, respawns={self.respawns}): "
                + liveness
                + f"; publication={self.sched.publication_stats()}"
                + f"; stream={stream}"
                + f"; flight-recorder tails: {self._flightrec_tails()}")
        self._sup_thread.join(10.0)
        self.clock = time.perf_counter() - self._t0
        if self._errors:
            self.close()
            raise self._errors[0]
        return self.sched.history

    def close(self) -> None:
        """Tear the fleet down (idempotent): stop every worker process,
        then the supervisor thread."""
        self._shutdown()

    def _final_messages(self, h: WorkerHandle, deadline: float) -> None:
        """Read up to a stopping worker's 'stopped', which carries its
        last stats and retires it; what it sent before is dropped."""
        while h.state == "stopping" and time.monotonic() < deadline:
            try:
                msg = h.transport.recv(min(0.1, max(0.0, deadline - time.monotonic())))
            except (EOFError, OSError):
                return
            if msg is not None and msg[0] == "stopped":
                self._dispatch(h, msg)

    def _shutdown(self) -> None:
        """Stop the supervisor thread, then every worker process, reading
        each one's last beat.  A worker wedged mid-send on a full pipe
        cannot see 'stop'; the escalation terminate -> kill bounds
        shutdown regardless."""
        self._stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(5.0)
        # read the workers' last stats only where no other thread still
        # reads (a supervisor thread inside a long message)
        reading = self._sup_thread is None or not self._sup_thread.is_alive()
        for h in self.registry.workers():
            if h.live:
                h.state = "stopping"
                try:
                    h.transport.send(("stop",))
                except (OSError, ValueError):
                    pass
        deadline = time.monotonic() + 5.0
        for h in self.registry.workers():
            if reading:
                self._final_messages(h, deadline)
            h.proc.join(max(0.0, deadline - time.monotonic()))
            if h.proc.is_alive():
                h.proc.terminate()
                h.proc.join(1.0)
            if h.proc.is_alive():
                h.proc.kill()
                h.proc.join(1.0)
            if h.state != "stopped":
                self.registry.retire(h, "stopped")
        for h in self.registry.workers():
            h.transport.close()


class _TrainerView:
    """``.version``/``.params`` proxy over the fleet's canonical trainer
    state (see ``FleetRuntime.trainer``): ``params`` is the host state
    dict (``host_weights``'s form) of the last version, None before the
    first."""

    def __init__(self, rt: FleetRuntime):
        self._rt = rt

    @property
    def version(self) -> int:
        return self._rt._version

    @property
    def params(self):
        return self._rt._params_np

"""Versioned parameter store and streaming delta publication (DESIGN.md
§Weight-publication path; DESIGN.md §Streaming weight publication),
after ``repro/core/weights.py``.

The trainer publishes (version, weights); rollout workers pull the
latest, and ``get`` reaches the last ``keep`` versions.  Subscribers
(``subscribe``) hear of every publication, outside the store's lock, on
the publishing thread, in registration order.  With ``ckpt_dir`` and
``ckpt_every`` every ``ckpt_every``-th version is spilled to
``<ckpt_dir>/v<version>.npz`` (``checkpoint/io.py``'s format) by a
background writer thread: the publishing thread only takes the host copy
it hands over, so no disk write delays a publication.  ``flush`` waits
for the queued spills, ``close`` also stops the writer and re-raises its
first error.

The reference publishes an immutable parameter tree, so a stored version
can never change.  The port's trainer updates its ``LM`` in place, so
``publish`` of a model stores a detached copy of every tensor of its
state dict (a ``Published`` dict): a published version stays as it was
however the trainer goes on.  A dict is stored as given: the caller hands
over a copy of its own (``launch/disaggregated.py::push_weights``).

Two threads on one card (``core/runtime.py``): the copy is made on the
publishing thread's CUDA stream, and ``Published.ready`` is an event
recorded on that stream after it.  ``acquire`` makes the reading
thread's stream wait for that event and marks the tensors as used by
that stream, so the caching allocator keeps their memory from the
publisher's stream until the reader's queued work is done, even after
the store has evicted the version.

Streaming publication (DESIGN.md §Streaming weight publication):
``encode_stream`` frames one publication as an ordered ``WeightStream``
of messages — ``StreamBegin``, per-leaf ``WeightChunk``s, ``StreamEnd``
— that a receiver reassembles with ``StreamDecoder``.  A tree here is an
ordered dict from state-dict names to HOST arrays (numpy; see
``host_weights``, which keeps bf16 as its raw ``uint16`` bits, as the
reference's bf16 is an opaque numpy dtype, and ``device_leaf``, which
rebuilds a leaf on the device).
Three encodings:

  * ``full``    — raw leaf values, chunked; needs no base (first publish,
                  shape mismatch, and non-finite-delta fallback).
  * ``delta``   — bitwise XOR against the receiver's base version.  XOR
                  of the raw bit patterns is EXACT for every dtype, and
                  an unchanged leaf XORs to all-zero so its chunks are
                  simply not sent (empty-delta sparsity).
  * ``delta-q`` — int8-quantized arithmetic delta with a per-chunk scale
                  (``scale = max|delta| / 127``); lossy within the
                  declared per-chunk tolerance ``scale``, with the exact
                  ``xor`` rule for integer, bool and bf16 (``uint16``
                  bits) leaves and a ``full`` fallback for non-finite
                  deltas.

The decoder owns torn-stream recovery (DESIGN.md §Torn-stream recovery):
a stream missing chunks at its end, interrupted by a new begin, or built
on a base version the receiver does not hold is DISCARDED whole — the
receiver keeps serving the last complete version; no partially-applied
tree is ever observable.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from queue import Queue
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.obs import trace


# ---- stream framing (DESIGN.md §Chunk framing) ------------------------------


@dataclass(frozen=True)
class StreamBegin:
    """Opens one version's publication stream (DESIGN.md §Chunk framing).
    ``base_version`` is the version the deltas were computed against
    (None for a base-free ``full`` stream); ``n_chunks`` is the exact
    number of ``WeightChunk`` messages that follow, which is what lets
    the decoder detect a torn stream at ``StreamEnd``."""
    version: int
    base_version: Optional[int]
    encoding: str                      # "full" | "delta" | "delta-q"
    n_chunks: int


@dataclass(frozen=True)
class WeightChunk:
    """One contiguous span of one flattened leaf (DESIGN.md §Chunk
    framing): ``path`` is the leaf's state-dict name, ``offset`` /
    ``size`` address elements of the raveled leaf, ``kind`` selects the
    application rule (``full`` = raw values, ``xor`` = bitwise delta on
    the leaf's unsigned view, ``q8`` = int8 payload dequantized with
    ``scale`` and added to the base).  ``last_of_leaf`` marks the final
    chunk emitted for this leaf so receivers can hand the completed leaf
    off (e.g. to a device transfer) before the stream ends."""
    version: int
    path: str
    seq: int
    offset: int
    size: int
    shape: Tuple[int, ...]
    dtype: str
    kind: str                          # "full" | "xor" | "q8"
    payload: np.ndarray
    scale: float = 0.0
    last_of_leaf: bool = False


@dataclass(frozen=True)
class StreamEnd:
    """Closes a stream; carries ``n_chunks`` redundantly so a receiver
    that missed the begin can still account the loss."""
    version: int
    n_chunks: int


class WeightStream:
    """One publication's ordered message list: ``StreamBegin``, the
    ``WeightChunk``s, ``StreamEnd`` (DESIGN.md §Chunk framing).
    Iterable; transports send each message as-is."""

    def __init__(self, messages: List):
        assert messages and isinstance(messages[0], StreamBegin)
        assert isinstance(messages[-1], StreamEnd)
        self.messages = messages

    @property
    def version(self) -> int:
        return self.messages[0].version

    @property
    def n_chunks(self) -> int:
        return self.messages[0].n_chunks

    def __iter__(self) -> Iterator:
        return iter(self.messages)

    def __len__(self) -> int:
        return len(self.messages)

    def nbytes(self) -> int:
        """Payload bytes on the wire (chunk payloads only)."""
        return sum(m.payload.nbytes for m in self.messages if isinstance(m, WeightChunk))

    def tolerance(self) -> float:
        """Largest declared per-chunk quantization tolerance (0.0 for
        exact streams): decoded leaves differ from the published ones by
        at most this much elementwise."""
        return max((m.scale for m in self.messages
                    if isinstance(m, WeightChunk) and m.kind == "q8"), default=0.0)


# ---- state dict <-> flat path helpers ---------------------------------------

def tree_items(tree: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """``[(name, leaf), ...]`` of an ordered state dict, in its order —
    the key scheme of the chunk framing and of ``checkpoint/io.py``."""
    return list(tree.items())


def tree_rebuild(template: Dict[str, Any], leaves_by_path: Dict[str, Any]) -> Dict[str, Any]:
    """A dict with ``template``'s names in its order, each leaf taken
    from ``leaves_by_path`` when present and from the template
    otherwise."""
    return {name: leaves_by_path.get(name, leaf) for name, leaf in template.items()}


# ---- the host form of a state dict --------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view: a CPU tensor's ``.numpy()`` shares its
    memory, and the trainer updates its tensors in place)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:          # numpy has no bf16: keep its bits
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def host_weights(weights) -> Dict[str, np.ndarray]:
    """Device -> host copy of a state dict (or an ``LM``'s) as numpy,
    name by name: the form the streaming codecs and a cross-process
    transport take.  bf16 is kept as its raw ``uint16`` bits, never
    widened, so that a delta of it is the exact ``xor`` rule (as the
    reference's opaque bf16 dtype is) and ``device_leaf`` gives back
    the same bits."""
    if isinstance(weights, torch.nn.Module):
        weights = weights.state_dict()
    return {name: _host(t) for name, t in weights.items()}


def device_leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host leaf of ``host_weights`` as a tensor of ``like``'s dtype on
    ``like``'s device: bf16 rebuilt from its ``uint16`` bits."""
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).to(
            like.device).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device=like.device, dtype=like.dtype)


def _uint_view(a: np.ndarray) -> np.ndarray:
    """Reinterpret any fixed-width leaf as its same-width unsigned
    integer view — the domain where XOR deltas are exact."""
    return a.view(np.dtype(f"uint{a.dtype.itemsize * 8}"))


ENCODINGS = ("full", "delta", "delta-q")


def _leaf_chunks(path: str, new: np.ndarray, base: Optional[np.ndarray], encoding: str,
                 version: int, chunk_elems: int) -> List[WeightChunk]:
    """Chunk one leaf under one encoding (DESIGN.md §Chunk framing).
    Falls back to ``full`` chunks when there is no usable base (first
    publish, shape/dtype mismatch) or when quantization cannot represent
    the delta (non-finite values); integer/bool leaves (bf16 among them,
    as its ``uint16`` bits) use the exact ``xor`` rule under ``delta-q``
    too."""
    flat_new = np.ascontiguousarray(new).reshape(-1)
    usable_base = base is not None and base.shape == new.shape and base.dtype == new.dtype
    kind = "full"
    if encoding != "full" and usable_base:
        kind = "xor" if encoding == "delta" or new.dtype.kind not in "fc" else "q8"
    chunks: List[WeightChunk] = []
    n = flat_new.size
    meta = dict(version=version, path=path, seq=0, shape=tuple(new.shape), dtype=str(new.dtype))
    if kind == "xor":
        bits = _uint_view(flat_new) ^ _uint_view(np.ascontiguousarray(base).reshape(-1))
        if not bits.any():
            return []                  # unchanged leaf: nothing on the wire
        for off in range(0, n, chunk_elems):
            part = bits[off:off + chunk_elems]
            if not part.any():
                continue               # empty-delta sparsity, per chunk
            chunks.append(WeightChunk(offset=off, size=part.size, kind="xor",
                                      payload=part.copy(), **meta))
    elif kind == "q8":
        flat_base = np.ascontiguousarray(base).reshape(-1)
        delta = flat_new.astype(np.float64) - flat_base.astype(np.float64)
        if not np.isfinite(delta).all():
            kind = "full"              # quantization cannot represent it
        elif not delta.any():
            return []
        else:
            for off in range(0, n, chunk_elems):
                part = delta[off:off + chunk_elems]
                peak = float(np.max(np.abs(part)))
                if peak == 0.0:
                    continue
                scale = peak / 127.0
                q = np.clip(np.round(part / scale), -127, 127).astype(np.int8)
                chunks.append(WeightChunk(offset=off, size=part.size, kind="q8", payload=q,
                                          scale=scale, **meta))
    if kind == "full":
        for off in range(0, n, chunk_elems):
            part = flat_new[off:off + chunk_elems]
            chunks.append(WeightChunk(offset=off, size=part.size, kind="full",
                                      payload=part.copy(), **meta))
    if chunks:
        chunks[-1] = dataclasses.replace(chunks[-1], last_of_leaf=True)
    return chunks


def encode_stream(params: Dict[str, np.ndarray], *, version: int,
                  base: Optional[Dict[str, np.ndarray]] = None,
                  base_version: Optional[int] = None, encoding: str = "delta",
                  chunk_elems: int = 65536) -> WeightStream:
    """Frame one publication as a ``WeightStream`` (DESIGN.md §Chunk
    framing).  ``params``/``base`` are HOST trees (numpy leaves — see
    ``host_weights``); ``base`` is the previously
    published version the receiver is known to hold, or None for a
    base-free full stream.  Leaves are chunked at ``chunk_elems``
    elements; under ``delta``/``delta-q`` unchanged chunks are simply
    not emitted.  The result decodes bit-exactly for ``full`` and
    ``delta``, and within ``WeightStream.tolerance()`` for
    ``delta-q``."""
    assert encoding in ENCODINGS, encoding
    if base is None:
        base_version = None
        encoding = "full"
    base_by_path = {} if base is None else {p: np.asarray(a) for p, a in tree_items(base)}
    chunks: List[WeightChunk] = []
    for path, leaf in tree_items(params):
        chunks.extend(_leaf_chunks(path, np.asarray(leaf), base_by_path.get(path), encoding,
                                   version, chunk_elems))
    chunks = [dataclasses.replace(c, seq=i) for i, c in enumerate(chunks)]
    begin = StreamBegin(version=version, base_version=base_version, encoding=encoding,
                        n_chunks=len(chunks))
    return WeightStream([begin, *chunks, StreamEnd(version=version, n_chunks=len(chunks))])


class StreamDecoder:
    """Receiver-side stream assembler (DESIGN.md §Torn-stream recovery).

    Holds the last COMPLETE version ``(self.version, self.params)`` (a
    host tree) and stages an in-flight stream off to the side;
    ``feed(msg)`` returns ``(version, params)`` exactly when a
    ``StreamEnd`` completes a stream, None otherwise.  The fence
    invariant: ``self.params`` never changes mid-stream, so a receiver
    that dies — or a stream that arrives torn — leaves the last complete
    version intact:

      * a new ``StreamBegin`` while a stream is open discards the open
        stream (``torn``);
      * a ``StreamEnd`` whose chunk count does not match discards the
        stream (``torn``);
      * a delta stream whose ``base_version`` is not the version we hold
        is unusable: it is ignored whole and ``need_full`` is set so the
        caller can request a full retransmit (``base_mismatches``);
      * chunks/ends with no matching open stream are counted as
        ``orphans`` and ignored (e.g. a receiver that joined
        mid-broadcast).

    ``on_leaf(path, array)`` fires as each leaf's last chunk applies —
    the hook the engine uses to move a finished leaf to the device while
    it decodes under the previous version (DESIGN.md §Version fence).
    ``params=None`` decodes base-free full streams into a fresh dict."""

    def __init__(self, params: Optional[Dict[str, np.ndarray]] = None,
                 version: Optional[int] = None, *,
                 on_leaf: Optional[Callable[[str, np.ndarray], None]] = None):
        self.params = params
        self.version = version
        self.on_leaf = on_leaf
        self.torn = 0
        self.completed = 0
        self.orphans = 0
        self.base_mismatches = 0
        self.chunks_received = 0
        self.need_full = False
        self._cur: Optional[Dict[str, Any]] = None

    @property
    def mid_stream(self) -> bool:
        return self._cur is not None

    def _discard(self) -> None:
        if self._cur is not None:
            self.torn += 1
            self._cur = None

    def _base_leaves(self) -> Dict[str, np.ndarray]:
        if self.params is None:
            return {}
        return {p: np.asarray(leaf) for p, leaf in tree_items(self.params)}

    def feed(self, msg):
        """Feed one stream message; returns ``(version, params)`` when a
        stream completes, else None (see class docstring for the
        discard rules — DESIGN.md §Torn-stream recovery)."""
        if isinstance(msg, StreamBegin):
            self._discard()
            if msg.encoding != "full" and msg.base_version != self.version:
                # deltas against a version we don't hold: unusable whole
                self.base_mismatches += 1
                self.need_full = True
                trace.instant("stream.base_mismatch", version=msg.version,
                              base=msg.base_version)
                return None
            trace.instant("stream.begin", version=msg.version, encoding=msg.encoding,
                          n_chunks=msg.n_chunks)
            self._cur = {"begin": msg, "seen": 0, "bad": False, "leaves": {},
                         "base": self._base_leaves()}
            return None
        if isinstance(msg, WeightChunk):
            self.chunks_received += 1
            cur = self._cur
            if cur is None or msg.version != cur["begin"].version:
                self.orphans += 1
                return None
            cur["seen"] += 1
            self._apply_chunk(cur, msg)
            return None
        if isinstance(msg, StreamEnd):
            cur = self._cur
            if cur is None or msg.version != cur["begin"].version:
                self.orphans += 1
                return None
            if cur["seen"] != cur["begin"].n_chunks or cur["bad"]:
                self._discard()        # torn: keep the last complete version
                trace.instant("stream.torn", version=msg.version)
                return None
            self._cur = None
            self.completed += 1
            self.version = msg.version
            trace.instant("stream.complete", version=msg.version)
            leaves = cur["leaves"]
            self.params = dict(leaves) if self.params is None else \
                tree_rebuild(self.params, leaves)
            return msg.version, self.params
        raise TypeError(f"not a stream message: {type(msg).__name__}")

    def _apply_chunk(self, cur: Dict, msg: WeightChunk) -> None:
        buf = cur["leaves"].get(msg.path)
        if buf is None:
            base = cur["base"].get(msg.path)
            if base is not None and tuple(base.shape) == msg.shape and str(base.dtype) == msg.dtype:
                buf = base.copy()
            elif msg.kind == "full":
                buf = np.zeros(msg.shape, np.dtype(msg.dtype))
            else:                      # delta against a leaf we don't hold
                cur["bad"] = True
                return
            cur["leaves"][msg.path] = buf
        flat = buf.reshape(-1)
        sl = slice(msg.offset, msg.offset + msg.size)
        if msg.kind == "full":
            flat[sl] = msg.payload
        elif msg.kind == "xor":
            v = _uint_view(flat)
            v[sl] = v[sl] ^ msg.payload
        elif msg.kind == "q8":
            base_flat = cur["base"][msg.path].reshape(-1)
            flat[sl] = (base_flat[sl].astype(np.float64)
                        + msg.payload.astype(np.float64) * msg.scale).astype(buf.dtype)
        else:
            cur["bad"] = True
            return
        if msg.last_of_leaf and self.on_leaf is not None:
            self.on_leaf(msg.path, buf)

    def stats(self) -> Dict[str, int]:
        return {"streams_completed": self.completed,
                "streams_torn": self.torn,
                "stream_chunks_received": self.chunks_received,
                "stream_orphans": self.orphans,
                "stream_base_mismatches": self.base_mismatches,
                "stream_active": int(self.mid_stream)}


# ---- the parameter store ------------------------------------------------------

class VersionEvicted(KeyError):
    """``ParameterStore.get`` of a version that WAS published but has
    been evicted from the history window — distinct from a version that
    was never published (which returns None).  Raised loudly so a
    proximal-recompute path that lost the race between ``latest()`` and
    ``get()`` fails instead of silently training on None."""


class Published(dict):
    """One published version's weights by state-dict name.  ``ready`` is
    the CUDA event recorded on the publishing thread's stream once the
    tensors are written, or None where no device work is pending."""
    ready: Optional[torch.cuda.Event] = None


def _cuda_tensors(weights) -> List[torch.Tensor]:
    if not isinstance(weights, dict):
        return []
    return [t for t in weights.values() if isinstance(t, torch.Tensor) and t.is_cuda]


def _snapshot(weights):
    """What ``publish`` stores: a ``Published`` copy of a model's state
    dict, a ``Published`` view of a dict the caller handed over, or
    anything else as it is (the simulator's trainer publishes None)."""
    if isinstance(weights, torch.nn.Module):
        with torch.no_grad():
            snap = Published((n, t.detach().clone()) for n, t in weights.state_dict().items())
    elif isinstance(weights, dict):
        snap = Published(weights)
    else:
        return weights
    cuda = _cuda_tensors(snap)
    if cuda:
        snap.ready = torch.cuda.Event()
        snap.ready.record(torch.cuda.current_stream(cuda[0].device))
    return snap


def acquire(weights):
    """Order the calling thread's current CUDA stream after the
    publication of ``weights`` (a ``Published``), and mark its tensors
    as used by that stream, so that their memory outlives the work this
    stream queues on them.  Returns ``weights``; a no-op on the CPU."""
    ready = getattr(weights, "ready", None)
    if ready is None:
        return weights
    cuda = _cuda_tensors(weights)
    stream = torch.cuda.current_stream(cuda[0].device)
    stream.wait_event(ready)
    for t in cuda:
        t.record_stream(stream)
    return weights


@dataclass
class _Spill:
    path: str
    host: Dict[str, np.ndarray]
    meta: Dict


class ParameterStore:
    """Versioned trainer→rollout publication (DESIGN.md
    §Weight-publication path).  Checkpoint spills run on a background
    writer thread so publish-to-subscriber latency is independent of
    checkpoint size (DESIGN.md §Streaming weight publication); call
    ``close()`` to drain pending spills."""

    def __init__(self, keep: int = 2, ckpt_dir: Optional[str] = None, ckpt_every: int = 0):
        self._lock = threading.Lock()
        self._latest: Optional[Tuple[int, Any]] = None
        self._history: Dict[int, Any] = {}
        self._published: set = set()       # every version ever published
        self._subscribers: List[Callable[[int, Any], None]] = []
        self.keep = keep
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.publishes = 0
        self.spills = 0                    # checkpoints actually written
        self._spill_q: Optional[Queue] = None
        self._spill_thread: Optional[threading.Thread] = None
        self.spill_errors: List[BaseException] = []

    def subscribe(self, fn: Callable[[int, Any], None]) -> None:
        """Register a publication callback.  Safe to call while
        publishing."""
        with self._lock:
            self._subscribers.append(fn)

    # ---- background checkpoint writer ----------------------------------
    def _spill_loop(self) -> None:
        q = self._spill_q
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                try:
                    checkpoint.save(item.path, item.host, meta=item.meta)
                    self.spills += 1
                except BaseException as e:  # noqa: BLE001 — surfaced on close
                    self.spill_errors.append(e)
            finally:
                q.task_done()

    def _enqueue_spill(self, version: int, weights, meta: Optional[Dict]) -> None:
        # the host copy is taken here, on the publishing thread (its stream
        # orders it after the snapshot); the writer thread only writes it
        host = checkpoint.to_host(weights)
        with self._lock:
            if self._spill_q is None:
                self._spill_q = Queue()
                self._spill_thread = threading.Thread(
                    target=self._spill_loop, name="areal-ckpt-writer", daemon=True)
                self._spill_thread.start()
        self._spill_q.put(_Spill(path=f"{self.ckpt_dir}/v{version:06d}.npz", host=host,
                                 meta={"version": version, **(meta or {})}))

    def flush(self) -> None:
        """Block until every enqueued checkpoint spill has been written
        (drain-on-close half of the background writer)."""
        if self._spill_q is not None:
            self._spill_q.join()

    def close(self) -> None:
        """Drain pending spills and stop the writer thread.  Re-raises
        the first spill error, so a failed checkpoint write is never
        silently lost."""
        if self._spill_q is not None:
            self._spill_q.join()
            self._spill_q.put(None)
            self._spill_thread.join(10.0)
            self._spill_q = None
            self._spill_thread = None
        if self.spill_errors:
            raise self.spill_errors[0]

    # ---- publication ----------------------------------------------------
    def publish(self, version: int, model, meta: Optional[Dict] = None) -> None:
        """Make ``(version, weights of model)`` the latest publication and
        notify subscribers.  ``model`` is an ``LM`` (its weights are
        copied), or a dict of weights the caller will not change.  The
        versions that fall out of the window go before the copy is made,
        so the store never holds more than ``keep`` copies.  The
        checkpoint spill (when due) is ENQUEUED to the background writer,
        not written here."""
        with self._lock:
            # the reference's eviction order: oldest first, never `version`
            others = sorted(v for v in self._history if v != version)
            for v in others[:max(0, len(others) - (self.keep - 1))]:
                del self._history[v]
        snap = _snapshot(model)
        with self._lock:
            self._latest = (version, snap)
            self._history[version] = snap
            self._published.add(version)
            self.publishes += 1
            subscribers = list(self._subscribers)
        if self.ckpt_dir and self.ckpt_every and version % self.ckpt_every == 0:
            self._enqueue_spill(version, snap, meta)
        for fn in subscribers:             # outside the lock: callbacks
            fn(version, snap)              # may do slow transport sends

    def latest(self) -> Optional[Tuple[int, Any]]:
        with self._lock:
            return self._latest

    def get(self, version: int):
        """Weights of ``version`` from the history window.  A version that
        was published but already evicted raises ``VersionEvicted`` (the
        latest()/get() race must fail loudly); a version that was never
        published returns None."""
        with self._lock:
            weights = self._history.get(version)
            if weights is not None:
                return weights
            if version in self._published:
                raise VersionEvicted(
                    f"version {version} was published but evicted from the "
                    f"history window (keep={self.keep}); retained: "
                    f"{sorted(self._history)}")
            return None

"""Per-step FLOPs, bytes and peak live memory of an eager step, counted
from the aten ops it dispatches: the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference counts its figures from the HLO text of the compiled
per-device program.  Eager PyTorch has no such program: a step is the
sequence of aten ops it dispatches, each its own kernel on the card.
``OpAnalysis`` is a ``TorchDispatchMode`` that sees every one of them,
forward and backward, and is meant to run over tensors on the ``meta``
device (shapes and dtypes, no memory and no arithmetic):

  * FLOPs: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and ``convolution``
    (and its backward), by the formulas of ``torch.utils.flop_counter``,
    plus what each hand-written kernel's meta route records through
    ``kernels/meta.py::record_kernel`` (each visible (query, key) pair's
    flops once, with every key of the cache or pool counted as visible,
    since meta tensors hold no positions), which ``OpAnalysis`` receives
    while it is active;
  * bytes: the input and output bytes of every op that is not a view, and
    the kernels' records.  In eager every op is its own kernel, so this is
    the counterpart of the reference's traffic across fusion boundaries.
    An op that writes rows into a tensor in place (``index_put_``,
    ``copy_`` into a slice) counts the rows it writes, not the tensor it
    writes into, and a gather counts the rows it reads; an allocation
    (``empty``) moves nothing;
  * rematerialisation needs no rule of its own: a checkpointed region's
    recompute is dispatched in the backward and counted as it runs, and
    the finalizers follow what checkpoint frees and refills (held against
    the reference's compiled remat step by ``tests/test_torch_remat.py``
    and against the card's peak by ``chip_smoke.py``'s ``steps``);
  * peak live bytes: every storage an op allocates is followed until it is
    freed (a finalizer on the storage), each rounded up to the CUDA
    caching allocator's 512-byte block; the storages that exist when the
    analysis starts (the step's arguments) are not counted, so the peak
    is the counterpart of the reference's ``temp_bytes`` plus its outputs.
    An op whose CUDA implementation holds a temporary of its own adds it
    to the peak while it runs: ``logsumexp`` computes exp(x - max) into a
    buffer the size of x (``_TRANSIENT``);
  * trip counts: XLA counts a ``while`` body once, so the reference
    multiplies by the loop's trip count.  Eager dispatch sees every layer
    and every micro-step of ``accum_steps`` as it runs, so those need no
    correction.  The one loop it does not dispatch whole is the sLSTM's
    over time (``models/xlstm.py::slstm_forward``): on meta, under an
    analysis with ``scale_loops``, it runs its first three steps (the
    first, a middle one and the last, whose backward ops differ) and
    asks the analysis to count the middle step S - 3 more times, with
    ``mark`` / ``add_scaled``: its forward ops and collectives, the
    backward ops autograd runs for it (between two marks the loop places
    in the backward), and the bytes its autograd graph holds until the
    backward (``born_alive``, held with ``hold`` / ``resize``, released
    when the loop's backward ends).  ``scale_loops=False`` dispatches
    every step, the slow count the scaled one is checked against;
  * collectives: the c10d functional collectives the step dispatches
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_reduce``, ``all_to_all_single``), by the reference's kinds
    ("all-gather", ...) with their result-shape bytes and a ``_count``
    key each, as ``hlo_analysis.py`` counts them, in all and by the
    process group (a mesh dim's) each ran over; they are not in
    ``bytes``.  A one-card step has none.

A sharded step (DTensors under a ``fake`` process group, the dry run's
production meshes) is analysed as rank 0's program: the analysis steps
aside for each DTensor op (``NotImplemented``) and counts the local ops
and collectives DTensor dispatches for it, at this rank's shapes; the
ops DTensor runs on fake tensors of the global shapes to propagate
shardings, allocations included, are not counted.

A data-dependent selection cannot run on meta (the size of its output
depends on the values); the model takes a static upper bound there
(every row, ``models/attention.py``), so its scatters' bytes are an
upper bound.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import meta

aten = torch.ops.aten
ALLOC_BLOCK = 512           # bytes: the CUDA caching allocator's rounding
_FLOP_OPS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
             aten.convolution_backward)
# ops that move nothing
_FREE_OPS = (aten.empty, aten.empty_like, aten.empty_strided, aten.detach, aten.alias,
             aten.lift_fresh)
# in-place row writes: the values they write, not the tensor they write into
_ROW_WRITES = (aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.index_add_,
               aten.scatter_, aten.scatter_add_, aten.masked_scatter_)
# gathers: the rows they read
_GATHERS = (aten.index, aten.gather, aten.index_select, aten.embedding)
# ops whose CUDA implementation allocates a temporary the size of its input
_TRANSIENT = (aten.logsumexp,)
_c10d = torch.ops._c10d_functional
COLLECTIVES = {_c10d.all_gather_into_tensor: "all-gather",
               _c10d.reduce_scatter_tensor: "reduce-scatter",
               _c10d.all_reduce: "all-reduce", _c10d.all_to_all_single: "all-to-all"}
# DTensor's wrappers around a collective's result: they move nothing
_FREE_OPS += (_c10d.wait_tensor, _c10d._wrap_tensor_autograd)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


@dataclass(frozen=True)
class Mark:
    """The tally's running counts at one point of the run, and the serial
    number the next storage allocated takes."""
    flops: float
    bytes: float
    n_ops: int
    collectives: Dict[str, float]
    collectives_by_group: Dict[str, Dict[str, float]]
    serial: int


@dataclass
class Tally:
    flops: float = 0.0
    bytes: float = 0.0
    peak_bytes: int = 0             # most bytes allocated during the run at once
    end_bytes: int = 0              # still allocated when the run ended
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    collectives: Dict[str, float] = field(default_factory=dict)
    # the same, by the process group each ran over (its name)
    collectives_by_group: Dict[str, Dict[str, float]] = field(default_factory=dict)
    n_ops: int = 0


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis() as a: step(...)``, then ``a.tally``."""

    def __init__(self, scale_loops: bool = True):
        super().__init__()
        self.tally = Tally()
        self.scale_loops = scale_loops
        self._live: Dict[int, int] = {}        # id(storage) -> rounded bytes
        self._born: Dict[int, int] = {}        # id(storage) -> allocation serial
        self._serial = 0
        self._live_bytes = 0

    def __enter__(self):
        meta.push_analysis(self)
        return super().__enter__()

    def __exit__(self, *exc):
        meta.pop_analysis(self)
        self.tally.end_bytes = self._live_bytes
        return super().__exit__(*exc)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.tally.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.tally.flops += flops
        self.tally.bytes += nbytes

    # ---- a loop traced in part (see the module's docstring) ----------------
    def mark(self) -> Mark:
        t = self.tally
        return Mark(t.flops, t.bytes, t.n_ops, dict(t.collectives),
                    {g: dict(c) for g, c in t.collectives_by_group.items()}, self._serial)

    def add_scaled(self, since: Mark, until: Mark, times: int) -> None:
        """Count ``times`` more what the run counted between two marks:
        FLOPs, bytes, ops and collectives (the kernels' records aside)."""
        t = self.tally
        t.flops += times * (until.flops - since.flops)
        t.bytes += times * (until.bytes - since.bytes)
        t.n_ops += times * (until.n_ops - since.n_ops)
        for now, then, dst in ((until.collectives, since.collectives, t.collectives),
                               *((c, since.collectives_by_group.get(g, {}),
                                  t.collectives_by_group.setdefault(g, {}))
                                 for g, c in until.collectives_by_group.items())):
            for kind, v in now.items():
                dst[kind] = dst.get(kind, 0) + times * (v - then.get(kind, 0))

    def born_alive(self, since: Mark, until: Mark) -> int:
        """Bytes of the storages allocated between two marks that are
        still live."""
        return sum(n for key, n in self._live.items()
                   if since.serial <= self._born[key] < until.serial)

    def hold(self, nbytes: int) -> None:
        """Count ``nbytes`` live until ``hold(-nbytes)``."""
        self._live_bytes += nbytes
        self.tally.peak_bytes = max(self.tally.peak_bytes, self._live_bytes)

    def resize(self, t: torch.Tensor, nbytes: int) -> None:
        """Grow the tracked storage of ``t`` (a meta tensor) to ``nbytes``:
        it is counted at that size until it is freed."""
        st = t.untyped_storage()
        st.resize_(nbytes)
        key = id(st)
        n = _rounded(nbytes)
        self.hold(n - self._live.get(key, 0))
        self._live[key] = n

    # ---- memory ----------------------------------------------------------
    def _freed(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)
        self._born.pop(key, None)

    def _track(self, t: torch.Tensor, inputs) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live or key in inputs:
            return
        n = _rounded(st.nbytes())
        self._live[key] = n
        self._born[key] = self._serial
        self._serial += 1
        self._live_bytes += n
        self.tally.peak_bytes = max(self.tally.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._freed, key)

    # ---- bytes ---------------------------------------------------------------
    @staticmethod
    def _op_bytes(packet, ins, outs) -> int:
        if packet in _FREE_OPS:
            return 0
        if packet in _ROW_WRITES:
            # the indices and the values read, the values (the last input) written
            return sum(_nbytes(x) for x in ins[1:]) + _nbytes(ins[-1])
        if packet in _GATHERS:
            idx = [x for x in ins[1:] if not x.is_floating_point()]
            return 2 * sum(_nbytes(x) for x in outs) + sum(_nbytes(x) for x in idx)
        if packet is aten.copy_:
            return 2 * _nbytes(ins[1]) if len(ins) > 1 else 0
        return sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # counted as the local ops DTensor dispatches
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ins = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        if any(isinstance(x, FakeTensor) for x in ins + outs):
            return out                  # DTensor's sharding propagation, global shapes
        self.tally.n_ops += 1
        if packet in COLLECTIVES:
            kind, n = COLLECTIVES[packet], sum(_nbytes(x) for x in outs)
            group = kwargs.get("group_name", args[-1])
            for c in (self.tally.collectives,
                      self.tally.collectives_by_group.setdefault(group, {})):
                c[kind] = c.get(kind, 0) + n
                c[kind + "_count"] = c.get(kind + "_count", 0) + 1
            for t in outs:
                self._track(t, set())
            return out
        if packet in _FLOP_OPS:
            self.tally.flops += flop_counter.flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.tally.bytes += self._op_bytes(packet, ins, outs)
            in_storages = {id(x.untyped_storage()) for x in ins}
            for t in outs:
                self._track(t, in_storages)
            if packet in _TRANSIENT:
                self.tally.peak_bytes = max(self.tally.peak_bytes,
                                            self._live_bytes + _rounded(_nbytes(ins[0])))
        return out


def analyze(fn, *args, scale_loops: bool = True, **kwargs):
    """(fn's result, the ``Tally`` of the ops it dispatched); with
    ``scale_loops=False`` the sLSTM's loop dispatches every step."""
    with OpAnalysis(scale_loops) as a:
        out = fn(*args, **kwargs)
    return out, a.tally

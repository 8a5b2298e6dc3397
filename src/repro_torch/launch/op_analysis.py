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
  * peak live bytes: every storage an op allocates is followed until it is
    freed (a finalizer on the storage), each rounded up to the CUDA
    caching allocator's 512-byte block; the storages that exist when the
    analysis starts (the step's arguments) are not counted, so the peak
    is the counterpart of the reference's ``temp_bytes`` plus its outputs.
    An op whose CUDA implementation holds a temporary of its own adds it
    to the peak while it runs: ``logsumexp`` computes exp(x - max) into a
    buffer the size of x (``_TRANSIENT``);
  * trip counts: none to correct.  XLA counts a ``while`` body once, so
    the reference multiplies by the loop's trip count; eager dispatch
    sees every layer and every micro-step of ``accum_steps`` as it runs;
  * collectives: none.  The port builds only the one-card program, so the
    tally has no collective bytes.

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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


@dataclass
class Tally:
    flops: float = 0.0
    bytes: float = 0.0
    peak_bytes: int = 0             # most bytes allocated during the run at once
    end_bytes: int = 0              # still allocated when the run ended
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    n_ops: int = 0


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis() as a: step(...)``, then ``a.tally``."""

    def __init__(self):
        super().__init__()
        self.tally = Tally()
        self._live: Dict[int, int] = {}        # id(storage) -> rounded bytes
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

    # ---- memory ----------------------------------------------------------
    def _freed(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor, inputs) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live or key in inputs:
            return
        n = _rounded(st.nbytes())
        self._live[key] = n
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
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ins = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        self.tally.n_ops += 1
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


def analyze(fn, *args, **kwargs):
    """(fn's result, the ``Tally`` of the ops it dispatched)."""
    with OpAnalysis() as a:
        out = fn(*args, **kwargs)
    return out, a.tally

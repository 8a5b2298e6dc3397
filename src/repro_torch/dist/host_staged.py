"""Collectives staged through host memory, for worlds whose ranks share
one card.

NCCL refuses two ranks on one device, so such a world runs on gloo.  On
the H100 machine's PyTorch, gloo's functional collectives on CUDA tensors
(what DTensor issues: ``torch.ops._c10d_functional``) crash in their
wait for the all-gather, the reduce-scatter and the all-to-all (the
process dies on a segfault), while gloo's all-reduce and every
``torch.distributed`` call on CPU tensors work.  ``install(key)``
replaces those three functional ops' kernels for dispatch key ``key``
("CUDA" on the card) by ones that copy the input to the host, run the
``torch.distributed`` collective there on gloo, and copy the result back
to the input's device.  Each call waits for its collective, so the
functional op's later ``wait_tensor`` finds nothing to wait for.

It is installed only by ``launch/sharded.py``'s world programs (the
ranks sharing one card of ``chip_smoke.py``'s ``sharded`` phase, and
the CPU tests, which install it for "CPU" to hold the staged path
against the plain one): a world of one rank a card runs NCCL and needs
none of it.  The staging costs two copies over PCIe a collective; times
taken with it say nothing of a run over NVLink.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

_LIBS: Dict[str, torch.library.Library] = {}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu").contiguous()


def _reduce_op(name: str):
    """The ``dist.ReduceOp`` of a functional op's name, and whether the
    result is then divided by the group's size ("avg": gloo has no
    ReduceOp.AVG)."""
    name = name.lower()
    return (dist.ReduceOp.SUM, True) if name == "avg" else (_OPS[name], False)


def all_gather_into_tensor(input, group_size: int, group_name: str):
    x = _host(input)
    out = torch.empty((x.shape[0] * group_size,) + tuple(x.shape[1:]), dtype=x.dtype)
    dist.all_gather_into_tensor(out, x, group=_group(group_name))
    return out.to(input.device)


def reduce_scatter_tensor(input, reduce_op: str, group_size: int, group_name: str):
    x = _host(input)
    out = torch.empty((x.shape[0] // group_size,) + tuple(x.shape[1:]), dtype=x.dtype)
    op, mean = _reduce_op(reduce_op)
    dist.reduce_scatter_tensor(out, x, op=op, group=_group(group_name))
    if mean:
        out /= group_size
    return out.to(input.device)


def all_to_all_single(input, output_split_sizes: List[int], input_split_sizes: List[int],
                      group_name: str):
    x = _host(input)
    rows = sum(output_split_sizes) if output_split_sizes else x.shape[0]
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype)
    dist.all_to_all_single(out, x, output_split_sizes or None, input_split_sizes or None,
                           group=_group(group_name))
    return out.to(input.device)


def install(key: str = "CUDA") -> None:
    """Route the three functional collectives of dispatch key ``key``
    through host memory, once a process."""
    if key in _LIBS:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in (all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single):
        lib.impl(fn.__name__, fn, key)
    _LIBS[key] = lib

"""Mesh axis arithmetic, mirroring ``repro/dist/constraints.py``.

A spec is a tuple of entries, one per dimension: a mesh axis name, a
tuple of names (the dimension split over all of them), or None
(replicated).  The alias ``"dp"`` expands to every data-parallel axis the
mesh has (``("pod", "data")`` on the multi-pod mesh, ``("data",)`` on a
single pod).  Entries that name axes absent from the mesh, or whose
axis-size product does not divide the dimension, degrade to replication
instead of failing.  The meshes are ``launch/mesh.py``'s: only their
axis names and sizes are read.

``constrain(x, *axes)`` and ``constrain_qkv`` tag activations with the
mesh axes they should live on, as the reference's
(``repro/dist/constraints.py``).  Inside ``launch.mesh.use_mesh`` each
``redistribute``s a DTensor to ``placements(resolve_spec(...))``; without
an active mesh, or on a plain tensor, each returns its input object
itself (an exact no-op).  A spec that resolves to no axis at all is, as
the reference's, no constraint: the tensor keeps its placements, save
that a pending reduction (``Partial``) is carried out.  As JAX's
``with_sharding_constraint``, a constraint also holds the gradient that
flows back through it to the same placements (``_Constrain``), so that
DTensor's propagation meets the layouts the constraints name in the
backward pass too (a row-parallel output's gradient arrives replicated,
a column-parallel input's gradient is all-reduced where it is tagged).
"""
from __future__ import annotations

from contextvars import ContextVar
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

DATA_AXES = ("pod", "data")     # data-parallel axes, outermost first
# (Mesh, DeviceMesh) of the innermost ``launch.mesh.use_mesh`` scope
_ACTIVE: ContextVar = ContextVar("repro_torch_active_mesh", default=None)


def axis_sizes(mesh) -> dict:
    """Mesh axis-name -> size mapping."""
    return dict(mesh.shape)


def axes_size(mesh, axes) -> int:
    """Product of the named axes' sizes (single name or tuple)."""
    sizes = axis_sizes(mesh)
    names = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for name in names:
        n *= sizes[name]
    return n


def data_axes(mesh, *, pods: bool = True) -> Tuple[str, ...]:
    names = DATA_AXES if pods else ("data",)
    return tuple(a for a in mesh.axis_names if a in names)


def divisible_data_axes(mesh, dim: int, *, pods: bool = True) -> Tuple[str, ...]:
    """The data axes usable for ``dim``: outermost axes are dropped until
    their size product divides it (the one degradation policy of batch
    specs and FSDP)."""
    axes = data_axes(mesh, pods=pods)
    while axes and dim % axes_size(mesh, axes) != 0:
        axes = axes[1:]
    return axes


def _resolve_entry(mesh, dim: int, entry):
    """Resolve one spec entry against the mesh; None if it can't apply."""
    if entry is None:
        return None
    if entry == "dp":
        axes = divisible_data_axes(mesh, dim)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    names = entry if isinstance(entry, tuple) else (entry,)
    sizes = axis_sizes(mesh)
    if any(n not in sizes for n in names):
        return None
    if dim % axes_size(mesh, names) != 0:
        return None
    return entry


def resolve_spec(mesh, shape: Sequence[int], axes) -> Tuple:
    """A full-rank spec for ``shape`` from the axis tags."""
    return tuple(_resolve_entry(mesh, dim, axes[i] if i < len(axes) else None)
                 for i, dim in enumerate(shape))


def placements(spec, mesh):
    """One ``torch.distributed.tensor`` placement per mesh axis: Shard(d)
    where the axis splits dim d, else Replicate().  An entry naming several
    axes splits its dim over them outermost first, as DTensor orders the
    mesh's dims.  An axis of size 1 splits nothing: Replicate() (DTensor
    refuses to reshape a dim split over it)."""
    sizes = axis_sizes(mesh)
    out = []
    for axis in mesh.axis_names:
        dim = next((i for i, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)), None)
        out.append(Replicate() if dim is None or sizes[axis] == 1 else Shard(dim))
    return out


def reshard(x, dm, want):
    """``x.redistribute(dm, want)``, or ``x`` itself where it has those
    placements already: a redistribute to the same placements is not a
    no-op in the backward pass, where it brings the gradient to them (a
    ``Partial`` input gradient of each of q, k and v would be all-reduced
    on its own instead of once for their sum)."""
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(dm, want)


def on_mesh(x, dm):
    """``x`` as a DTensor on ``dm``: a plain tensor as replicated (as
    ``use_mesh`` treats one meeting a DTensor), a DTensor or None as it
    is."""
    if x is None or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)


def active_mesh():
    """(``launch.mesh.Mesh``, ``DeviceMesh``) of the innermost
    ``use_mesh`` scope, or None."""
    return _ACTIVE.get()


def constrain(x, *axes):
    """Tag ``x`` with mesh axes: a ``redistribute`` of a DTensor under an
    active mesh, else ``x`` itself."""
    active = _ACTIVE.get()
    if active is None or not isinstance(x, DTensor):
        return x
    mesh, dm = active
    spec = resolve_spec(mesh, x.shape, axes)
    if all(e is None for e in spec):
        want = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    else:
        want = placements(spec, mesh)
    if tuple(want) == tuple(x.placements):
        return x
    return _Constrain.apply(x, dm, tuple(want))


class _Constrain(torch.autograd.Function):
    """``redistribute`` to the constraint's placements, both ways."""

    @staticmethod
    def forward(ctx, x, dm, want):
        ctx.dm, ctx.want = dm, want
        return x.redistribute(dm, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.dm, ctx.want), None, None


def constrain_qkv(q, k, v, *, batch_axis: Optional[str] = "dp"):
    """One consistent tensor-parallel scheme across the q/k/v projections.

    q: (B, S, H, hd); k/v: (B, S, Hkv, hd).  Heads go on the "model" axis;
    with GQA the kv-head count may not divide it, and then k/v (and only
    they) keep whole heads on every model shard, which the flash wrapper
    (``kernels/ops.py``) narrows to each shard's own kv heads."""
    if _ACTIVE.get() is None:
        return q, k, v
    return tuple(constrain(x, batch_axis, None, "model", None) for x in (q, k, v))

"""Mesh axis arithmetic, mirroring ``repro/dist/constraints.py``.

A spec is a tuple of entries, one per dimension: a mesh axis name, a
tuple of names (the dimension split over all of them), or None
(replicated).  The alias ``"dp"`` expands to every data-parallel axis the
mesh has (``("pod", "data")`` on the multi-pod mesh, ``("data",)`` on a
single pod).  Entries that name axes absent from the mesh, or whose
axis-size product does not divide the dimension, degrade to replication
instead of failing.  The meshes are ``launch/mesh.py``'s: only their
axis names and sizes are read.
"""
from __future__ import annotations

from typing import Sequence, Tuple

DATA_AXES = ("pod", "data")     # data-parallel axes, outermost first


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

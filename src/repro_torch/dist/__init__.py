"""Distribution layer: the parameter partition rules, their axis
arithmetic and the activation constraints, mirroring ``repro/dist``.

``constraints`` holds the axis arithmetic (which data axes divide a
dimension; a spec entry that does not divide degrades to replication),
the DTensor ``placements`` of a spec and the reference's ``constrain`` /
``constrain_qkv`` activation tags, ``redistribute``s under an active
mesh (``launch.mesh.use_mesh``) and exact no-ops without one;
``sharding`` the path-based partition rules, the per-device shapes and
bytes they give, and the functions that put a model, a batch and a
decode cache on a ``DeviceMesh``; ``host_staged`` the collectives staged
through host memory for worlds whose ranks share one card.  The
reference's ``dist/compat.py`` backfills JAX's mesh API on old jaxlib
builds and has no counterpart.
"""
from repro_torch.dist import constraints, sharding

__all__ = ["constraints", "sharding"]

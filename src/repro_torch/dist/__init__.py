"""Distribution layer: the parameter partition rules and their axis
arithmetic, mirroring ``repro/dist``.

``constraints`` holds the axis arithmetic (which data axes divide a
dimension; a spec entry that does not divide degrades to replication);
``sharding`` the path-based partition rules and the per-device shapes and
DTensor placements they give.  The reference's ``dist/compat.py``
backfills JAX's mesh API on old jaxlib builds and has no counterpart;
its ``constrain`` / ``constrain_qkv`` activation tags are exact no-ops
without an active mesh, and the port activates none until it builds
sharded programs.
"""
from repro_torch.dist import constraints, sharding

__all__ = ["constraints", "sharding"]

"""Path-based parameter partition rules, mirroring ``repro/dist/sharding.py``.

The scheme (megatron-style tensor parallelism on "model", optional
ZeRO/FSDP on the data axes):

  embeddings       vocab-parallel: ``embed/table`` (V, d) -> ("model", fsdp)
                   and the untied ``head/w`` (d, V) -> (fsdp, "model").
  attention        column-parallel q/k/v (output/head dim on "model"),
                   row-parallel ``wo`` (input dim on "model"); a head count
                   that does not divide the model axis degrades that
                   projection to replication (GQA-safe).
  MLP / recurrent  column-parallel up/gate/in projections, row-parallel
                   down/out projections (dense MLPs, RG-LRU branches, the
                   xLSTM cell projections).
  MoE              expert-parallel: the leading expert dim of
                   ``w_up``/``w_gate``/``w_down`` on "model"; the router
                   replicated.
  norms / gains    replicated.

The rules key on the reference's path names (``embed/table``,
``units/<j>/attn/wq``, ``moe``, ``cell``, ...).  A parameter of the port
takes the path that ``models/convert.py::_jax_path`` gives it, the
mapping the weight converter loads the reference's trees by.  The
reference stacks the layers of a repeating unit (and the enc-dec
stacks) on a leading axis where the port keeps one tensor a layer, so the
rule is applied to the reference's stacked leaf shape and the port's spec
is that spec with the leading stacking entry dropped.  The port's weight
layout is the reference's (``wq`` is (d, q_dim)), so no rule is
transposed.

One difference follows from the stacking: a leaf that no rule names (the
conv kernels and gate projections of the RG-LRU and xLSTM blocks) takes
the catch-all rule, whose FSDP search starts at the reference's stacking
dim; where the data axes divide the unit count (the (2, 2) and (1, 1)
meshes; neither production mesh) it shards the stack across devices.  A
per-layer tensor cannot be split that way, so for such a leaf the port's
spec drops that entry and each device holds the leaf whole
(``stacked_fsdp``).

A spec is a tuple of entries (a mesh axis name, a tuple of names, or
None), one per dimension.  In place of the reference's ``named``:
``shard_shape`` gives a device's shape of a tensor and ``placements``
the DTensor placements on the mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.constraints import (axes_size, axis_sizes, data_axes,
                                          divisible_data_axes)
from repro_torch.models.convert import _jax_path

Spec = Tuple


def _model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def batch_spec(mesh, global_batch: int):
    """Spec *entry* for a batch dimension: as many data axes as divide
    ``global_batch`` (outermost dropped first), else None."""
    axes = divisible_data_axes(mesh, global_batch)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


# ---------------------------------------------------------------------------
# per-parameter rule
# ---------------------------------------------------------------------------

_COLUMN_PARALLEL = frozenset({"w_up", "w_gate", "w_x", "w_z", "w_rec"})
_ROW_PARALLEL = frozenset({"w_down", "w_out"})


def _base_rule(cfg: ModelConfig, mesh, names: Tuple[str, ...],
               shape: Sequence[int]) -> Tuple[Optional[str], ...]:
    """Canonical (unstacked) spec for the *trailing* dims of the leaf;
    the caller right-aligns it against the leaf's shape."""
    last = names[-1]
    msize = _model_size(mesh)

    if last in ("scale", "bias", "lam", "f_bias", "i_bias"):
        return (None,)

    if "embed" in names and last == "table":
        vocab_ok = shape[-2] % msize == 0 if len(shape) >= 2 else False
        return ("model" if vocab_ok else None, None)

    if "head" in names and last == "w":
        vocab_ok = shape[-1] % msize == 0
        return (None, "model" if vocab_ok else None)

    if "projector" in names and last == "w":
        return (None, None)

    if "moe" in names:
        if last == "router":
            return (None, None)              # top-k over E wants E unsharded
        if last in ("w_up", "w_gate", "w_down"):
            expert_ok = shape[-3] % msize == 0 if len(shape) >= 3 else False
            return ("model" if expert_ok else None, None, None)

    if last in ("wq", "wk", "wv"):
        # attention kv projections are GQA-safe; the xLSTM cell's q/k/v
        # all carry cfg.n_heads
        heads = cfg.n_kv_heads if (last in ("wk", "wv")
                                   and "cell" not in names) else cfg.n_heads
        head_ok = heads % msize == 0 and shape[-1] % msize == 0
        return (None, "model" if head_ok else None)

    if last == "wo":
        heads_ok = cfg.n_heads % msize == 0 and shape[-2] % msize == 0
        return ("model" if heads_ok else None, None)

    if last in _COLUMN_PARALLEL and len(shape) >= 2:
        return (None, "model" if shape[-1] % msize == 0 else None)

    if last in _ROW_PARALLEL and len(shape) >= 2:
        return ("model" if shape[-2] % msize == 0 else None, None)

    if len(shape) == 1:
        return (None,)

    # anything unmatched is replicated; FSDP may still shard one dim below
    return tuple(None for _ in shape)


def param_spec(cfg: ModelConfig, mesh, names: Tuple[str, ...], shape: Sequence[int], *,
               fsdp: bool = False, fsdp_pods: bool = False) -> Spec:
    """Full-rank spec of the reference's leaf at path ``names`` of
    ``shape`` (stacked dims included)."""
    shape = tuple(shape)
    rule = _base_rule(cfg, mesh, names, shape)
    rank = len(shape)
    crank = min(len(rule), rank)
    entries = [None] * (rank - crank) + list(rule[len(rule) - crank:])
    if fsdp and crank >= 2:
        axes = data_axes(mesh, pods=fsdp_pods)
        if axes:
            fsdp_size = axes_size(mesh, axes)
            entry = axes if len(axes) > 1 else axes[0]
            for i in range(rank - crank, rank):
                if entries[i] is None and shape[i] % fsdp_size == 0:
                    entries[i] = entry
                    break
    return tuple(entries)


# ---------------------------------------------------------------------------
# the port's parameters
# ---------------------------------------------------------------------------

def reference_leaf(model, name: str, shape: Sequence[int]):
    """(path names, leaf shape, stacking dims) of the reference's leaf
    holding the port's parameter ``name`` of ``shape``."""
    path, unit = _jax_path(model, name)
    names = tuple(path.split("/"))
    if unit is None:
        return names, tuple(shape), 0
    cfg = model.cfg
    stack = {"units": cfg.pattern_counts[0], "encoder": cfg.encoder_layers,
             "decoder": cfg.n_layers}[names[0]]
    return names, (stack,) + tuple(shape), 1


def make_param_specs(cfg: ModelConfig, mesh, model, *, fsdp: bool = True,
                     fsdp_pods: bool = False) -> Dict[str, Spec]:
    """Parameter name -> spec: the reference's spec of the parameter's
    leaf with its stacking entries dropped."""
    out = {}
    for name, p in model.named_parameters():
        names, shape, lead = reference_leaf(model, name, p.shape)
        out[name] = param_spec(cfg, mesh, names, shape, fsdp=fsdp, fsdp_pods=fsdp_pods)[lead:]
    return out


def stacked_fsdp(cfg: ModelConfig, mesh, model, *, fsdp: bool = True,
                 fsdp_pods: bool = False) -> Dict[str, Spec]:
    """The parameters whose reference leaf the catch-all rule shards along
    its stacking dim (name -> the reference's full spec): each device of
    the reference holds part of the stack, each of the port the whole
    layer."""
    out = {}
    for name, p in model.named_parameters():
        names, shape, lead = reference_leaf(model, name, p.shape)
        spec = param_spec(cfg, mesh, names, shape, fsdp=fsdp, fsdp_pods=fsdp_pods)
        if any(e is not None for e in spec[:lead]):
            out[name] = spec
    return out


def make_opt_specs(param_specs: Dict[str, Spec]):
    """AdamW state specs: m/v inherit the parameter specs (ZeRO-sharded
    moments when FSDP is on); the step is a host integer in the port."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def make_train_batch_specs(mesh, batch: Dict[str, torch.Tensor]) -> Dict[str, Spec]:
    """Batch-dim data parallelism for every tensor of a train/prefill batch."""
    return {k: (batch_spec(mesh, x.shape[0]),) + (None,) * (x.dim() - 1)
            for k, x in batch.items()}


def make_cache_specs(cfg: ModelConfig, mesh, cache) -> Dict:
    """Decode-cache specs (the cache's nesting): batch dim on the data
    axes, attention KV heads on "model" when the kv-head count divides it.

    The decoder-only LM's cache stacks every layer of a kind on a leading
    axis, as the reference stacks a unit's (``units`` leaves: batch axis
    1), so every leaf but ``t`` has its batch on axis 1.  The enc-dec
    cache (``self``, ``cross``) has the reference's own names and the
    reference's rule (batch axis 0 on its layer-stacked leaves, as the
    reference takes it).  Paged pools ``k_pool``/``v_pool`` (L, N, bs,
    Hkv, hd) have no batch dim: any slot may name any block, so the pool
    is replicated over the data axes with only the KV heads on "model"."""
    msize = _model_size(mesh)
    stacked = "self" not in cache

    def spec(names, x):
        shape = tuple(x.shape)
        rank = len(shape)
        entries = [None] * rank
        if names[-1] in ("k_pool", "v_pool"):
            if shape[-2] % msize == 0:
                entries[-2] = "model"
            return tuple(entries)
        bdim = 1 if stacked and names[-1] != "t" and rank >= 2 else 0
        entries[bdim] = batch_spec(mesh, shape[bdim])
        if (names[-1] in ("k", "v") and rank - bdim == 4
                and shape[-2] % msize == 0 and cfg.n_kv_heads % msize == 0):
            entries[-2] = "model"
        return tuple(entries)

    def walk(names, node):
        if isinstance(node, dict):
            return {k: walk(names + (k,), v) for k, v in node.items()}
        return spec(names, node)

    return walk((), cache)


# ---------------------------------------------------------------------------
# per-device shapes, bytes and DTensor placements
# ---------------------------------------------------------------------------

def shard_shape(spec: Spec, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """One device's shape of a tensor of ``shape`` under ``spec``."""
    return tuple(d // axes_size(mesh, e) if e is not None else d
                 for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def device_bytes(specs, tensors, mesh) -> int:
    """Bytes one device holds of ``tensors`` (a tensor or nested dicts of
    them) under ``specs`` (the same nesting)."""
    if isinstance(tensors, dict):
        return sum(device_bytes(specs[k], v, mesh) for k, v in tensors.items())
    n = 1
    for d in shard_shape(specs, tensors.shape, mesh):
        n *= d
    return n * tensors.element_size()


def placements(spec: Spec, mesh):
    """One ``torch.distributed.tensor`` placement per mesh axis: Shard(d)
    where the axis splits dim d, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dim = next((i for i, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out

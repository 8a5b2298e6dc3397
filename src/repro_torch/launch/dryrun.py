"""Dry run on the meta device: each (architecture x input shape) step's
per-device memory, FLOPs, bytes, peak and collectives on the one-card
mesh and the two production meshes, from the aten ops and collectives
it dispatches.  The counterpart of ``repro/launch/dryrun.py``, which
lowers and compiles each step on 256 or 512 placeholder devices.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
  PYTHONPATH=src python -m repro_torch.launch.roofline --dir build/dryrun

Train shapes run the PPO ``train_step`` (decoupled loss and AdamW,
``accum_steps`` micro-batches) and, under ``"prox"``, the
proximal-logprob recompute on the same batch; prefill shapes
``prefill_step``; decode shapes ``serve_step`` (ONE token against a
seq_len cache or recurrent state), or with ``--paged-cache`` the paged
(``--fused-decode``: fused) step and, with ``--prefill-chunk N``, the
chunked-prefill ingest step.  Every tensor is on the meta device:
nothing is allocated and nothing is computed.

A record holds, for every mesh (``1x1``, ``32x8``, ``2x32x8``;
``launch/mesh.py``), each device's ``argument_bytes`` (the parameters in
bf16, AdamW's m and v in f32, the batch, the cache), computed exactly
from ``dist.sharding.shard_shape``, the f32 gradient accumulators that
``accum_steps`` > 1 holds, and ``stacked_fsdp_bytes``, what keeping the
``stacked_fsdp`` leaves whole on the data axes costs a device beyond the
reference's spec.  Each traced step runs under
``launch/op_analysis.py``: ``flops``, ``bytes``, ``temp_bytes`` (its
peak of live allocations), ``collectives`` (bytes and counts by kind)
and the kernels' own records.  On ``1x1`` the step runs plain (no
collectives).  On ``32x8`` and ``2x32x8`` the train, prox and prefill
steps run sharded (``dist.sharding.distribute_model``) under a ``fake``
process group of 256 or 512 ranks (``fake_world``): the record is rank
0's program, at its local shapes, with the collectives DTensor
dispatches for it, in all and by the mesh axis each runs over
(``collectives_by_axis``).  So do the decode steps (ring, paged, fused,
and the chunked-prefill span under ``"chunk"``), their cache distributed
by ``make_cache_specs``.  The xLSTM's sLSTM steps through time one
token at a time; on meta its loop runs three steps and the analysis
counts the rest as it counts those (``op_analysis``: the reference's
trip-count correction of a ``while`` body), forward, backward and the
bytes the loop's graph holds, so its train and prefill are traced on
every mesh too.

As the reference's, the dry run builds every model with remat
(``build_model(remat=True)``): each unit of the pattern, or each enc-dec
layer, one checkpointed region whose recompute the backward dispatches,
under ``--remat-policy`` "none" (nothing saved inside a unit) or "dots"
(the products with no batch dimension saved); the record's
``remat_policy`` says which, and the output file's tag names "dots".
``build_dryrun(remat=False)`` traces the model without remat (the card's
``steps`` phase holds its plain train step against that).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional, Sequence

import torch

from repro_torch import optim
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_model_config, get_shape
from repro_torch.configs.base import ModelConfig, RLConfig, ShapeConfig
from repro_torch.dist import sharding
from repro_torch.launch import cli, op_analysis
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import Mesh, device_mesh, make_production_mesh
from repro_torch.models import model as model_mod
from repro_torch.obs import trace

ONE_CARD = Mesh(("data", "model"), (1, 1))
MESHES = (ONE_CARD, make_production_mesh(), make_production_mesh(multi_pod=True))
DTYPE = torch.bfloat16


def model_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params), 2*N*D for
    prefill, 2*N per token for decode."""
    n_active = cfg.param_count()
    if cfg.is_moe:
        # active = non-expert params + top-k/E of expert params
        dense_mlp = 3 * cfg.d_model * cfg.d_ff if cfg.act in ("swiglu", "geglu") \
            else 2 * cfg.d_model * cfg.d_ff
        expert_total = cfg.n_layers * cfg.n_experts * dense_mlp
        n_active = n_active - expert_total + cfg.n_layers * cfg.experts_per_token * dense_mlp
    d_tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * d_tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * d_tokens
    return 2.0 * n_active * shape.global_batch          # decode: one token


def skip_reason(cfg: ModelConfig, shape: ShapeConfig, *, paged_cache: bool,
                fused_decode: bool) -> Optional[str]:
    """The reference's skip rules, with its reasons."""
    if paged_cache and (shape.kind != "decode" or cfg.is_encdec):
        return ("--paged-cache applies to decoder-only decode "
                "shapes (DESIGN.md §Arch-applicability)")
    if fused_decode and not paged_cache:
        return ("--fused-decode lowers the paged fast-path step: "
                "combine with --paged-cache on a decode shape "
                "(DESIGN.md §Fused decode tail)")
    if shape.kind == "decode" and shape.seq_len >= 500_000 and not cfg.supports_long_decode:
        return ("pure full attention: long_500k requires "
                "sub-quadratic decode state (DESIGN.md)")
    return None


def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def step_inputs(model, cfg, shape, *, vocab_parallel, accum_steps, paged_cache, block_size,
                 fused_decode):
    """(step, args, argument groups {name: (tensors, specs-of-mesh)})."""
    params = dict(model.named_parameters())
    pspec = lambda mesh, kw: sharding.make_param_specs(cfg, mesh, model, **kw)
    groups = {"param": (params, pspec)}
    if shape.kind == "train":
        step = steps_mod.make_train_step(model, RLConfig(), vocab_parallel_loss=vocab_parallel,
                                         accum_steps=accum_steps)
        opt = optim.init_state(list(params.values()))
        batch = model_mod.train_batch_specs(cfg, shape, DTYPE)
        named_opt = {"m": dict(zip(params, opt["m"])), "v": dict(zip(params, opt["v"]))}
        groups["opt"] = (named_opt, lambda mesh, kw: {k: pspec(mesh, kw) for k in ("m", "v")})
        groups["batch"] = (batch, lambda mesh, kw: sharding.make_train_batch_specs(mesh, batch))
        return step, (opt, batch), groups
    if shape.kind == "prefill":
        # prefix models (VLM) prepend n_prefix_tokens to the prompt
        max_len = shape.seq_len + (cfg.n_prefix_tokens if not cfg.is_encdec else 0)
        step = steps_mod.make_prefill_step(model, max_len, DTYPE)
        batch = model_mod.prefill_batch_specs(cfg, shape, DTYPE)
        groups["batch"] = (batch, lambda mesh, kw: sharding.make_train_batch_specs(mesh, batch))
        return step, (batch,), groups
    b = shape.global_batch
    token = {"token": _i32(b)}
    tok_specs = lambda mesh, kw: {"token": (sharding.batch_spec(mesh, b),)}
    if paged_cache:
        # a pool of equal worst-case capacity: every slot can hold seq_len tokens
        n_blocks = b * -(-shape.seq_len // block_size)
        cache, tables = model_mod.paged_cache_specs(model, cfg, b, shape.seq_len, block_size,
                                                    n_blocks, DTYPE)
        step = (steps_mod.make_fused_serve_step(model) if fused_decode
                else steps_mod.make_paged_serve_step(model))
        args = (token["token"], cache, tables)
        token["tables"] = tables
        tok_specs = lambda mesh, kw: {"token": (sharding.batch_spec(mesh, b),),
                                      "tables": (sharding.batch_spec(mesh, b), None)}
    else:
        cache = model_mod.cache_specs(model, cfg, b, shape.seq_len, DTYPE)
        step = steps_mod.make_serve_step(model)
        args = (token["token"], cache)
    groups["batch"] = (token, tok_specs)
    groups["cache"] = (cache, lambda mesh, kw: sharding.make_cache_specs(cfg, mesh, cache))
    return step, args, groups


def mesh_memory(cfg, model, groups, mesh, *, fsdp, fsdp_pods, accum_steps, kind) -> Dict:
    """Each device's bytes of the step's arguments on ``mesh``."""
    kw = dict(fsdp=fsdp, fsdp_pods=fsdp_pods)
    mem = {f"{name}_bytes": sharding.device_bytes(specs(mesh, kw), tensors, mesh)
           for name, (tensors, specs) in groups.items()}
    mem["argument_bytes"] = sum(mem.values())
    if kind == "train" and accum_steps > 1:
        params = groups["param"][0]
        f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
               for k, p in params.items()}
        mem["grad_accum_bytes"] = sharding.device_bytes(
            sharding.make_param_specs(cfg, mesh, model, **kw), f32, mesh)
    return mem


def _traced(step, args, dm=None) -> Dict:
    """The analysis of ``step(*args)``; on a DeviceMesh ``dm``, its
    collectives also by the mesh axis they ran over."""
    t0 = time.perf_counter()
    _, tally = op_analysis.analyze(step, *args)
    rec = {"program": "traced", "flops": tally.flops, "bytes": tally.bytes,
           "temp_bytes": tally.peak_bytes, "collectives": tally.collectives,
           "kernels": tally.kernels, "n_ops": tally.n_ops}
    if dm is not None:
        axes = {dm.get_group(i).group_name: name for i, name in enumerate(dm.mesh_dim_names)}
        rec["collectives_by_axis"] = {axes[g]: c for g, c in tally.collectives_by_group.items()}
    rec["trace_s"] = time.perf_counter() - t0
    return rec


@contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks, this process rank 0: its
    collectives return at once, so a sharded step runs rank 0's program
    on meta tensors with no other rank present."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def traced_on_mesh(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, kind: str, *,
                   fsdp: bool = True, fsdp_pods: bool = False, vocab_parallel: bool = False,
                   accum_steps: int = 8, paged_cache: bool = False, fused_decode: bool = False,
                   block_size: int = 16, prefill_chunk: int = 0, remat: bool = True,
                   remat_policy: str = "none") -> Dict:
    """Rank 0's program of the ``kind`` ("train", "prox", "prefill" or
    "decode") step at ``shape``, its model and batch distributed over
    ``mesh`` by the partition rules, traced on meta under a fake world of
    ``mesh.size`` ranks.  A decode shape traces ``serve_step`` on the ring
    cache, or with ``paged_cache`` the paged (``fused_decode``: fused) step
    on a pool of equal worst-case capacity, its cache distributed by
    ``make_cache_specs`` and its token and tables' rows on the data axes
    (the reference's ``in_shardings``); with ``prefill_chunk`` also the
    chunked-prefill ingest step, one (1, prefill_chunk) span with its
    inputs replicated, under ``"chunk"``.  The model is built with
    ``remat`` under ``remat_policy``, as ``build_dryrun``'s."""
    with fake_world(mesh.size):
        dm = device_mesh(mesh, "cpu")
        model = model_mod.param_specs(cfg, DTYPE, remat=remat, remat_policy=remat_policy)
        sharding.distribute_model(model, dm, sharding.make_param_specs(
            cfg, mesh, model, fsdp=fsdp, fsdp_pods=fsdp_pods))
        if kind == "decode":
            return _decode_on_mesh(model, cfg, shape, dm, paged_cache=paged_cache,
                                   fused_decode=fused_decode, block_size=block_size,
                                   prefill_chunk=prefill_chunk)
        if kind == "prefill":
            max_len = shape.seq_len + (cfg.n_prefix_tokens if not cfg.is_encdec else 0)
            batch = sharding.distribute_batch(model_mod.prefill_batch_specs(cfg, shape, DTYPE),
                                              dm)
            return _traced(steps_mod.make_prefill_step(model, max_len, DTYPE), (batch,), dm)
        batch = sharding.distribute_batch(model_mod.train_batch_specs(cfg, shape, DTYPE), dm)
        if kind == "prox":
            return _traced(steps_mod.make_prox_logprob_step(model), (batch,), dm)
        step = steps_mod.make_train_step(model, RLConfig(), vocab_parallel_loss=vocab_parallel,
                                         accum_steps=accum_steps)
        return _traced(step, (optim.init_state(list(model.parameters())), batch), dm)


def _decode_on_mesh(model, cfg, shape, dm, *, paged_cache, fused_decode, block_size,
                    prefill_chunk) -> Dict:
    """``traced_on_mesh``'s decode records, inside its fake world."""
    b = shape.global_batch
    token = sharding.distribute_batch({"token": _i32(b)}, dm)["token"]
    if not paged_cache:
        cache = sharding.distribute_cache(
            model, model_mod.cache_specs(model, cfg, b, shape.seq_len, DTYPE), dm)
        return _traced(steps_mod.make_serve_step(model), (token, cache), dm)
    n_blocks = b * -(-shape.seq_len // block_size)
    cache, tables = model_mod.paged_cache_specs(model, cfg, b, shape.seq_len, block_size,
                                                n_blocks, DTYPE)
    cache, tables_d = sharding.distribute_cache(model, cache, dm, tables)
    step = (steps_mod.make_fused_serve_step(model) if fused_decode
            else steps_mod.make_paged_serve_step(model))
    rec = _traced(step, (token, cache, tables_d), dm)
    if prefill_chunk:
        c = prefill_chunk
        ints = (_i32(1, c), _i32(1, tables.shape[1]), _i32(1, c), _i32(1), _i32(1), _i32(1))
        rec["chunk"] = _traced(steps_mod.make_paged_prefill_chunk_step(model),
                               (ints[0], cache, *ints[1:]), dm)
    return rec


def build_dryrun(arch: str, shape_name: str, *, fsdp: bool = True, fsdp_pods: bool = False,
                 vocab_parallel: bool = False, remat_policy: str = "none", accum_steps: int = 8,
                 paged_cache: bool = False, block_size: int = 16, prefill_chunk: int = 0,
                 fused_decode: bool = False, extra: str = "", cfg: Optional[ModelConfig] = None,
                 shape: Optional[ShapeConfig] = None, trace_meshes: bool = True,
                 remat: bool = True, meshes: Optional[Sequence[str]] = None) -> Dict:
    """One record.  ``cfg`` / ``shape`` replace the registry's (a reduced
    config).  ``trace_meshes=False`` traces the one-card step alone (the
    card's prediction for a shape it runs): no sharded program and no
    prox record.  ``meshes`` (names, e.g. "32x8") limits the traced
    meshes to those (the others keep their argument bytes, "not traced").
    The model is built with remat under ``remat_policy``, as the
    reference's dry run builds it; ``remat=False`` traces it without (the
    record's ``remat_policy`` is then None)."""
    cfg = cfg or get_model_config(arch)
    shape = shape or get_shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind, "fsdp": fsdp,
           "fsdp_pods": fsdp_pods, "vocab_parallel": vocab_parallel,
           "remat_policy": remat_policy if remat else None, "accum_steps": accum_steps,
           "paged_cache": paged_cache, "prefill_chunk": prefill_chunk,
           "fused_decode": fused_decode, "extra": extra}
    reason = skip_reason(cfg, shape, paged_cache=paged_cache, fused_decode=fused_decode)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    model = model_mod.param_specs(cfg, DTYPE, remat=remat, remat_policy=remat_policy)
    step, args, groups = step_inputs(model, cfg, shape, vocab_parallel=vocab_parallel,
                                      accum_steps=accum_steps, paged_cache=paged_cache,
                                      block_size=block_size, fused_decode=fused_decode)
    rec["meshes"] = {}
    for mesh in MESHES:
        mem = mesh_memory(cfg, model, groups, mesh, fsdp=fsdp, fsdp_pods=fsdp_pods,
                          accum_steps=accum_steps, kind=shape.kind)
        mem["stacked_fsdp_bytes"] = sharding.stacked_fsdp_bytes(cfg, mesh, model, fsdp=fsdp,
                                                                fsdp_pods=fsdp_pods)
        rec["meshes"][mesh.name] = {"n_devices": mesh.size, "program": "not traced",
                                    "memory": mem}
    traced = lambda m: meshes is None or m.name in meshes        # noqa: E731
    one = rec["meshes"][ONE_CARD.name]
    if traced(ONE_CARD):
        one.update(_traced(step, args))
        one["memory"]["temp_bytes"] = one.pop("temp_bytes")
    sharded_kw = dict(fsdp=fsdp, fsdp_pods=fsdp_pods, vocab_parallel=vocab_parallel,
                      accum_steps=accum_steps, paged_cache=paged_cache,
                      fused_decode=fused_decode, block_size=block_size,
                      prefill_chunk=prefill_chunk, remat=remat, remat_policy=remat_policy)
    for mesh in [m for m in MESHES[1:] if traced(m)] if trace_meshes else ():
        entry = rec["meshes"][mesh.name]
        entry.update(traced_on_mesh(cfg, shape, mesh, shape.kind, **sharded_kw))
        entry["memory"]["temp_bytes"] = entry.pop("temp_bytes")
    if shape.kind == "train" and trace_meshes and meshes is None:
        rec["prox"] = prox_dryrun(cfg, shape, sharded=True, fsdp=fsdp, fsdp_pods=fsdp_pods)
    if prefill_chunk and shape.kind == "decode" and paged_cache:
        # the chunked-prefill ingest step: one (1, prefill_chunk) span
        # scattered into the pool through a slot's table
        cache, tables = args[1], args[2]
        chunk = steps_mod.make_paged_prefill_chunk_step(model)
        c = prefill_chunk
        ints = (_i32(1, c), _i32(1, tables.shape[1]), _i32(1, c), _i32(1), _i32(1), _i32(1))
        rec["chunk"] = _traced(chunk, (ints[0], cache, *ints[1:]))
        mem = one["memory"]
        rec["chunk"]["argument_bytes"] = (mem["param_bytes"] + mem["cache_bytes"]
                                          + sum(x.numel() * 4 for x in ints))
    rec["model_flops"] = model_flops_estimate(cfg, shape)
    rec["status"] = "ok"
    return rec


def prox_dryrun(cfg: ModelConfig, shape: ShapeConfig, *, sharded: bool = False,
                fsdp: bool = True, fsdp_pods: bool = False) -> Dict:
    """The record of the proximal-logprob step on a train batch of
    ``shape``, the recompute a batch's arrival runs before its
    ``train_step``: argument bytes and the traced step on the one-card
    mesh and, with ``sharded``, on the production meshes too (no remat:
    the recompute runs without gradients)."""
    model = model_mod.param_specs(cfg, DTYPE)
    batch = model_mod.train_batch_specs(cfg, shape, DTYPE)
    pspec = lambda mesh, kw: sharding.make_param_specs(cfg, mesh, model, **kw)   # noqa: E731
    groups = {"param": (dict(model.named_parameters()), pspec),
              "batch": (batch, lambda mesh, kw: sharding.make_train_batch_specs(mesh, batch))}
    meshes = {}
    for mesh in MESHES if sharded else (ONE_CARD,):
        mem = mesh_memory(cfg, model, groups, mesh, fsdp=fsdp, fsdp_pods=fsdp_pods,
                          accum_steps=1, kind="prefill")
        if mesh is ONE_CARD:
            traced = _traced(steps_mod.make_prox_logprob_step(model), (batch,))
        else:
            traced = traced_on_mesh(cfg, shape, mesh, "prox", fsdp=fsdp, fsdp_pods=fsdp_pods)
        mem["temp_bytes"] = traced.pop("temp_bytes")
        meshes[mesh.name] = {"n_devices": mesh.size, "memory": mem, **traced}
    prefill = ShapeConfig(shape.name, seq_len=shape.seq_len, global_batch=shape.global_batch,
                          kind="prefill")
    return {"meshes": meshes, "model_flops": model_flops_estimate(cfg, prefill)}


def record_tag(rec: Dict, args) -> str:
    """The output file's name, with the reference's parts in its order
    (the policy after "vp" where it is not "none")."""
    return "_".join(filter(None, [
        rec["arch"], rec["shape"], "vp" if args.vocab_parallel else "",
        args.remat_policy if args.remat_policy != "none" else "",
        "nofsdp" if args.no_fsdp else "", "fsdppods" if args.fsdp_pods else "",
        "paged" if args.paged_cache else "", "fused" if args.fused_decode else "",
        args.extra]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--fsdp-pods", action="store_true",
                    help="cross-pod ZeRO (for models whose optimizer state "
                         "exceeds a pod's memory)")
    ap.add_argument("--vocab-parallel", action="store_true")
    ap.add_argument("--remat-policy", default="none", choices=["none", "dots"])
    ap.add_argument("--accum", type=int, default=8,
                    help="grad-accumulation micro-steps inside train_step")
    cli.add_engine_flags(ap, dryrun=True)
    cli.add_obs_flags(ap)
    ap.add_argument("--mesh", action="append", default=None,
                    choices=[m.name for m in MESHES],
                    help="trace only this mesh (repeatable; default every one, and the "
                         "prox record of a train shape)")
    ap.add_argument("--extra", default="", help="free-form variant tag")
    ap.add_argument("--out", default=None, help="output dir for JSON records")
    args = ap.parse_args(argv)
    cli.obs_setup(args, actor="dryrun")
    # DTensor warns at every reduction of a tensor partial over two mesh dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    if args.all:
        pairs = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]

    ok = True
    for arch, shp in pairs:
        try:
            with trace.span("dryrun.build", arch=arch, shape=shp):
                rec = build_dryrun(arch, shp, fsdp=not args.no_fsdp, fsdp_pods=args.fsdp_pods,
                                   vocab_parallel=args.vocab_parallel,
                                   remat_policy=args.remat_policy,
                                   accum_steps=args.accum, paged_cache=args.paged_cache,
                                   block_size=args.block_size,
                                   prefill_chunk=args.prefill_chunk,
                                   fused_decode=args.fused_decode, extra=args.extra,
                                   meshes=args.mesh)
        except Exception as e:  # a dry-run failure is a bug in the system
            rec = {"arch": arch, "shape": shp, "status": "FAILED",
                   "error": f"{type(e).__name__}: {e}"}
            ok = False
        print(json.dumps(rec), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, record_tag(rec, args) + ".json"), "w") as f:
                json.dump(rec, f, indent=2)
    cli.obs_finish(args)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

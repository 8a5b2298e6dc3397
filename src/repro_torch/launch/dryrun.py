"""Dry run on the meta device: each (architecture x input shape) step's
per-device memory on the one-card mesh and the two production meshes,
and, on the one-card mesh, the step's FLOPs, bytes and peak from the aten
ops it dispatches.  The counterpart of ``repro/launch/dryrun.py``, which
lowers and compiles each step on 256 or 512 placeholder devices.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
  PYTHONPATH=src python -m repro_torch.launch.roofline --dir build/dryrun

Train shapes run the PPO ``train_step`` (decoupled loss and AdamW,
``accum_steps`` micro-batches), prefill shapes ``prefill_step``, decode
shapes ``serve_step`` (ONE token against a seq_len cache or recurrent
state), or with ``--paged-cache`` the paged (``--fused-decode``: fused)
step and, with ``--prefill-chunk N``, the chunked-prefill ingest step.
Every tensor is on the meta device: nothing is allocated and nothing is
computed.

A record holds, for every mesh (``1x1``, ``32x8``, ``2x32x8``;
``launch/mesh.py``), each device's ``argument_bytes`` (the parameters in
bf16, AdamW's m and v in f32, the batch, the cache), computed exactly
from ``dist.sharding.shard_shape``, and the f32 gradient accumulators
that ``accum_steps`` > 1 holds.  On ``1x1`` the step runs on meta under
``launch/op_analysis.py``: ``flops``, ``bytes``, ``temp_bytes`` (its
peak of live allocations), ``collectives`` (none: one card) and the
kernels' own records.  A mesh of more than one device is ``"program":
"not traced"``: the port builds no sharded program yet, and a share of
the one-card figures would read as measured.  The reference's
``remat_policy`` has no counterpart (the port keeps every activation):
the record says ``"none"``.  The xLSTM's train and prefill shapes are not
traced either: its sLSTM steps through time one token at a time, and the
meta device dispatches each of those ops in Python (millions of them at
4096 tokens and more); eager analysis has no loop body to count once.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import torch

from repro_torch import optim
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_model_config, get_shape
from repro_torch.configs.base import ModelConfig, RLConfig, ShapeConfig
from repro_torch.dist import sharding
from repro_torch.launch import cli, op_analysis
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import Mesh, make_production_mesh
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


def _traced(step, args) -> Dict:
    t0 = time.perf_counter()
    _, tally = op_analysis.analyze(step, *args)
    return {"program": "traced", "flops": tally.flops, "bytes": tally.bytes,
            "temp_bytes": tally.peak_bytes, "collectives": {},
            "kernels": tally.kernels, "n_ops": tally.n_ops,
            "trace_s": time.perf_counter() - t0}


def build_dryrun(arch: str, shape_name: str, *, fsdp: bool = True, fsdp_pods: bool = False,
                 vocab_parallel: bool = False, accum_steps: int = 8, paged_cache: bool = False,
                 block_size: int = 16, prefill_chunk: int = 0, fused_decode: bool = False,
                 extra: str = "", cfg: Optional[ModelConfig] = None,
                 shape: Optional[ShapeConfig] = None) -> Dict:
    """One record.  ``cfg`` / ``shape`` replace the registry's (a reduced
    config)."""
    cfg = cfg or get_model_config(arch)
    shape = shape or get_shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind, "fsdp": fsdp,
           "fsdp_pods": fsdp_pods, "vocab_parallel": vocab_parallel,
           "remat_policy": "none", "accum_steps": accum_steps, "paged_cache": paged_cache,
           "prefill_chunk": prefill_chunk, "fused_decode": fused_decode, "extra": extra}
    reason = skip_reason(cfg, shape, paged_cache=paged_cache, fused_decode=fused_decode)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    model = model_mod.param_specs(cfg, DTYPE)
    step, args, groups = step_inputs(model, cfg, shape, vocab_parallel=vocab_parallel,
                                      accum_steps=accum_steps, paged_cache=paged_cache,
                                      block_size=block_size, fused_decode=fused_decode)
    rec["meshes"] = {}
    for mesh in MESHES:
        rec["meshes"][mesh.name] = {
            "n_devices": mesh.size, "program": "not traced",
            "memory": mesh_memory(cfg, model, groups, mesh, fsdp=fsdp, fsdp_pods=fsdp_pods,
                                  accum_steps=accum_steps, kind=shape.kind)}
    one = rec["meshes"][ONE_CARD.name]
    if cfg.family == "ssm" and shape.kind != "decode":
        one["reason"] = ("the sLSTM's per-token loop dispatches millions of ops on meta; "
                         "eager analysis has no loop body to count once")
    else:
        one.update(_traced(step, args))
        one["memory"]["temp_bytes"] = one.pop("temp_bytes")
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


def prox_dryrun(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The one-card record of the proximal-logprob step on a train batch
    of ``shape``, the recompute a batch's arrival runs before its
    ``train_step``: argument bytes, and the traced step."""
    model = model_mod.param_specs(cfg, DTYPE)
    batch = model_mod.train_batch_specs(cfg, shape, DTYPE)
    mem = {"param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "batch_bytes": sum(x.numel() * x.element_size() for x in batch.values())}
    mem["argument_bytes"] = mem["param_bytes"] + mem["batch_bytes"]
    one = {"n_devices": 1, "memory": mem,
           **_traced(steps_mod.make_prox_logprob_step(model), (batch,))}
    mem["temp_bytes"] = one.pop("temp_bytes")
    prefill = ShapeConfig(shape.name, seq_len=shape.seq_len, global_batch=shape.global_batch,
                          kind="prefill")
    return {"meshes": {ONE_CARD.name: one}, "model_flops": model_flops_estimate(cfg, prefill)}


def record_tag(rec: Dict, args) -> str:
    return "_".join(filter(None, [
        rec["arch"], rec["shape"], "vp" if args.vocab_parallel else "",
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
    ap.add_argument("--accum", type=int, default=8,
                    help="grad-accumulation micro-steps inside train_step")
    cli.add_engine_flags(ap, dryrun=True)
    cli.add_obs_flags(ap)
    ap.add_argument("--extra", default="", help="free-form variant tag")
    ap.add_argument("--out", default=None, help="output dir for JSON records")
    args = ap.parse_args(argv)
    cli.obs_setup(args, actor="dryrun")

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
                                   accum_steps=args.accum, paged_cache=args.paged_cache,
                                   block_size=args.block_size,
                                   prefill_chunk=args.prefill_chunk,
                                   fused_decode=args.fused_decode, extra=args.extra)
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

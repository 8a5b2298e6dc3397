"""Sharded steps in a local world of processes: the step functions and
the forward of a model distributed over a ``DeviceMesh``
(``dist.sharding.distribute_model``), each rank a process of its own.

``run_world(fn, n, job)`` spawns ``n`` processes, joins them into one
``torch.distributed`` process group over ``tcp://127.0.0.1:<free port>``
and returns each rank's ``fn(rank, n, job)`` in rank order; it raises if
a rank raised, or if the world has not finished within ``timeout``
seconds (its processes are then killed).  The backend is ``gloo``: on
the CPU, and where several ranks share one card (NCCL refuses two ranks
on one device; ``dist/host_staged.py`` stages the collectives gloo cannot
carry on CUDA tensors through host memory), so that nothing a four-card
run would time is timed there.

The world programs, ``train_world``, ``forward_world``, ``infer_world``
(the prox and prefill steps) and ``serve_world`` (``serve_program``: the
serving steps in sequence), take a job dict and return plain data (numpy
arrays and numbers): the parameters after the steps or the logits, on
rank 0; on every rank the kernels' launches (``ops.LAUNCHES``) and the
local head counts the kernels saw (``ops.KERNEL_HEADS``).  The job's weights are either a flat dict of
the reference's tree (``models/convert.py::params_from_jax``) or a seed
for ``LM.init``, the same on every rank; ``job["remat"]`` builds the
model with remat under that policy.  ``push_world`` is the reference's
``disaggregated.demo``: the world split into a rollout and a trainer
mesh, the trainer's weights pushed across and served on the rollout
side.  A job's mesh spans the world's
first ranks; the others return ``IDLE`` for it, so one world serves
meshes of several sizes.  With ``job["reference"]``, the
path of a ``torch.save``d dict of the one-process result (parameters by
name, or ``{"logits": ...}``), rank 0 returns ``max_abs_err`` against it
in place of the arrays (a card's full-width parameters are too large to
pickle back).  ``jobs_world`` runs a list of
(program name, job) pairs in one world, so that one spawn serves them
all.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from contextlib import nullcontext
from typing import Any, Callable, Dict, List

import numpy as np
import torch

SPAWN = mp.get_context("spawn")
IDLE = None          # a world program's result on a rank outside its job's mesh


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, port: int, job, results) -> None:
    import faulthandler
    import logging

    import torch.distributed as dist
    faulthandler.enable()           # a rank that dies on a signal shows where
    # DTensor warns at every reduction of a tensor partial over two mesh dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=n)
        try:
            results.put((rank, True, fn(rank, n, job)))
        finally:
            dist.destroy_process_group()
    except BaseException:           # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, n: int, job: Dict[str, Any], *, timeout: float = 120.0) -> List:
    """``[fn(rank, n, job) for rank in range(n)]``, each in its own process
    of one gloo world.  ``fn`` must be importable by name (spawn)."""
    results = SPAWN.Queue()
    port = free_port()
    procs = [SPAWN.Process(target=_rank_main, args=(fn, r, n, port, job, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    out, errors, seen = {}, [], set()
    deadline = time.monotonic() + timeout
    try:
        while len(seen) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # a rank puts its result before it exits: one that has exited
                # with nothing in the queue died without one
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in seen]
                if dead and results.empty():
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world of {n} ranks not done within {timeout} s "
                                       f"(ranks done: {sorted(seen)})") from None
                continue
            seen.add(rank)
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [out[r] for r in range(n)]
    finally:
        # a rank has sent its result before it exits: a few seconds for all
        # to leave, then the stragglers are killed
        leave_by = time.monotonic() + 5
        for p in procs:
            p.join(timeout=max(leave_by - time.monotonic(), 0.01))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


# ---------------------------------------------------------------------------
# world programs
# ---------------------------------------------------------------------------

def _setup(rank: int, job):
    """(model, DeviceMesh) of the job on this rank: the model built whole
    from the job's weights, then distributed by the partition rules; (None,
    None) on a rank outside the job's mesh (it spans the world's first
    ranks)."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import build_model
    from repro_torch.dist import host_staged
    torch.set_num_threads(1)        # ranks share the host's cores
    cfg, device = job["cfg"], job.get("device", "cpu")
    if device == "cuda":
        # every rank on the one card: gloo, with its failing collectives
        # staged through host memory
        torch.cuda.set_device(0)
        host_staged.install("CUDA")
    elif job.get("host_staged"):
        host_staged.install("CPU")
    mesh = Mesh(("data", "model"), tuple(job["mesh"]))
    dm = device_mesh(mesh, device)
    if dm.get_coordinate() is None:
        return None, None
    dtype = getattr(torch, job.get("dtype", "float32"))
    if job.get("weights") is not None:
        model = params_from_jax(cfg, job["weights"], device=device, dtype=dtype)
    else:
        model = build_model(cfg, device=device, dtype=dtype)
        model.init(torch.Generator(device=device).manual_seed(job["seed"]))
    # job["remat"]: the remat policy ("none" or "dots") of the training forward
    model.remat, model.remat_policy = job.get("remat") is not None, job.get("remat") or "none"
    specs = sharding.make_param_specs(cfg, mesh, model, fsdp=job.get("fsdp", True))
    sharding.distribute_model(model, dm, specs)
    return model, dm


class DTensorOpWatch:
    """A ``TorchDispatchMode`` for the ``with`` body that records, by name,
    every aten op dispatched with a DTensor argument: what DTensor's own
    rules are asked to plan (the mode sees the op before DTensor's
    dispatch, then steps aside for it).  ``scopes`` (name -> [(module,
    attribute)]) patches those functions for the body so that the ops
    dispatched inside each are also kept apart (``in_scope[name]``)."""

    def __init__(self, scopes=None):
        self.ops: Dict[str, int] = {}
        self.in_scope: Dict[str, Dict[str, int]] = {n: {} for n in scopes or {}}
        self._scopes = scopes or {}
        self._depth = {n: 0 for n in self._scopes}
        self._saved, self._mode = [], None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten
        from torch.distributed.tensor import DTensor
        watch = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                flat, _ = tree_flatten((args, kwargs or {}))
                if not any(isinstance(a, DTensor) for a in flat):
                    return func(*args, **(kwargs or {}))
                name = str(func)
                watch.ops[name] = watch.ops.get(name, 0) + 1
                for scope, depth in watch._depth.items():
                    if depth:
                        seen = watch.in_scope[scope]
                        seen[name] = seen.get(name, 0) + 1
                return NotImplemented

        for scope, targets in self._scopes.items():
            for module, attr in targets:
                fn = getattr(module, attr)
                self._saved.append((module, attr, fn))
                setattr(module, attr, self._scoped(scope, fn))
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def _scoped(self, scope, fn):
        def inner(*args, **kwargs):
            self._depth[scope] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth[scope] -= 1
        return inner

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        return False


def conv_scopes():
    """``DTensorOpWatch`` scopes of the RG-LRU's conv: its training/prefill
    form and its decode step."""
    from repro_torch.models import layers
    return {"conv": [(layers, "causal_conv1d_apply"), (layers, "causal_conv1d_step")]}


def _report() -> Dict[str, Any]:
    from repro_torch.kernels import ops
    return {"launches": {k: v for k, v in ops.LAUNCHES.items() if v},
            "local_heads": sorted(ops.KERNEL_HEADS["flash_attention"])}


def train_world(rank: int, n: int, job) -> Dict[str, Any]:
    """``job["steps"]`` train steps (``launch/steps.py``) of the job's
    model on its mesh from one batch; returns each step's metrics and wall
    ms (a wait for the step's last kernel closes each on the card), the
    seconds of the set-up and of the rest, and on rank 0 the parameters
    after the steps by name (those named in ``job["params"]``, default
    every one)."""
    from repro_torch import optim
    from repro_torch.configs.base import RLConfig
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    t0 = time.perf_counter()
    model, dm = _setup(rank, job)
    if model is None:
        return IDLE
    device = job.get("device", "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in job["batch"].items()}
    batch = sharding.distribute_batch(batch, dm)
    step = steps.make_train_step(model, job.get("rl", RLConfig()),
                                 accum_steps=job.get("accum", 1))
    opt = optim.init_state(list(model.parameters()))
    ops.reset_launches()
    setup_s, t0 = time.perf_counter() - t0, time.perf_counter()
    metrics, ms = [], []
    watch = DTensorOpWatch(conv_scopes()) if job.get("watch_dtensor_ops") else None
    for i in range(job.get("steps", 1)):
        t0 = time.perf_counter()
        with watch if watch is not None and i == 0 else nullcontext():
            met = step(opt, batch)
        if device == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in met.items()})
    out = {"rank": rank, "metrics": metrics, "ms": ms, **_report()}
    if watch is not None:
        out["dtensor_ops"] = {"step": watch.ops, **watch.in_scope}
    keep = job.get("params")
    full = {name: p.full_tensor().detach() for name, p in model.named_parameters()
            if keep is None or name in keep}
    if rank == 0:
        out.update(_result(job, full, "params"))
    return {**out, "setup_s": setup_s, "run_s": time.perf_counter() - t0}


def _result(job, got: Dict[str, torch.Tensor], key: str) -> Dict[str, Any]:
    """Rank 0's arrays under ``key`` ("params": every one by name;
    "logits": the one), or their largest difference from the job's
    reference file."""
    if "reference" not in job:
        arrays = {n: t.float().cpu().numpy() for n, t in got.items()}
        return {key: arrays if key == "params" else arrays[key]}
    want = torch.load(job["reference"], map_location=got[next(iter(got))].device)
    return {"max_abs_err": max((got[n].float() - w.float()).abs().max().item()
                               for n, w in want.items())}


def forward_world(rank: int, n: int, job) -> Dict[str, Any]:
    """The job's model's forward on its tokens (B, S), rows on the data
    axes, under its mesh; returns on rank 0 the logits and aux."""
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import use_mesh
    t0 = time.perf_counter()
    model, dm = _setup(rank, job)
    if model is None:
        return IDLE
    device = job.get("device", "cpu")
    tokens = torch.from_numpy(np.asarray(job["tokens"])).to(device)
    ops.reset_launches()
    setup_s, t0 = time.perf_counter() - t0, time.perf_counter()
    with torch.no_grad(), use_mesh(dm):
        tokens = sharding.distribute_batch({"tokens": tokens}, dm)["tokens"]
        logits, aux = model(tokens)
        logits = logits.full_tensor()
        aux = {k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
               for k, v in aux.items()}
    out = {"rank": rank, "aux": aux, **_report()}
    if rank == 0:
        out.update(_result(job, {"logits": logits}, "logits"))
    return {**out, "setup_s": setup_s, "run_s": time.perf_counter() - t0}


def infer_world(rank: int, n: int, job) -> Dict[str, Any]:
    """``job["step"]``, "prox" (``make_prox_logprob_step``: the per-token
    logprobs of the job's train batch) or "prefill" (``make_prefill_step``
    of ``job["max_len"]`` positions over the job's prompts: the last
    token's logits and the ring cache), on the job's mesh; returns on rank
    0 their whole values by name."""
    from repro_torch.dist import sharding
    from repro_torch.launch import steps
    model, dm = _setup(rank, job)
    if model is None:
        return IDLE
    device = job.get("device", "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in job["batch"].items()}
    batch = sharding.distribute_batch(batch, dm)
    if job["step"] == "prox":
        got = {"logprobs": steps.make_prox_logprob_step(model)(batch)}
    else:
        logits, cache = steps.make_prefill_step(model, job["max_len"], model.dtype)(batch)
        got = {"logits": logits, **{f"cache.{k}": v for k, v in cache.items()}}
    got = {k: v.full_tensor() for k, v in got.items()}
    out = {"rank": rank}
    if rank == 0:
        out["outputs"] = {k: v.float().cpu().numpy() for k, v in got.items()}
    return out


def serve_inputs(job):
    """The serving program's fixed inputs, as numpy: the prompts (B, S)
    and their lengths, the ring cache's length, the pool's block size,
    entries a table and tables (slot i owns blocks i E .. i E + E - 1),
    the prompts' destination blocks, and the last span (slot 1's)."""
    prompts = np.asarray(job["prompts"], np.int32)
    length = np.asarray(job["length"], np.int32)
    b, s = prompts.shape
    steps, span = job["steps"], np.asarray(job["span"], np.int32)
    paged_steps = job.get("paged_steps", steps)
    max_len = s + max(steps, 2 * paged_steps) + span.shape[1] + 1
    bs = job.get("block_size", 16)
    e = -(-max_len // bs)
    tables = np.arange(b * e, dtype=np.int32).reshape(b, e)
    cols = np.arange(s)
    dest = np.where(cols[None] < length[:, None], tables[:, cols // bs], -1).astype(np.int32)
    return dict(prompts=prompts, length=length, steps=steps, paged_steps=paged_steps, span=span,
                max_len=max_len,
                block_size=bs, n_blocks=b * e, tables=tables, dest=dest)


def serve_program(model, job, dm=None, timer=None):
    """The serving steps of ``launch/steps.py`` in sequence on ``model``,
    sharded on DeviceMesh ``dm`` (the model distributed on it) or in one
    process: ``prefill_step`` of the job's prompts, ``job["steps"]`` ring
    decode steps (``serve_step``), the prompts into a pool, one span a slot
    from position 0 (``paged_prefill_chunk_step``), ``job["paged_steps"]``
    (default ``job["steps"]``) paged steps (``paged_serve_step``) and as
    many fused ones
    (``fused_serve_step``), then one span of ``job["span"]`` for slot 1
    continuing from its position.  Every step after a prefill is fed the
    greedy tokens of the one before.  Returns (each step's logits by name,
    whole, as plain tensors; the greedy tokens; the paged cache).
    ``timer(name, fn)`` runs each step (default: calls it)."""
    from repro_torch.dist import sharding
    from repro_torch.launch import steps
    timer = timer or (lambda name, fn: fn())
    inp = serve_inputs(job)
    dev, dtype = model.device, model.dtype
    if dev.type == "meta":
        raise ValueError("the serving program runs on a real device")
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)                 # noqa: E731
    rows = lambda x: sharding.distribute_batch({"x": x}, dm)["x"] if dm is not None else x  # noqa: E731
    whole = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x  # noqa: E731
    logits, tokens = {}, []

    def keep(name, out):
        full = whole(out).float()
        logits[name] = full
        tok = full.argmax(dim=-1).to(torch.int32)
        tokens.append(tok.cpu().numpy())
        return tok

    batch = {"tokens": rows(t(inp["prompts"])), "length": rows(t(inp["length"]))}
    out, cache = timer("prefill", lambda: steps.make_prefill_step(model, inp["max_len"],
                                                                  dtype)(batch))
    tok = keep("prefill", out)
    serve = steps.make_serve_step(model)
    for i in range(inp["steps"]):
        out, cache = timer("ring", lambda: serve(rows(tok), cache))
        tok = keep(f"ring.{i}", out)
    del cache
    b = inp["prompts"].shape[0]
    pc = model.init_paged_cache(b, inp["n_blocks"], inp["block_size"], dtype)
    tables = t(inp["tables"])
    if dm is not None:
        pc, tables_d = sharding.distribute_cache(model, pc, dm, tables)
    else:
        tables_d = tables
    chunk = steps.make_paged_prefill_chunk_step(model)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    out, pc = timer("chunk", lambda: chunk(t(inp["prompts"]), pc, tables, t(inp["dest"]),
                                           torch.arange(b, dtype=torch.int32, device=dev),
                                           zeros, t(inp["length"])))
    tok = keep("chunk_prefill", out)
    for kind, fn in (("paged", steps.make_paged_serve_step(model)),
                     ("fused", steps.make_fused_serve_step(model))):
        for i in range(inp["paged_steps"]):
            out, pc = timer(kind, lambda: fn(rows(tok), pc, tables_d))
            tok = keep(f"{kind}.{i}", out)
    span = inp["span"]
    start = whole(pc["t"])[1:2].to(torch.int32)
    pos = int(start[0]) + np.arange(span.shape[1])
    dest = inp["tables"][1, pos // inp["block_size"]][None].astype(np.int32)
    out, pc = timer("chunk", lambda: chunk(t(span), pc, tables[1:2].clone(), t(dest),
                                           torch.ones(1, dtype=torch.int32, device=dev), start,
                                           torch.full((1,), span.shape[1] - 1,
                                                      dtype=torch.int32, device=dev)))
    keep("span", out)
    return logits, tokens, pc


def pool_digest(cache) -> Dict[str, str]:
    """sha256 of the bytes of this rank's local shard of each pool tensor."""
    import hashlib
    out = {}
    for name in ("k_pool", "v_pool"):
        if name in cache:
            x = cache[name]
            x = x.to_local() if hasattr(x, "to_local") else x
            out[name] = hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy()
                                       .tobytes()).hexdigest()
    return out


def serve_world(rank: int, n: int, job) -> Dict[str, Any]:
    """``serve_program`` on the job's mesh; returns on rank 0 each step's
    logits (numpy, unless ``job["return_logits"]`` is False; with
    ``job["reference"]`` their largest difference from the one-process
    run's, by step) and the greedy tokens, and on
    every rank its coordinate on the mesh, its local pool's digest
    (``pool_digest``: the data replicas must hold equal pools), the
    launches, the (q heads, kv heads) each kernel saw, and each step
    kind's wall ms (a wait for the step's last kernel closes each on the
    card); with ``job["watch_dtensor_ops"]`` the ops DTensor was asked to
    plan (``DTensorOpWatch``), in all and inside the conv."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    model, dm = _setup(rank, job)
    if model is None:
        return IDLE
    device = job.get("device", "cpu")
    ms: Dict[str, List[float]] = {}

    def timer(name, fn):
        t1 = time.perf_counter()
        out = fn()
        if device == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        ms.setdefault(name, []).append((time.perf_counter() - t1) * 1e3)
        return out

    ops.reset_launches()
    setup_s, t0 = time.perf_counter() - t0, time.perf_counter()
    watch = DTensorOpWatch(conv_scopes()) if job.get("watch_dtensor_ops") else nullcontext()
    with torch.no_grad(), watch:
        logits, tokens, pc = serve_program(model, job, dm, timer)
    out = {"rank": rank, "coordinate": list(dm.get_coordinate()), "pool": pool_digest(pc),
           "ms": ms,
           "kernel_heads": {k: sorted(v) for k, v in ops.KERNEL_HEADS.items() if v},
           **_report()}
    if isinstance(watch, DTensorOpWatch):
        out["dtensor_ops"] = {"step": watch.ops, **watch.in_scope}
    if rank == 0:
        out["tokens"] = [x.tolist() for x in tokens]
        if "reference" in job:
            want = torch.load(job["reference"], map_location=next(iter(logits.values())).device)
            out["max_abs_err"] = {k: (logits[k] - w.float()).abs().max().item()
                                  for k, w in want.items()}
        elif job.get("return_logits", True):
            out["logits"] = {k: v.cpu().numpy() for k, v in logits.items()}
    return {**out, "setup_s": setup_s, "run_s": time.perf_counter() - t0}


def rollout_program(model, job, dm=None):
    """The demo's serving on the rollout side: ``prefill_step`` of the
    job's prompts (``job["max_len"]`` positions), then
    ``job["decode_steps"]`` ring decode steps, each fed the greedy tokens
    of the one before, on DeviceMesh ``dm`` (the model distributed on it)
    or in one process.  Returns ({"prefill": logits, "decode.i": ...},
    whole f32; the greedy tokens)."""
    from repro_torch.dist import sharding
    from repro_torch.launch import steps
    dev = model.device
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)                 # noqa: E731
    rows = lambda x: sharding.distribute_batch({"x": x}, dm)["x"] if dm is not None else x  # noqa: E731
    whole = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x  # noqa: E731
    batch = {"tokens": rows(t(job["prompts"])), "length": rows(t(job["length"]))}
    out, cache = steps.make_prefill_step(model, job["max_len"], model.dtype)(batch)
    logits, tokens = {"prefill": whole(out).float()}, []
    tok = logits["prefill"].argmax(dim=-1).to(torch.int32)
    tokens.append(tok.cpu().numpy().tolist())
    serve = steps.make_serve_step(model)
    for i in range(job["decode_steps"]):
        out, cache = serve(rows(tok), cache)
        logits[f"decode.{i}"] = whole(out).float()
        tok = logits[f"decode.{i}"].argmax(dim=-1).to(torch.int32)
        tokens.append(tok.cpu().numpy().tolist())
    return logits, tokens


def push_world(rank: int, n: int, job) -> Dict[str, Any]:
    """The reference's ``disaggregated.demo`` on this world: the world split
    by ``split_meshes(job["train_fraction"], model_parallel=...)``; every
    rank builds the job's model from its seed (the one-process weights) and
    distributes it on the trainer mesh (FSDP as ``job["fsdp"]``, default
    on); then ``job["pushes"]`` times ``push_weights`` onto the rollout mesh
    by its partition specs (no FSDP, as the serving steps run) and, on the
    rollout ranks, ``rollout_program`` on the pushed weights.  Returns on
    every rank its role, bytes received and sent, and whether every pushed
    shard equals, bit for bit, DTensor's own slice of the one-process
    weights by the same placements; on rollout ranks the launches and
    local heads; on rank 0 (a rollout rank) the greedy tokens, whether the
    logits were finite, and the logits (or, with ``job["reference"]``,
    their largest difference from the file's by step)."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch import nn

    from repro_torch.dist import host_staged, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import disaggregated
    from repro_torch.launch.mesh import mesh_of
    from repro_torch.models.model import build_model
    torch.set_num_threads(1)
    cfg, device = job["cfg"], job.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)
        host_staged.install("CUDA")
    dtype = getattr(torch, job.get("dtype", "float32"))
    t0 = time.perf_counter()
    roll_dm, train_dm = disaggregated.split_meshes(job["train_fraction"],
                                                   model_parallel=job["model_parallel"],
                                                   device_type=device)
    model = build_model(cfg, device=device, dtype=dtype)
    model.init(torch.Generator(device=device).manual_seed(job["seed"]))
    rollout = roll_dm.get_coordinate() is not None
    full = {k: p.detach().clone() for k, p in model.named_parameters()} if rollout else {}
    sharding.distribute_model(model, train_dm, sharding.make_param_specs(
        cfg, mesh_of(train_dm), model, fsdp=job.get("fsdp", True)))
    roll_specs = sharding.make_param_specs(cfg, mesh_of(roll_dm), model, fsdp=False)
    ops.reset_launches()
    setup_s = time.perf_counter() - t0
    out = {"rank": rank, "role": "rollout" if rollout else "trainer", "push_s": [],
           "bytes_received": [], "bytes_sent": [], "finite": []}
    for _ in range(job["pushes"]):
        report: Dict[str, Any] = {}
        t0 = time.perf_counter()
        pushed = disaggregated.push_weights(model, roll_dm, roll_specs, report=report)
        dist.barrier()
        out["push_s"].append(time.perf_counter() - t0)
        out["bytes_received"].append(report["bytes_received"])
        out["bytes_sent"].append(report["bytes_sent"])
        out["replicated"] = report["replicated"]
        if not rollout:
            continue
        out["shard_bytes"] = sum(d.to_local().numel() * d.element_size() for d in pushed.values())
        out["shards_equal"] = all(
            torch.equal(d.to_local(), distribute_tensor(full[k], roll_dm, d.placements,
                                                        src_data_rank=None).to_local())
            for k, d in pushed.items())
        served = build_model(cfg, device="meta", dtype=dtype)
        for k, d in pushed.items():
            owner, _, leaf = k.rpartition(".")
            setattr(served.get_submodule(owner) if owner else served, leaf,
                    nn.Parameter(d, requires_grad=False))
        with torch.no_grad():
            logits, tokens = rollout_program(served, job, roll_dm)
        out["finite"].append(all(bool(torch.isfinite(v).all()) for v in logits.values()))
        out["tokens"] = tokens
    if rollout:
        out.update(_report(), kernel_heads={k: sorted(v) for k, v in ops.KERNEL_HEADS.items()
                                            if v})
    if rank == 0:
        if "reference" in job:
            want = torch.load(job["reference"], map_location=logits["prefill"].device)
            out["max_abs_err"] = {k: (logits[k] - w.float()).abs().max().item()
                                  for k, w in want.items()}
        else:
            out["logits"] = {k: v.cpu().numpy() for k, v in logits.items()}
    out["setup_s"] = setup_s
    return out


PROGRAMS = {"train": train_world, "forward": forward_world, "infer": infer_world,
            "serve": serve_world, "push": push_world}


def jobs_world(rank: int, n: int, jobs) -> List[Dict[str, Any]]:
    """``PROGRAMS[name](rank, n, job)`` for each (name, job) of ``jobs``,
    in order, each with its launch counts from 0 (``IDLE`` where the rank
    is outside the job's mesh), what a job held collected before the next
    starts; a result that is a dict gets the job's wall seconds on this
    rank (``job_s``)."""
    import gc
    out = []
    for name, job in jobs:
        t0 = time.perf_counter()
        res = PROGRAMS[name](rank, n, job)
        if isinstance(res, dict):
            res["job_s"] = time.perf_counter() - t0
        out.append(res)
        # the job's model and its autograd graph go before the next job's
        # (their cycles would keep them): ranks that share a card would
        # hold every job's at once
        gc.collect()
    return out

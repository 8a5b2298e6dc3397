"""Sharded steps in a local world of processes: the train step and the
forward of a model distributed over a ``DeviceMesh``
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

The world programs, ``train_world``, ``forward_world`` and
``infer_world`` (the prox and prefill steps), take a job
dict and return plain data (numpy arrays and numbers): the parameters
after the steps or the logits, on rank 0; on every rank the kernels'
launches (``ops.LAUNCHES``) and the local head counts the flash kernel
saw (``ops.LOCAL_HEADS``).  The job's weights are either a flat dict of
the reference's tree (``models/convert.py::params_from_jax``) or a seed
for ``LM.init``, the same on every rank.  A job's mesh spans the world's
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
    specs = sharding.make_param_specs(cfg, mesh, model, fsdp=job.get("fsdp", True))
    sharding.distribute_model(model, dm, specs)
    return model, dm


def _report() -> Dict[str, Any]:
    from repro_torch.kernels import ops
    return {"launches": {k: v for k, v in ops.LAUNCHES.items() if v},
            "local_heads": sorted(ops.LOCAL_HEADS)}


def train_world(rank: int, n: int, job) -> Dict[str, Any]:
    """``job["steps"]`` train steps (``launch/steps.py``) of the job's
    model on its mesh from one batch; returns each step's metrics and wall
    ms (a wait for the step's last kernel closes each on the card), the
    seconds of the set-up and of the rest, and on rank 0 the parameters
    after the steps by name."""
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
    for _ in range(job.get("steps", 1)):
        t0 = time.perf_counter()
        met = step(opt, batch)
        if device == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in met.items()})
    out = {"rank": rank, "metrics": metrics, "ms": ms, **_report()}
    full = {name: p.full_tensor().detach() for name, p in model.named_parameters()}
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


PROGRAMS = {"train": train_world, "forward": forward_world, "infer": infer_world}


def jobs_world(rank: int, n: int, jobs) -> List[Dict[str, Any]]:
    """``PROGRAMS[name](rank, n, job)`` for each (name, job) of ``jobs``,
    in order, each with its launch counts from 0 (``IDLE`` where the rank
    is outside the job's mesh)."""
    return [PROGRAMS[name](rank, n, job) for name, job in jobs]

"""Disaggregated generation/training placement, after
``repro/launch/disaggregated.py``.

The paper decouples rollout and trainer workers onto disjoint GPU pools
(Sec 4, Sec 7.1: 75/25 inference/training).  Here the pool is the CUDA
devices of one host: ``split_devices`` gives the rollout engine and the
trainer their own lists, ``push_weights`` copies a published state dict
onto the rollout device (the analogue of AReaL's parameter push over
NVLink), and trajectories flow rollout -> trainer on the host (the
replay buffer is host memory, as in the paper).  With one card both
roles share it, each thread on its own CUDA stream
(``core/runtime.py``).

``host_weights`` (kept in ``core/weights.py`` beside the codecs that
own its format) and ``stream_weights`` are the host-side forms of a
publication: a state dict as numpy arrays, and its chunked delta stream.

The reference's mesh forms run on the ranks of a process group, one
program on every rank: ``split_meshes`` lays a ("data", "model")
``DeviceMesh`` for rollout over the first ranks and one for the trainer
over the rest, and ``push_weights`` given a rollout ``DeviceMesh`` puts
the trainer's DTensors onto it by the rollout's partition specs.  DTensor
cannot redistribute between two meshes, so the transfer is its own: each
rollout rank receives, point to point, exactly the parts of the trainer's
shards that overlap its own shard (``push_plan``), bit for bit; a tensor
the rollout spec replicates reaches each rollout rank whole, from the
trainer's shards, and no broadcast is used.  Where gloo carries CUDA
tensors between ranks that share one card, each block is staged through
host memory, as ``dist/host_staged.py`` stages the collectives.  ``demo``
is the reference's: split the world in two, initialise on the trainer
mesh, push, and prefill and decode on the rollout mesh.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.weights import encode_stream, host_weights

__all__ = ["demo", "host_weights", "push_plan", "push_weights", "split_devices",
           "split_meshes", "split_sizes", "stream_weights"]


def split_devices(train_fraction: float = 0.25,
                  devices: Optional[Sequence] = None) -> Tuple[List[torch.device],
                                                               List[torch.device]]:
    """Partition the device pool into (rollout devices, trainer devices):
    the first ``n - n_train`` for rollout, the rest for the trainer, with
    ``n_train = max(1, round(n * train_fraction))``.  ``devices``
    defaults to every visible CUDA device; a pure function of that list."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    n_train = max(1, int(round(n * train_fraction)))
    n_roll = n - n_train
    if n_roll <= 0:
        raise ValueError(f"a pool of {n} device(s) is too small to split at "
                         f"train_fraction={train_fraction}")
    return devices[:n_roll], devices[n_roll:]


def stream_weights(weights, *, version: int, base=None, base_version=None,
                   encoding: str = "delta", chunk_elems: int = 65536):
    """Streaming form of the trainer→rollout publication (DESIGN.md
    §Streaming weight publication, §Chunk framing): device→host copy of
    the state dict plus delta encoding against ``base`` — the previous
    published HOST tree — framed as a ``WeightStream`` of chunk
    messages.  Returns ``(host_tree, stream)``; the caller keeps
    ``host_tree`` as the next publication's base and ships the stream's
    messages to the rollout side (``ThreadedRuntime``'s queue).  With
    ``base=None`` (first publication) the stream falls back to
    base-free ``full`` chunks."""
    host = host_weights(weights)
    stream = encode_stream(host, version=version, base=base, base_version=base_version,
                           encoding=encoding, chunk_elems=chunk_elems)
    return host, stream


def push_weights(weights, target, specs=None, *, report: Optional[Dict] = None):
    """Trainer -> rollout weight publication.  ``target`` a device: a copy
    of the state dict (or an ``LM``'s) on that rollout card, made on the
    calling (trainer) thread, off the generation path; used only when the
    engine and the trainer are on different cards.  ``target`` a rollout
    ``DeviceMesh``: ``push_to_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(target, DeviceMesh):
        return push_to_mesh(weights, target, specs, report=report)
    if isinstance(weights, torch.nn.Module):
        weights = weights.state_dict()
    device = torch.device(target)
    with torch.no_grad():
        return {name: t.detach().to(device, copy=True) for name, t in weights.items()}


# ---------------------------------------------------------------------------
# the mesh forms: every rank of the process group runs them
# ---------------------------------------------------------------------------

def split_sizes(n: int, train_fraction: float = 0.25, model_parallel: int = 1) -> Tuple[int, int]:
    """(rollout ranks, trainer ranks) of a pool of ``n``, the reference's
    arithmetic: ``n_train = max(mp, round(n * f))``, then each side rounded
    down to a multiple of ``mp``; rollout takes the first ranks."""
    mp = model_parallel
    n_train = max(mp, int(round(n * train_fraction)))
    n_train -= n_train % mp
    n_roll = n - n_train
    n_roll -= n_roll % mp
    if n_roll <= 0 or n_train <= 0:
        raise ValueError(f"a pool of {n} rank(s) is too small for the split "
                         f"(train_fraction={train_fraction}, model_parallel={mp})")
    return n_roll, n_train


def split_meshes(train_fraction: float = 0.25, *, model_parallel: int = 1,
                 device_type: str = "cuda"):
    """(rollout ``DeviceMesh``, trainer ``DeviceMesh``), each ("data",
    "model") with ``model_parallel`` on "model", over the ranks of the
    default process group by ``split_sizes``: rollout on ranks [0,
    n_roll), the trainer on the next n_train.  Every rank calls it (each
    mesh makes its process groups); a rank outside a mesh gets one whose
    ``get_coordinate()`` is None."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n_roll, n_train = split_sizes(dist.get_world_size(), train_fraction, model_parallel)
    mk = lambda lo, k: DeviceMesh(device_type, torch.arange(lo, lo + k).reshape(      # noqa: E731
        k // model_parallel, model_parallel), mesh_dim_names=("data", "model"))
    return mk(0, n_roll), mk(n_roll, n_train)


Region = Tuple[Tuple[int, int], ...]        # [lo, hi) along each dim


def shard_regions(shape: Sequence[int], mesh: np.ndarray, placements) -> Dict[int, Region]:
    """Each rank's region of a tensor of ``shape`` laid out by
    ``placements`` on a mesh of ranks (an array, one axis a mesh dim):
    ``Shard(d)`` splits dim d as ``torch.chunk`` does, the mesh dims in
    order (DTensor's layout); ``Replicate`` keeps it whole."""
    from torch.distributed.tensor import Replicate, Shard
    out = {}
    for coord in itertools.product(*(range(k) for k in mesh.shape)):
        region = [(0, n) for n in shape]
        for i, pl in enumerate(placements):
            if isinstance(pl, Shard):
                lo, hi = region[pl.dim]
                step = -(-(hi - lo) // mesh.shape[i])
                a = min(lo + coord[i] * step, hi)
                region[pl.dim] = (a, min(a + step, hi))
            elif not isinstance(pl, Replicate):
                raise ValueError(f"a weight laid out as {pl} cannot be pushed")
        out[int(mesh[coord])] = tuple(region)
    return out


def _overlap(a: Region, b: Region) -> Optional[Region]:
    r = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return r if all(lo < hi for lo, hi in r) else None


def push_plan(shape: Sequence[int], src_mesh: np.ndarray, src_placements,
              dst_mesh: np.ndarray, dst_placements) -> List[Tuple[int, int, Region]]:
    """The blocks of a push: (source rank, destination rank, region of
    the whole tensor), in one order every rank computes alike.  Each
    destination rank's region is covered once: by every distinct source
    region that overlaps it, each sent by one of the source ranks that
    hold it (the destination's index among its peers picks which, so the
    replicas share the sending)."""
    held: Dict[Region, List[int]] = {}
    for rank, region in shard_regions(shape, src_mesh, src_placements).items():
        held.setdefault(region, []).append(rank)
    blocks = []
    for j, (dst, want) in enumerate(shard_regions(shape, dst_mesh, dst_placements).items()):
        if any(lo == hi for lo, hi in want):
            continue
        for region, ranks in held.items():
            part = _overlap(region, want)
            if part is not None:
                blocks.append((ranks[j % len(ranks)], dst, part))
    return blocks


def _ranks(dm) -> np.ndarray:
    return dm.mesh.cpu().numpy()


def push_to_mesh(weights, rollout_mesh, specs=None, *, report: Optional[Dict] = None):
    """The trainer's DTensors (a dict by name, or a model's parameters) on
    the rollout ``DeviceMesh``: each laid out by ``specs[name]`` (the
    rollout mesh's partition specs, ``dist.sharding.make_param_specs``),
    or replicated where ``specs`` is None, as the reference's
    ``device_put``.  Every rank of the group calls it with the same names
    and global tensors (a rank outside the trainer mesh holds their
    metadata only); each trainer rank sends the ``push_plan`` blocks it
    owns and each rollout rank receives its own.  Returns, on a rollout
    rank, {name: DTensor on ``rollout_mesh``}, on any other rank {}.
    ``report`` gets this rank's ``bytes_received`` and ``bytes_sent``
    and the names whose rollout spec replicates them (``replicated``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.constraints import placements as spec_placements
    from repro_torch.launch.mesh import mesh_of

    if isinstance(weights, torch.nn.Module):
        weights = dict(weights.named_parameters())
    rank = dist.get_rank()
    dst_ranks = _ranks(rollout_mesh)
    mesh = mesh_of(rollout_mesh)
    member = rollout_mesh.get_coordinate() is not None
    stats = {"bytes_received": 0, "bytes_sent": 0, "replicated": []}
    out = {}
    with torch.no_grad():
        for name, w in weights.items():
            if not isinstance(w, DTensor):
                raise TypeError(f"{name}: push_to_mesh takes the trainer's DTensors")
            want = ([Replicate()] * rollout_mesh.ndim if specs is None
                    else spec_placements(specs[name], mesh))
            if all(isinstance(p, Replicate) for p in want):
                stats["replicated"].append(name)
            shape = tuple(w.shape)
            blocks = push_plan(shape, _ranks(w.device_mesh), w.placements, dst_ranks, want)
            mine = shard_regions(shape, dst_ranks, want).get(rank)
            src_local = w.to_local()
            local = None
            if member:
                local = torch.empty([hi - lo for lo, hi in mine], dtype=w.dtype,
                                    device=src_local.device)
            src_region = (shard_regions(shape, _ranks(w.device_mesh), w.placements).get(rank)
                          if w.device_mesh.get_coordinate() is not None else None)
            for src, dst, part in blocks:
                if rank == src:
                    block = src_local[_index(part, src_region)].contiguous()
                    stats["bytes_sent"] += _send(block, dst)
                if rank == dst:
                    stats["bytes_received"] += _recv_into(local[_index(part, mine)], src)
            if member:
                out[name] = DTensor.from_local(local, rollout_mesh, want, run_check=False,
                                               shape=w.shape, stride=w.stride())
    if report is not None:
        report.update(stats)
    return out


def _index(part: Region, region: Region):
    """The slices of ``part`` within a shard that holds ``region``."""
    return tuple(slice(a - lo, b - lo) for (a, b), (lo, _) in zip(part, region))


def _staged(x: torch.Tensor) -> bool:
    """gloo carries CUDA tensors point to point only through the host."""
    import torch.distributed as dist
    return x.device.type != "cpu" and dist.get_backend() == "gloo"


def _send(block: torch.Tensor, dst: int) -> int:
    import torch.distributed as dist
    dist.send(block.cpu() if _staged(block) else block, dst)
    return block.numel() * block.element_size()


def _recv_into(view: torch.Tensor, src: int) -> int:
    import torch.distributed as dist
    buf = torch.empty(view.shape, dtype=view.dtype,
                      device="cpu" if _staged(view) else view.device)
    dist.recv(buf, src)
    view.copy_(buf)
    return buf.numel() * buf.element_size()


def demo(n_steps: int = 3, *, world: int = 4, device="cuda", cfg=None,
         timeout: float = 300.0) -> List:
    """The reference's ``demo`` on a world of ``world`` local processes
    (``launch/sharded.py::run_world``; on the card every rank shares it):
    split 50/50 with model parallel 2, initialise a model on the trainer
    mesh, then ``n_steps`` times push it to the rollout mesh, prefill 4
    prompts of 8 tokens there and decode one step, printing on each
    whether the logits are finite.  ``cfg`` defaults to areal-qwen-1.5b
    reduced.  Returns each rank's result of ``sharded.push_world``."""
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.device import resolve
    from repro_torch.launch import sharded
    cfg = cfg or reduced(get_model_config("areal-qwen-1.5b"))
    job = dict(cfg=cfg, seed=0, device=resolve(device).type, train_fraction=0.5,
               model_parallel=2,
               prompts=np.zeros((4, 8), np.int32), length=np.full((4,), 8, np.int32),
               max_len=32, decode_steps=1, pushes=n_steps)
    ranks = sharded.run_world(sharded.push_world, world, job, timeout=timeout)
    for step, finite in enumerate(ranks[0]["finite"]):
        print(f"step {step}: decode on rollout mesh ok, logits finite={finite}")
    return ranks


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the cross-mesh weight push and a decode on "
                                             "the rollout mesh, on a local world of 4")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    demo(device=ap.parse_args().device)

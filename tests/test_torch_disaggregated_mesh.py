"""The mesh forms of the disaggregated placement
(``repro_torch/launch/disaggregated.py``) against the reference's
``repro/launch/disaggregated.py``.

  * ``split_sizes`` (``split_meshes``' arithmetic) gives the reference's
    ``split_devices`` split for pools of 2, 4 and 8 at train fractions 0.25
    and 0.5 and model parallel 1 and 2, and refuses where it asserts (the
    reference runs in a subprocess that fakes 8 host devices, as its own
    test does).
  * ``push_plan`` covers every destination shard exactly once, from
    source ranks that hold what they send, the replicas sharing the
    sending.
  * In a gloo world of 4 (``slow``, its own timeout): ``split_meshes(0.5)``
    gives a rollout mesh on ranks 0-1 and a trainer mesh on 2-3; every
    rollout rank's pushed shards equal DTensor's own slice of the
    one-process weights bit for bit, the bytes it received are its shards'
    bytes and the trainer's ranks sent them all; the demo's prefill and
    decode on the rollout mesh give the one-process greedy tokens and f32
    logits within 2e-5.  Model parallel 2 (tensor-parallel shards on both
    sides) and 1 (FSDP shards on the trainer's data axis, whole tensors on
    each rollout replica).
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import get_model_config, reduced
from repro_torch.launch import disaggregated, sharded
from repro_torch.models.model import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = list(itertools.product((2, 4, 8), (0.25, 0.5), (1, 2)))
LOGIT_TOL = 2e-5


def test_split_sizes_match_the_references_split_devices():
    code = textwrap.dedent("""
        import json, jax
        from repro.launch.disaggregated import split_devices
        out = {}
        for n, f, mp in %r:
            try:
                roll, train = split_devices(f, model_parallel=mp, devices=jax.devices()[:n])
                out[f"{n},{f},{mp}"] = [roll.devices.size, train.devices.size,
                                        [d.id for d in roll.devices.flat],
                                        [d.id for d in train.devices.flat]]
            except AssertionError:
                out[f"{n},{f},{mp}"] = None
        print(json.dumps(out))
    """ % (CASES,))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    assert any(v is None for v in want.values())
    for n, f, mp in CASES:
        ref = want[f"{n},{f},{mp}"]
        if ref is None:
            with pytest.raises(ValueError, match="too small"):
                disaggregated.split_sizes(n, f, mp)
            continue
        n_roll, n_train = disaggregated.split_sizes(n, f, mp)
        assert [n_roll, n_train] == ref[:2], (n, f, mp)
        # rollout takes the first devices, the trainer the next
        assert ref[2] == list(range(n_roll)) and ref[3] == list(range(n_roll, n_roll + n_train))


PLANS = [
    # (shape, source mesh, source placements, destination mesh, destination placements)
    ((10, 6), (1, 2), (Replicate(), Shard(1)), (1, 2), (Replicate(), Shard(1))),
    ((10, 6), (2, 1), (Shard(0), Replicate()), (1, 2), (Replicate(), Shard(1))),
    ((7, 5), (2, 2), (Shard(0), Shard(1)), (3, 1), (Shard(0), Replicate())),
    ((8,), (1, 2), (Replicate(), Replicate()), (2, 2), (Replicate(), Replicate())),
    ((9, 4), (2, 2), (Shard(0), Shard(0)), (1, 2), (Replicate(), Shard(0))),
]


@pytest.mark.parametrize("shape,src,src_pl,dst,dst_pl", PLANS)
def test_the_push_plan_covers_each_shard_once(shape, src, src_pl, dst, dst_pl):
    n_src = int(np.prod(src))
    src_mesh = np.arange(n_src).reshape(src)
    dst_mesh = np.arange(n_src, n_src + int(np.prod(dst))).reshape(dst)
    src_regions = disaggregated.shard_regions(shape, src_mesh, src_pl)
    blocks = disaggregated.push_plan(shape, src_mesh, src_pl, dst_mesh, dst_pl)
    for dst_rank, want in disaggregated.shard_regions(shape, dst_mesh, dst_pl).items():
        cover = np.zeros(shape, np.int32)
        for s, d, part in blocks:
            if d != dst_rank:
                continue
            held = src_regions[s]
            assert all(lo >= a and hi <= b for (lo, hi), (a, b) in zip(part, held)), (s, part)
            cover[tuple(slice(lo, hi) for lo, hi in part)] += 1
        inside = tuple(slice(lo, hi) for lo, hi in want)
        assert (cover[inside] == 1).all() and cover.sum() == cover[inside].sum(), dst_rank
    # a tensor every source rank holds whole is sent by all of them in turn
    if len(set(src_regions.values())) == 1 and dst_mesh.size >= len(src_regions):
        assert {s for s, _, _ in blocks} == set(src_regions)


@pytest.mark.slow
def test_the_push_and_the_demo_on_a_world_of_four():
    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), vocab_size=512)
    rng = np.random.default_rng(0)
    base = dict(cfg=cfg, seed=3, device="cpu", train_fraction=0.5,
                prompts=rng.integers(3, cfg.vocab_size, (4, 12)).astype(np.int32),
                length=np.array([12, 9, 7, 12], np.int32), max_len=16, decode_steps=3,
                pushes=2)
    jobs = [("push", dict(base, model_parallel=mp)) for mp in (2, 1)]
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(base["seed"]))
    with torch.no_grad():
        want, want_tokens = sharded.rollout_program(model, base)
    ranks = sharded.run_world(sharded.jobs_world, 4, jobs, timeout=300)
    for j, (_, job) in enumerate(jobs):
        got = [r[j] for r in ranks]
        assert [r["role"] for r in got] == ["rollout", "rollout", "trainer", "trainer"]
        sent = sum(sum(r["bytes_sent"]) for r in got)
        for r in got[:2]:
            assert r["shards_equal"], (job["model_parallel"], r["rank"])
            assert r["bytes_received"] == [r["shard_bytes"]] * job["pushes"]
            assert r["tokens"] == want_tokens and all(r["finite"])
        assert sent == sum(sum(r["bytes_received"]) for r in got)
        assert all(r["bytes_received"] == [0] * job["pushes"] for r in got[2:])
        assert all(sum(r["bytes_sent"]) > 0 for r in got[2:]), "both trainer ranks send"
        for k, v in want.items():
            assert np.abs(got[0]["logits"][k] - v.numpy()).max() <= LOGIT_TOL, k

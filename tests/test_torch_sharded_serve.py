"""The sharded serving steps (``launch/steps.py``'s ``serve_step``,
``paged_serve_step``, ``fused_serve_step`` and
``paged_prefill_chunk_step`` on a ``DeviceMesh``) against the live JAX
reference and the port's one-process steps, in f32 from one init
(``params_from_jax``).  Every case runs ``launch/sharded.py::
serve_program`` (prefill, 8 ring decode steps, the prompts into a pool
through the chunk step, 4 paged and 4 fused steps, one span continuing
slot 1, each step fed the greedy tokens of the one before) in one world
of 4 gloo processes on the CPU (each case's mesh spans the world's first
ranks; one spawn, with its own timeout); the parent runs the same steps
through ``repro.launch.steps`` and through the port in one process.

Cases: the reduced dense config on (1, 2), on (2, 2) with FSDP (the
slots split over data, the pool whole on every data replica), and with
6/2 heads on (1, 3), where the middle model shard's q heads straddle the
two kv heads (the kernels read each kv head's slice of the cache in
place); reduced olmoe-1b-7b on (2, 2) at capacity factor 8 (the fused
tail with ``mean_empty_rows``); the reduced RG-LRU hybrid on (1, 2) (the
conv step and the recurrence on each rank's rows, the state whole on
"model").  Held: each step's logits within 2e-4 of the reference's and of
one process's; the greedy tokens equal; every data replica's local pool
bit-equal to the others'; the (q heads, kv heads) each decode-side
kernel saw on each rank.

The conv repair: the hybrid's sharded train step and serving program,
watched by ``launch/sharded.py::DTensorOpWatch`` (a dispatch mode that
sees each op with a DTensor argument before DTensor's own dispatch), ask
DTensor to plan no ``aten.constant_pad_nd`` anywhere and no op at all
inside ``layers.causal_conv1d_apply`` / ``causal_conv1d_step``."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.launch import steps as jsteps
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.launch import sharded
from repro_torch.models.convert import params_from_jax

pytestmark = pytest.mark.slow

DENSE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab_size=512)
LOGIT_TOL = 2e-4
WORLD, WORLD_TIMEOUT = 4, 240
PAD = "aten.constant_pad_nd.default"


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def _configs(name):
    """(the reference's config, the port's) of a case's model."""
    if name == "moe":
        kw = dict(moe_capacity_factor=8.0)
        return (dataclasses.replace(jax_reduced(jax_config("olmoe-1b-7b")), **kw),
                dataclasses.replace(reduced(get_model_config("olmoe-1b-7b")), **kw))
    if name == "hybrid":
        kw = dict(vocab_size=512)
        return (dataclasses.replace(jax_reduced(jax_config("recurrentgemma-9b")), **kw),
                dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")), **kw))
    kw = {**DENSE, **(dict(n_heads=6, n_kv_heads=2, d_model=48) if name == "straddle" else {})}
    return JaxModelConfig(**kw), ModelConfig(**kw)


# (id, model, mesh, fsdp)
CASES = [("dense-1x2", "dense", (1, 2), False),
         ("dense-2x2-fsdp", "dense", (2, 2), True),
         ("straddle-1x3", "straddle", (1, 3), True),
         ("moe-2x2", "moe", (2, 2), False),
         ("hybrid-1x2", "hybrid", (1, 2), True)]
IDS = [c[0] for c in CASES]
_WORLD = None


def serve_job(tcfg, weights, mesh, fsdp, seed):
    rng = np.random.default_rng(seed)
    b, s = 4, 10
    return dict(cfg=tcfg, weights=weights, mesh=mesh, fsdp=fsdp,
                prompts=rng.integers(3, tcfg.vocab_size, (b, s)).astype(np.int32),
                length=np.array([10, 7, 9, 4], np.int32), steps=8, paged_steps=4,
                span=rng.integers(3, tcfg.vocab_size, (1, 5)).astype(np.int32), block_size=4,
                watch_dtensor_ops=True)


def jax_serve(jmodel, params, job):
    """``serve_program``'s sequence through ``repro.launch.steps``: (logits
    by step, greedy tokens)."""
    inp = sharded.serve_inputs(job)
    j = jnp.asarray
    logits, tokens = {}, []

    def keep(name, out):
        logits[name] = np.asarray(out, np.float32)
        tokens.append(logits[name].argmax(axis=-1).astype(np.int32))
        return j(tokens[-1])

    out, cache = jsteps.make_prefill_step(jmodel, inp["max_len"], jnp.float32)(
        params, {"tokens": j(inp["prompts"]), "length": j(inp["length"])})
    tok = keep("prefill", out)
    serve = jax.jit(jsteps.make_serve_step(jmodel))
    for i in range(inp["steps"]):
        out, cache = serve(params, tok, cache)
        tok = keep(f"ring.{i}", out)
    b = inp["prompts"].shape[0]
    pc = jmodel.init_paged_cache(b, inp["n_blocks"], inp["block_size"], jnp.float32)
    chunk = jax.jit(jsteps.make_paged_prefill_chunk_step(jmodel))
    out, pc = chunk(params, j(inp["prompts"]), pc, j(inp["tables"]), j(inp["dest"]),
                    j(np.arange(b, dtype=np.int32)), j(np.zeros(b, np.int32)), j(inp["length"]))
    tok = keep("chunk_prefill", out)
    for kind, fn in (("paged", jax.jit(jsteps.make_paged_serve_step(jmodel))),
                     ("fused", jax.jit(jsteps.make_fused_serve_step(jmodel)))):
        for i in range(inp["paged_steps"]):
            out, pc = fn(params, tok, pc, j(inp["tables"]))
            tok = keep(f"{kind}.{i}", out)
    span = inp["span"]
    start = np.asarray(pc["t"])[1:2].astype(np.int32)
    pos = int(start[0]) + np.arange(span.shape[1])
    dest = inp["tables"][1, pos // inp["block_size"]][None].astype(np.int32)
    out, pc = chunk(params, j(span), pc, j(inp["tables"][1:2]), j(dest),
                    j(np.ones(1, np.int32)), j(start), j(np.array([span.shape[1] - 1], np.int32)))
    keep("span", out)
    return logits, [t.tolist() for t in tokens]


def one_process(tcfg, weights, job):
    """``serve_program`` of the port in this process: (logits, tokens)."""
    model = params_from_jax(tcfg, weights, device="cpu")
    with torch.no_grad():
        logits, tokens, _ = sharded.serve_program(model, job)
    return {k: v.numpy() for k, v in logits.items()}, [t.tolist() for t in tokens]


def _hybrid_train_job():
    """The reduced hybrid's train step on (1, 2), watched for what DTensor
    is asked to plan."""
    _, tcfg = _configs("hybrid")
    rng = np.random.default_rng(0)
    b, s = 4, 16
    seg = np.repeat(np.array([[0] * 9 + [1] * 7]), b, 0).astype(np.int32)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32),
             "positions": np.tile(np.arange(s, dtype=np.int32)[None], (b, 1)),
             "segment_ids": seg, "advantages": rng.normal(size=(b, s)).astype(np.float32),
             "behav_logprob": (-rng.random((b, s))).astype(np.float32),
             "prox_logprob": (-rng.random((b, s))).astype(np.float32),
             "loss_mask": (rng.random((b, s)) < 0.5).astype(np.float32)}
    return dict(cfg=tcfg, seed=3, mesh=(1, 2), fsdp=True, rl=RLConfig(), batch=batch,
                watch_dtensor_ops=True)


def world():
    """{case id: (each rank's result, the reference's (logits, tokens),
    one process's)}, and the watched train step's ranks under "train",
    all from one world of 4 gloo processes, which runs while this process
    computes the references."""
    global _WORLD
    if _WORLD is None:
        jobs, pairs = [], []
        for i, (cid, name, mesh, fsdp) in enumerate(CASES):
            jcfg, tcfg = _configs(name)
            jmodel = jax_build_model(jcfg, remat=False)
            params = jmodel.init(jax.random.key(i))
            weights = flat_params(params)
            jobs.append(("serve", serve_job(tcfg, weights, mesh, fsdp, seed=10 + i)))
            pairs.append((jmodel, params, tcfg, weights))
        jobs.append(("train", _hybrid_train_job()))
        with ThreadPoolExecutor(1) as pool:
            running = pool.submit(sharded.run_world, sharded.jobs_world, WORLD, jobs,
                                  timeout=WORLD_TIMEOUT)
            refs = {cid: (jax_serve(jmodel, params, job), one_process(tcfg, weights, job))
                    for (cid, *_), (jmodel, params, tcfg, weights), (_, job)
                    in zip(CASES, pairs, jobs)}
            ranks = running.result()
        on = lambda j: [r[j] for r in ranks if r[j] is not sharded.IDLE]     # noqa: E731
        _WORLD = {cid: (on(j), *refs[cid]) for j, (cid, *_) in enumerate(CASES)}
        _WORLD["train"] = on(len(CASES))
    return _WORLD


def _close(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=LOGIT_TOL, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_serving_steps_match_the_reference(case):
    ranks, (jlogits, jtokens), _ = world()[case[0]]
    _close(ranks[0]["logits"], jlogits, "the reference")
    assert ranks[0]["tokens"] == jtokens


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_serving_steps_match_one_process(case):
    ranks, _, (logits, tokens) = world()[case[0]]
    _close(ranks[0]["logits"], logits, "one process")
    assert ranks[0]["tokens"] == tokens
    # 8 ring, 4 paged and 4 fused greedy steps after their prefills
    assert len(tokens) == 1 + 8 + 1 + 4 + 4 + 1


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_data_replica_holds_the_same_pool(case):
    """The pool is whole on the data axes: each data rank applies every
    slot's writes, so the replicas of one model shard are bit-equal (and
    differ across model shards, which hold different kv heads, where the
    kv heads split)."""
    ranks = world()[case[0]][0]
    by_shard = {}
    for r in ranks:
        by_shard.setdefault(r["coordinate"][1], set()).add(tuple(sorted(r["pool"].items())))
    assert all(len(d) == 1 for d in by_shard.values()), by_shard
    mesh = case[2]
    assert len(ranks) == mesh[0] * mesh[1]


# each rank's (q heads, kv heads) per call of every decode-side kernel
HEADS = {"dense-1x2": [[(2, 1)]] * 2, "dense-2x2-fsdp": [[(2, 1)]] * 4,
         # 6 q heads on 2 kv heads over 3 shards: the middle one straddles
         "straddle-1x3": [[(2, 1)], [(1, 1)], [(2, 1)]],
         "moe-2x2": [[(2, 2)]] * 4, "hybrid-1x2": [[(2, 1)]] * 2}
DECODE_KERNELS = ("decode_attention", "paged_decode_attention", "fused_decode_tail",
                  "paged_prefill_attention")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_kernels_run_on_each_ranks_local_heads(case):
    ranks = world()[case[0]][0]
    for r, want in zip(sorted(ranks, key=lambda r: r["rank"]), HEADS[case[0]]):
        for name in DECODE_KERNELS:
            assert r["kernel_heads"][name] == want, (r["rank"], name)


def test_the_conv_asks_dtensor_for_no_pad_in_the_train_step():
    """The hybrid's sharded train step: the conv runs on each rank's local
    rows and channels (``local_map``), so no DTensor rule of ``F.pad`` or
    ``torch.cat`` is asked for inside it (the card's DTensor has none for
    the pad), nor of ``F.pad`` anywhere in the step."""
    ranks = world()["train"]
    assert len(ranks) == 2
    for r in ranks:
        assert PAD not in r["dtensor_ops"]["step"], r["dtensor_ops"]["step"]
        assert r["dtensor_ops"]["conv"] == {}
        assert r["metrics"][0]["loss"] == r["metrics"][0]["loss"]       # finite, not NaN


def test_the_conv_step_asks_dtensor_for_nothing_in_the_serving_steps():
    ranks = world()["hybrid-1x2"][0]
    for r in ranks:
        assert PAD not in r["dtensor_ops"]["step"], r["dtensor_ops"]["step"]
        assert r["dtensor_ops"]["conv"] == {}

"""Sharded execution of the port (``dist/``, ``launch/sharded.py``) against
the live JAX reference, in f32 from one init (``params_from_jax``): the
cases run in one world of 4 gloo processes on the CPU
(``launch.sharded.run_world``, its own timeout; each case's mesh spans
the world's first ranks), the reference on one device.

The counterparts of ``tests/test_sharding.py``'s
``test_sharded_train_step_matches_single_device`` (the (2, 2) mesh with
FSDP; also at accum_steps 2, with 6/2 heads on (1, 3), where the middle
model shard's q heads straddle the two kv heads, and a world of one with
the mesh active) and ``test_moe_sharded_matches_single_device`` (reduced
olmoe-1b-7b, expert-parallel at capacity factor 8 on (2, 2)): every
parameter after one ``train_step`` within 2e-5 of the reference's and
the loss within 1e-5 relative; the MoE logits within 2e-4.  The prox
and prefill steps on (2, 2) equal the port's plain steps (which
``test_torch_steps.py`` holds against the reference) within 2e-4, and
the reduced RG-LRU hybrid's train step the plain step's within 2e-5.
Without a mesh the constraints return their inputs themselves."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RLConfig as JaxRLConfig
from repro.launch import steps as jsteps
from repro.models.model import build_model as jax_build_model
from repro_torch import optim
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.dist.constraints import constrain, constrain_qkv
from repro_torch.kernels.ops import head_runs
from repro_torch.launch import sharded, steps
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

pytestmark = pytest.mark.slow

DENSE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab_size=512)
B, S = 4, 16
PARAM_TOL, LOSS_RTOL, LOGIT_TOL = 2e-5, 1e-5, 2e-4
WORLD_TIMEOUT = 240


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def train_batch(vocab):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "positions": np.tile(np.arange(S, dtype=np.int32)[None], (B, 1)),
            "segment_ids": np.zeros((B, S), np.int32),
            "advantages": rng.normal(size=(B, S)).astype(np.float32),
            "behav_logprob": (-rng.random((B, S))).astype(np.float32),
            "prox_logprob": (-rng.random((B, S))).astype(np.float32),
            "loss_mask": (rng.random((B, S)) < 0.5).astype(np.float32)}


# (id, mesh, fsdp, accum_steps, config overrides)
TRAIN_CASES = [
    ("fsdp-2x2", (2, 2), True, 1, {}),
    # from this case on, the (2, 2) world's gathers, reduce-scatters and
    # all-to-alls run staged through the host (dist/host_staged.py)
    ("fsdp-2x2-accum2", (2, 2), True, 2, {}),
    ("straddle-1x3", (1, 3), True, 1, dict(n_heads=6, n_kv_heads=2, d_model=48)),
    ("world-1", (1, 1), True, 1, {}),
]
MOE_MESH = (2, 2)
WORLD = 4                         # ranks; every case's mesh spans the first of them
_WORLD = None


def _train_job(case):
    """(the job, the reference's parameters and metrics after one step)."""
    _, mesh, fsdp, accum, over = case
    kw = {**DENSE, **over}
    jmodel = jax_build_model(JaxModelConfig(**kw), remat=False)
    params = jmodel.init(jax.random.key(0))
    batch = train_batch(kw["vocab_size"])
    jstep = jsteps.make_train_step(jmodel, JaxRLConfig(), accum_steps=accum)
    jparams, _, jmet = jax.jit(jstep)(params, joptim.init_state(params),
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    job = dict(cfg=ModelConfig(**kw), weights=flat_params(params), mesh=mesh, fsdp=fsdp,
               accum=accum, rl=RLConfig(), batch=batch, host_staged=case[0] == "fsdp-2x2-accum2")
    return job, (flat_params(jparams), float(jmet["loss"]))


def _moe_job():
    cfg_kw = dict(moe_capacity_factor=8.0)
    jcfg = dataclasses.replace(jax_reduced(jax_config("olmoe-1b-7b")), **cfg_kw)
    tcfg = dataclasses.replace(reduced(get_model_config("olmoe-1b-7b")), **cfg_kw)
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(0))
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    want, _ = jax.jit(jmodel.forward)(params, jnp.asarray(toks))
    job = dict(cfg=tcfg, weights=flat_params(params), mesh=MOE_MESH, fsdp=False, tokens=toks)
    return job, np.asarray(want)


INFER_STEPS = ("prox", "prefill")
PREFILL_LEN = 24


def _infer_job(step):
    """The prox or prefill step of the dense config on (2, 2) with FSDP,
    and its one-process result (the port's plain step, which
    ``test_torch_steps.py`` holds against the reference): right-padded
    prompts for the prefill."""
    kw = dict(DENSE)
    params = jax_build_model(JaxModelConfig(**kw), remat=False).init(jax.random.key(1))
    weights = flat_params(params)
    batch = train_batch(kw["vocab_size"])
    if step == "prefill":
        batch = {"tokens": batch["tokens"], "length": np.array([16, 9, 12, 5], np.int32)}
    model = params_from_jax(ModelConfig(**kw), weights, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if step == "prox":
        want = {"logprobs": steps.make_prox_logprob_step(model)(tb)}
    else:
        logits, cache = steps.make_prefill_step(model, PREFILL_LEN, torch.float32)(tb)
        want = {"logits": logits, **{f"cache.{k}": v for k, v in cache.items()}}
    job = dict(cfg=ModelConfig(**kw), weights=weights, mesh=MOE_MESH, fsdp=True, batch=batch,
               step=step, max_len=PREFILL_LEN)
    return job, {k: v.float().numpy() for k, v in want.items()}


def _hybrid_job():
    """One train step of the reduced recurrentgemma-9b on (2, 2) with FSDP
    (the RG-LRU's conv, gates and scan on DTensors, the scan on each
    rank's rows), and the port's plain step's parameters after it
    (``test_torch_hybrid_train.py`` holds that step against the
    reference)."""
    cfg = dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")), vocab_size=512)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(3))
    batch = train_batch(cfg.vocab_size)
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = steps.make_train_step(model, RLConfig())
    loss = float(step(optim.init_state(list(model.parameters())),
                      {k: torch.from_numpy(v) for k, v in batch.items()})["loss"])
    job = dict(cfg=cfg, seed=3, mesh=MOE_MESH, fsdp=True, rl=RLConfig(), batch=batch)
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert any((weights[n] - p).abs().max() > 0 for n, p in model.named_parameters())
    return job, (want, loss)


def world():
    """{case id: (each rank's result on the case's mesh, the reference's)}
    of every case, all run in one world of 4 gloo processes (each mesh
    spans its first ranks; one spawn, with its own timeout)."""
    global _WORLD
    if _WORLD is None:
        ids, jobs, refs = [], [], []
        for case in TRAIN_CASES:
            job, ref = _train_job(case)
            ids.append(case[0]), jobs.append(("train", job)), refs.append(ref)
        job, ref = _moe_job()
        ids.append("moe"), jobs.append(("forward", job)), refs.append(ref)
        for step in INFER_STEPS:
            job, ref = _infer_job(step)
            ids.append(step), jobs.append(("infer", job)), refs.append(ref)
        job, ref = _hybrid_job()
        ids.append("hybrid"), jobs.append(("train", job)), refs.append(ref)
        ranks = sharded.run_world(sharded.jobs_world, WORLD, jobs, timeout=WORLD_TIMEOUT)
        _WORLD = {i: ([r[j] for r in ranks if r[j] is not sharded.IDLE], refs[j])
                  for j, i in enumerate(ids)}
    return _WORLD


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_sharded_train_step_matches_the_reference(case):
    name, mesh, _, accum, over = case
    tcfg = ModelConfig(**{**DENSE, **over})
    ranks, (jparams, jloss) = world()[name]
    want = params_from_jax(tcfg, jparams, device="cpu")
    got = ranks[0]["params"]
    for pname, w in want.named_parameters():
        np.testing.assert_allclose(got[pname], w.detach().numpy(), rtol=0, atol=PARAM_TOL,
                                   err_msg=pname)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"][0]["loss"], jloss, rtol=LOSS_RTOL)
    if mesh == (1, 3):
        # q heads [2, 4) of the middle shard use kv heads 0 and 1: two calls
        assert ranks[1]["local_heads"] == [(1, 1)]
        assert ranks[0]["local_heads"] == ranks[2]["local_heads"] == [(2, 1)]
    if mesh == (1, 1):
        # the mesh active on one rank: the plain step's numbers
        job, _ = _train_job(case)
        model = params_from_jax(tcfg, job["weights"], device="cpu")
        step = steps.make_train_step(model, RLConfig(), accum_steps=accum)
        met = step(optim.init_state(list(model.parameters())),
                   {k: torch.from_numpy(v) for k, v in job["batch"].items()})
        assert ranks[0]["metrics"][0]["loss"] == float(met["loss"])
        for pname, p in model.named_parameters():
            np.testing.assert_array_equal(got[pname], p.detach().numpy(), err_msg=pname)


def test_moe_sharded_forward_matches_the_reference():
    ranks, want = world()["moe"]
    got = ranks[0]["logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("step", INFER_STEPS)
def test_sharded_prox_and_prefill_match_the_plain_steps(step):
    """On (2, 2) with FSDP: the prox step's logprobs, and the prefill
    step's last logits and every ring-cache entry (each rank writes its own
    rows and kv heads), equal the plain steps' within float error."""
    ranks, want = world()[step]
    got = ranks[0]["outputs"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=LOGIT_TOL if k != "cache.pos" else 0,
                                   err_msg=k)


def test_sharded_hybrid_train_step_matches_the_plain_step():
    ranks, (want, loss) = world()["hybrid"]
    got = ranks[0]["params"]
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=PARAM_TOL, err_msg=name)
    np.testing.assert_allclose(ranks[0]["metrics"][0]["loss"], loss, rtol=LOSS_RTOL)


def test_constraints_are_exact_no_ops_without_a_mesh():
    x, q, k, v = (torch.randn(4, 8, 2, 4) for _ in range(4))
    assert constrain(x, "dp", None, "model", None) is x
    out = constrain_qkv(q, k, v)
    assert out[0] is q and out[1] is k and out[2] is v


@pytest.mark.parametrize("h0,n,group,want", [
    (0, 6, 6, [(0, 6, 0, 1)]),                   # areal-qwen-1.5b, 12/2 on model 2
    (3, 3, 6, [(0, 3, 0, 1)]),                   # 12/2 on model 4: 3 q heads, one kv head
    (2, 2, 3, [(0, 1, 0, 1), (1, 2, 1, 2)]),     # 6/2 on model 3, the middle shard
    (0, 8, 2, [(0, 8, 0, 4)]),                   # whole groups in one call
    (1, 6, 2, [(0, 1, 0, 1), (1, 5, 1, 3), (5, 6, 3, 4)]),
])
def test_head_runs_split_only_at_kv_boundaries(h0, n, group, want):
    runs = head_runs(h0, n, group)
    assert runs == want
    assert sum(b - a for a, b, _, _ in runs) == n
    for a, b, c, d in runs:
        assert (b - a) % (d - c) == 0 and all((h0 + j) // group in range(c, d)
                                              for j in range(a, b))

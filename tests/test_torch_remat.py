"""Rematerialisation in the port (``build_model(remat=, remat_policy=)``,
``models/layers.py::checkpointed``) against the plain step and the live
JAX reference built with ``remat=True``, on reduced configs in f32.

  * For each family (dense, RG-LRU hybrid, MoE, enc-dec, xLSTM, whose
    chunkwise mLSTM checkpoints its chunk bodies), one ``train_step``
    under remat "none" and "dots" equals the step without remat: loss and
    grad norm within 1e-6 relative, parameters within 1e-6;
  * and matches the reference's ``train_step`` of the same init built
    with ``remat=True`` under ``None`` / ``dots_with_no_batch_dims_saveable``
    (metrics 1e-5 relative, parameters 1e-5, as ``test_torch_steps.py``);
  * under "dots" the backward dispatches no ``aten.mm`` / ``aten.addmm``
    beyond the plain step's (the recompute takes the saved products),
    under "none" the forward's again;
  * the dry run builds with remat: its temporaries fall against the
    plain model's, and its record's ``remat_policy`` and file name are the
    reference's (``repro/launch/dryrun.py``, its mesh name aside);
  * the port's aten FLOPs of the remat train step (forward and backward)
    equal the reference's compiled ``remat=True`` step by
    ``hlo_analysis`` within 1% outside attention, as
    ``test_torch_dryrun.py`` holds the forward: the jnp oracle's
    full-matrix attention products (4 B H S^2 hd a layer forward, 8 in the
    backward, 4 again in the recompute) taken out, the port's kernels'
    own records left out;
  * a gloo world of 2 runs the remat train step on (1, 2) equal to one
    process (``slow``, its own timeout);
  * FSDP under remat on (2, 2): the reference's compiled step (in a
    subprocess faking 4 devices) gathers more than without remat (its
    recompute gathers the weights again); the port's gathers the same
    (``steps._gathered`` holds a micro-batch's gathered weights for its
    recompute) and holds fewer temporaries (``slow``).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import RLConfig as JaxRLConfig
from repro.launch import dryrun as jdryrun
from repro.launch import hlo_analysis
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro_torch import optim
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import RLConfig, ShapeConfig
from repro_torch.launch import dryrun, op_analysis, sharded, steps
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

FAMILIES = {"dense": "areal-qwen-1.5b", "hybrid": "recurrentgemma-9b", "moe": "olmoe-1b-7b",
            "encdec": "whisper-medium", "xlstm": "xlstm-1.3b"}
# tokens a row: the xLSTM's above MLSTM_CHUNK_THRESHOLD, so its chunk
# bodies are checkpointed
TOKENS = {"xlstm": 520}
B, S = 2, 16
LR = 1e-3
SAME_TOL, REF_TOL = 1e-6, 1e-5
POLICIES = {"none": None, "dots": jax.checkpoint_policies.dots_with_no_batch_dims_saveable}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def train_batch(cfg, s, seed=0):
    """Two packed sequences a row, the second cut by a -1 tail in one
    row; the enc-dec family's frames as ``prefix_embeds``."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, s), np.int32)
    pos = np.zeros((B, s), np.int32)
    for r in range(B):
        cut = s // 2 - r
        seg[r, cut:] = 1
        pos[r] = np.concatenate([np.arange(cut), np.arange(s - cut)])
    seg[1, s - 3:] = -1
    behav = (-3 * rng.random((B, s))).astype(np.float32)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (B, s)).astype(np.int32),
             "positions": pos, "segment_ids": seg,
             "advantages": rng.standard_normal((B, s)).astype(np.float32),
             "behav_logprob": behav,
             "prox_logprob": (behav + 0.1 * rng.standard_normal((B, s))).astype(np.float32),
             "loss_mask": (rng.random((B, s)) < 0.6).astype(np.float32)}
    if cfg.is_encdec:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.prefix_dim)).astype(np.float32)
    return batch


def port_step(model, batch):
    """One ``train_step``: (metrics, the parameters after it)."""
    step = steps.make_train_step(model, RLConfig(lr=LR))
    met = step(optim.init_state(list(model.parameters())),
               {k: torch.from_numpy(v) for k, v in batch.items()})
    return ({k: float(v) for k, v in met.items()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def seeded(cfg, **remat):
    model = build_model(cfg, device="cpu", **remat)
    return model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_remat_step_equals_the_plain_step(family):
    cfg = reduced(get_model_config(FAMILIES[family]))
    batch = train_batch(cfg, TOKENS.get(family, S))
    base, base_params = port_step(seeded(cfg), batch)
    for policy in layers.REMAT_POLICIES:
        met, params = port_step(seeded(cfg, remat=True, remat_policy=policy), batch)
        for k in ("loss", "grad_norm"):
            assert abs(met[k] - base[k]) <= SAME_TOL * abs(base[k]), (policy, k, met[k], base[k])
        diff = max((params[n] - p).abs().max().item() for n, p in base_params.items())
        assert diff <= SAME_TOL, (policy, diff)


@pytest.mark.parametrize("family,policy", [(f, p) for f in FAMILIES for p in POLICIES])
def test_a_remat_step_matches_the_reference_built_with_remat(family, policy):
    kw = dict(vocab_size=256)
    jcfg = dataclasses.replace(jax_reduced(jax_config(FAMILIES[family])), **kw)
    tcfg = dataclasses.replace(reduced(get_model_config(FAMILIES[family])), **kw)
    jmodel = jax_build_model(jcfg, remat=True, remat_policy=POLICIES[policy])
    params = jmodel.init(jax.random.key(4))
    batch = train_batch(tcfg, S)
    # the reference's lru-cached sinusoidal table keeps the first trace's
    # value, a tracer once that trace ends: each compile starts it anew
    jlayers.sinusoidal_positions.cache_clear()
    jstep = jsteps.make_train_step(jmodel, JaxRLConfig(lr=LR))
    jparams, _, jmet = jax.jit(jstep)(params, joptim.init_state(params),
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_jax(tcfg, flat_params(params), device="cpu")
    model.remat, model.remat_policy = True, policy
    met, got = port_step(model, batch)
    for k in jmet:
        np.testing.assert_allclose(met[k], float(jmet[k]), rtol=REF_TOL, atol=1e-8, err_msg=k)
    want = params_from_jax(tcfg, flat_params(jparams), device="cpu")
    for name, w in want.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), w.detach().numpy(), rtol=0, atol=REF_TOL,
                                   err_msg=name)


class _Products(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the products with no batch dimension dispatched in its body."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in layers.SAVED_BY_DOTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_under_dots_the_recompute_dispatches_no_product(family):
    cfg = reduced(get_model_config(FAMILIES[family]))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg, S).items()}
    counts = {}
    for name, remat in (("plain", {}), ("none", dict(remat=True, remat_policy="none")),
                        ("dots", dict(remat=True, remat_policy="dots"))):
        model = seeded(cfg, **remat)
        for p in model.parameters():
            p.requires_grad_(True)
        with _Products() as fwd:
            loss = model(batch["tokens"], positions=batch["positions"],
                         segment_ids=batch["segment_ids"])[0].square().mean()
        with _Products() as bwd:
            loss.backward()
        counts[name] = (fwd.n, bwd.n)
    assert counts["dots"] == counts["plain"]
    assert counts["none"][1] > counts["plain"][1]


def test_the_dry_runs_temporaries_fall_with_remat():
    cfg = reduced(get_model_config("areal-qwen-1.5b"))
    shape = ShapeConfig("train_4k", seq_len=256, global_batch=4, kind="train")
    temp = {}
    for name, kw in (("plain", dict(remat=False)), ("none", {}),
                     ("dots", dict(remat_policy="dots"))):
        rec = dryrun.build_dryrun(cfg.name, "train_4k", cfg=cfg, shape=shape, accum_steps=2,
                                  trace_meshes=False, **kw)
        temp[name] = rec["meshes"]["1x1"]["memory"]["temp_bytes"]
    assert temp["none"] < temp["dots"] < temp["plain"], temp


class _NoMesh(Exception):
    pass


@pytest.mark.parametrize("policy", list(POLICIES))
def test_the_record_and_its_file_are_named_as_the_references(policy, tmp_path, monkeypatch):
    """The reference's ``main`` writes its record's file before its mesh
    is built (stopped here: the record then says FAILED); the port's
    record and file name match it, less the mesh's part of the name (one
    port record holds every mesh)."""
    def stop(**_):
        raise _NoMesh
    monkeypatch.setattr(jdryrun, "make_production_mesh", stop)
    assert jdryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--remat-policy", policy,
                         "--out", str(tmp_path / "ref")]) == 1
    (ref_file,) = (tmp_path / "ref").iterdir()
    cfg = reduced(get_model_config("olmo-1b"))
    rec = dryrun.build_dryrun("olmo-1b", "train_4k", cfg=cfg, remat_policy=policy,
                              shape=ShapeConfig("train_4k", seq_len=32, global_batch=4,
                                                kind="train"), accum_steps=2, meshes=["1x1"])
    args = dryrun.argparse.Namespace(vocab_parallel=False, remat_policy=policy, no_fsdp=False,
                                     fsdp_pods=False, paged_cache=False, fused_decode=False,
                                     extra="")
    assert dryrun.record_tag(rec, args) + ".json" == ref_file.name.replace("_16x16", "")
    assert rec["remat_policy"] == policy
    with pytest.raises(_NoMesh):
        jdryrun.build_dryrun("olmo-1b", "train_4k", remat_policy=policy)
    json.dumps(rec)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_remat_train_flops_outside_attention_match_the_reference(policy):
    """sum(logits^2) and its gradients, both sides built with remat."""
    kw = dict(vocab_size=512)
    cfg = dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")), **kw)
    tcfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), **kw)
    b, s = 2, 64
    jm = jax_build_model(cfg, remat=True, remat_policy=POLICIES[policy])
    params = jm.init(jax.random.key(0))
    grad = jax.grad(lambda p, t: jnp.sum(jm.forward(p, t)[0] ** 2))
    hlo = jax.jit(grad).lower(params, jnp.zeros((b, s), jnp.int32)).compile().as_text()
    ref_flops = hlo_analysis.analyze(hlo).flops
    # the jnp oracle's QK^T and PV: twice in the forward, its recompute
    # (a batched product: "dots" saves none) and, differentiated, 4 times
    attention = cfg.n_layers * (4 + 4 + 8) * b * cfg.n_heads * s * s * cfg.head_dim
    model = build_model(tcfg, remat=True, remat_policy=policy, device="meta")
    params_ = list(model.parameters())
    for p in params_:
        p.requires_grad_(True)
    _, tally = op_analysis.analyze(
        lambda t: torch.autograd.grad(model(t)[0].square().sum(), params_),
        torch.zeros((b, s), dtype=torch.int32, device="meta"))
    port = tally.flops - sum(k["flops"] for k in tally.kernels.values())
    assert abs(port - (ref_flops - attention)) <= 0.01 * port, (port, ref_flops, attention)


@pytest.mark.slow
def test_the_sharded_remat_train_step_equals_one_process():
    """(1, 2) tensor parallel, remat "none" and "dots", in one gloo world
    of 2: every parameter after one f32 step within 2e-5 of the plain
    one-process step's."""
    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), vocab_size=512)
    batch = train_batch(cfg, S)
    want, want_params = port_step(seeded(cfg), batch)
    jobs = [("train", dict(cfg=cfg, seed=0, batch=batch, rl=RLConfig(lr=LR), mesh=(1, 2),
                           fsdp=False, remat=policy)) for policy in layers.REMAT_POLICIES]
    ranks = sharded.run_world(sharded.jobs_world, 2, jobs, timeout=240)
    for j, _ in enumerate(jobs):
        got = ranks[0][j]
        assert abs(got["metrics"][0]["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        diff = max(np.abs(got["params"][n] - p.numpy()).max() for n, p in want_params.items())
        assert diff <= 2e-5, (jobs[j][1]["remat"], diff)


FSDP_CODE = """
import json, jax
from repro.configs import get_model_config, get_shape, reduced
from repro.configs.base import ShapeConfig
from repro.launch import dryrun
from repro.models import model
dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh((2, 2), ("data", "model"))
dryrun.get_model_config = lambda arch: reduced(get_model_config(arch))
dryrun.get_shape = lambda name: ShapeConfig(name, seq_len=64, global_batch=8, kind="train")
build, out = model.build_model, {}
for on in (True, False):
    # the reference's dry run always asks for remat: here it gets it or not
    dryrun.model_mod.build_model = lambda cfg, on=on, **kw: build(cfg, remat=on)
    rec = dryrun.build_dryrun("olmo-1b", "train_4k", accum_steps=2)
    out[str(on)] = rec["collectives"].get("all-gather_count", 0)
print(json.dumps(out))
"""


@pytest.mark.slow
def test_under_remat_the_port_gathers_fsdp_weights_once_where_the_reference_gathers_again():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run([sys.executable, "-c", FSDP_CODE], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    assert ref["True"] > ref["False"] > 0, ref
    cfg = reduced(get_model_config("olmo-1b"))
    shape = ShapeConfig("train_4k", seq_len=64, global_batch=8, kind="train")
    mesh = dryrun.Mesh(("data", "model"), (2, 2))
    got = {remat: dryrun.traced_on_mesh(cfg, shape, mesh, "train", accum_steps=2, remat=remat)
           for remat in (True, False)}
    data = {k: v["collectives_by_axis"]["data"]["all-gather_count"] for k, v in got.items()}
    assert data[True] == data[False] > 0, data
    assert got[True]["temp_bytes"] < got[False]["temp_bytes"]

"""The xLSTM in the dry run: the sLSTM's loop over time counted from three
traced steps (``models/xlstm.py::_slstm_scaled``, ``launch/op_analysis.py``'s
``mark`` / ``add_scaled`` / ``born_alive``), on the reduced xlstm-1.3b.

  * Against the same count done the slow way (``scale_loops=False``: every
    step dispatched): the train step (with and without remat) and the
    prefill step at 64 tokens, FLOPs and bytes within 1e-6 relative and
    the peak within 1%; and on a (2, 2) mesh under a fake process group,
    where each rank runs the loop on its own rows, the collectives too.
  * Against the reference: its compiled train forward and backward
    (sum(logits^2), ``remat=True`` on both sides), whose ``while`` bodies
    ``hlo_analysis`` multiplies by their trip counts.  The one difference,
    term by term: the reference's scan transposes its body alike at every
    step, so its backward also takes the gradient into the loop's initial
    state (zeros, a constant): 4 products of (B, d) by (d, d) a sLSTM
    layer, 2 B d^2 FLOPs each; the port's autograd skips that gradient,
    since the state needs none.  With those added the two are equal
    within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.launch import hlo_analysis
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as model_mod
from repro_torch.models import xlstm
from repro_torch.models.model import build_model

CFG = reduced(get_model_config("xlstm-1.3b"))
FLOP_BYTE_RTOL, PEAK_RTOL = 1e-6, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def count(kind, remat, scale, seq=64):
    shape = ShapeConfig("x", seq_len=seq, global_batch=2, kind=kind)
    model = model_mod.param_specs(CFG, dryrun.DTYPE, remat=remat)
    step, args, _ = dryrun.step_inputs(model, CFG, shape, vocab_parallel=False, accum_steps=2,
                                       paged_cache=False, block_size=16, fused_decode=False)
    return op_analysis.analyze(step, *args, scale_loops=scale)[1]


def assert_same_count(a, b):
    for k in ("flops", "bytes"):
        assert abs(getattr(a, k) - getattr(b, k)) <= FLOP_BYTE_RTOL * getattr(b, k), k
    assert abs(a.peak_bytes - b.peak_bytes) <= PEAK_RTOL * b.peak_bytes
    assert a.collectives.keys() == b.collectives.keys()
    for k, v in b.collectives.items():
        assert abs(a.collectives[k] - v) <= FLOP_BYTE_RTOL * v, k


@pytest.mark.parametrize("kind,remat", [("train", True), ("train", False), ("prefill", True)])
def test_the_scaled_loop_counts_what_dispatching_every_step_counts(kind, remat):
    scaled, whole = count(kind, remat, True), count(kind, remat, False)
    assert scaled.flops > 0 and scaled.peak_bytes > 0
    assert_same_count(scaled, whole)


def test_on_a_mesh_each_rank_runs_the_loop_on_its_rows(monkeypatch):
    """(2, 2), FSDP on: rank 0's program with the loop scaled against it
    with every step dispatched.  The first trace of a sharded step in a
    process counts more than the next (DTensor plans a redistribute anew
    the first time: one more concatenation of FSDP's gathered shards), so
    one trace comes first."""
    shape = ShapeConfig("x", seq_len=16, global_batch=4, kind="train")
    mesh = Mesh(("data", "model"), (2, 2))
    dryrun.traced_on_mesh(CFG, shape, mesh, "train", accum_steps=2)
    scaled = dryrun.traced_on_mesh(CFG, shape, mesh, "train", accum_steps=2)
    monkeypatch.setattr(xlstm, "META_LOOP_STEPS", 1 << 30)
    whole = dryrun.traced_on_mesh(CFG, shape, mesh, "train", accum_steps=2)
    assert scaled["collectives"]
    for k in ("flops", "bytes"):
        assert abs(scaled[k] - whole[k]) <= FLOP_BYTE_RTOL * whole[k], k
    assert abs(scaled["temp_bytes"] - whole["temp_bytes"]) <= PEAK_RTOL * whole["temp_bytes"]
    assert scaled["collectives"] == pytest.approx(whole["collectives"], rel=FLOP_BYTE_RTOL)


def test_the_scaled_train_flops_match_the_references_trip_counts():
    kw = dict(vocab_size=512)
    jcfg = dataclasses.replace(jax_reduced(jax_config("xlstm-1.3b")), **kw)
    tcfg = dataclasses.replace(CFG, **kw)
    b, s = 2, 64
    jm = jax_build_model(jcfg, remat=True)
    params = jm.init(jax.random.key(0))
    grad = jax.grad(lambda p, t: jnp.sum(jm.forward(p, t)[0] ** 2))
    hlo = jax.jit(grad).lower(params, jnp.zeros((b, s), jnp.int32)).compile().as_text()
    ref = hlo_analysis.analyze(hlo).flops
    model = build_model(tcfg, remat=True, device="meta")
    params_ = list(model.parameters())
    for p in params_:
        p.requires_grad_(True)
    _, tally = op_analysis.analyze(
        lambda t: torch.autograd.grad(model(t)[0].square().sum(), params_),
        torch.zeros((b, s), dtype=torch.int32, device="meta"))
    n_slstm = sum(kind == "slstm" for kind in model.kinds)
    initial_state = n_slstm * len(xlstm.GATES) * 2 * b * tcfg.d_model ** 2
    assert n_slstm > 0 and tally.kernels == {}
    assert abs(tally.flops + initial_state - ref) <= FLOP_BYTE_RTOL * ref, (tally.flops, ref)

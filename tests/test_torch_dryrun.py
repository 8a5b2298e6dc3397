"""The dry run on the meta device (``repro_torch.launch.{op_analysis,
dryrun,roofline}`` and ``kernels/meta.py``) on the CPU, against the
plain kernels and the reference's ``repro.launch.{hlo_analysis,dryrun}``.

  * each kernel's meta route returns its plain version's output shapes
    and dtypes (exactly), launches nothing and records its work;
  * ``op_analysis`` counts a chain of N matmuls as N times one;
  * a reduced dense forward's FLOPs outside the attention kernel equal
    the reference's compiled dot FLOPs (``hlo_analysis``) less the
    full-matrix attention products its jnp oracle spends (4 B H S^2 hd a
    layer), within 1%;
  * ``model_flops_estimate`` equals the reference's for every config x
    shape, exactly;
  * ``build_dryrun`` gives a record for every assigned arch x shape on
    the reduced configs, skips with the reference's reasons, and one full
    config on meta; nothing is allocated;
  * the roofline of a hand-made record, with the H100's constants.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import get_shape as jax_shape
from repro.configs import reduced as jax_reduced
from repro.launch import dryrun as jdryrun
from repro.launch import hlo_analysis
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_model_config, get_shape, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import meta, ops, ref
from repro_torch.launch import dryrun, op_analysis, roofline
from repro_torch.models import model as model_mod
from repro_torch.models.convert import params_from_jax

F32, I32 = torch.float32, torch.int32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*xs):
    return tuple(None if x is None else x.to("meta") for x in xs)


def _sig(out):
    out = out if isinstance(out, tuple) else (out,)
    return [None if x is None else (tuple(x.shape), x.dtype) for x in out]


def _paged(rng, b=3, e=5, bs=4, hkv=2, hd=64):
    n = b * e
    kp = torch.from_numpy(rng.standard_normal((n, bs, hkv, hd)).astype(np.float32))
    tables = torch.arange(n, dtype=I32).reshape(b, e)
    return kp, kp.clone(), tables


def _flash_cases(r, b, s, h, hkv, hd, tag=""):
    """Flash forward and backward, and ring decode, at head width hd."""
    q, k, v = r(b, s, h, hd), r(b, s, hkv, hd), r(b, s, hkv, hd)
    seg = torch.zeros((b, s), dtype=I32)
    lse = ref.flash_attention_lse(q, k, segment_ids=seg)
    out = ref.flash_attention(q, k, v, segment_ids=seg).contiguous()    # as the wrapper takes it
    kc, vc = r(b, 16, hkv, hd), r(b, 16, hkv, hd)
    pos = torch.arange(16, dtype=I32).repeat(b, 1)
    t = torch.full((b,), 15, dtype=I32)
    return [
        ("flash" + tag, lambda *a_: meta.flash_attention(*a_, return_lse=True),
         lambda q_, k_, v_, sg: (ref.flash_attention(q_, k_, v_, segment_ids=sg),
                                 ref.flash_attention_lse(q_, k_, segment_ids=sg)),
         (q, k, v, seg)),
        ("flash_bwd" + tag, meta.flash_attention_bwd,
         lambda *a_: ref.flash_attention_bwd(*a_[:6], segment_ids=a_[6]),
         (q, k, v, out, lse, r(*out.shape), seg)),
        ("decode" + tag, meta.decode_attention, ref.decode_attention,
         (r(b, h, hd), kc, vc, pos, t)),
    ]


def kernel_cases():
    """(name, meta route, plain version, args); the ``_hd80`` cases at
    h2o-danube-1.8b's head width, which the flash wrappers pad to 128."""
    rng = np.random.default_rng(0)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    b, h, hkv, hd = 2, 4, 2, 64
    cases = _flash_cases(r, b, 24, h, hkv, hd) + _flash_cases(r, b, 24, h, hkv, 80, "_hd80")
    kp, vp, tables = _paged(rng, b=b)
    t = torch.full((b,), 15, dtype=I32)
    qpos = torch.arange(8, 14, dtype=I32).repeat(b, 1)
    a, x, h0 = torch.rand(b, 24, 32), r(b, 24, 32), r(b, 24, 32)[:, 0]
    return cases + [
        ("paged_decode", meta.paged_decode_attention, ref.paged_decode_attention,
         (r(b, h, hd), kp, vp, tables, t)),
        ("fused_tail", meta.fused_decode_tail, ref.fused_decode_tail,
         (r(b, h, hd), kp, vp, r(h * hd, 48), tables, t)),
        ("paged_prefill", meta.paged_prefill_attention, ref.paged_prefill_attention,
         (r(b, 6, h, hd), kp, vp, tables, qpos)),
        ("scan", meta.linear_scan, ref.linear_scan, (a, x, h0)),
    ]


@pytest.mark.parametrize("case", kernel_cases(), ids=lambda c: c[0])
def test_meta_route_gives_the_plain_versions_outputs(case):
    name, meta_fn, plain, args = case
    want = plain(*args)
    with op_analysis.OpAnalysis() as a:
        got = meta_fn(*_meta(*args))
    assert _sig(got) == _sig(want)
    assert all(x is None or x.is_meta for x in (got if isinstance(got, tuple) else (got,)))
    (rec,) = a.tally.kernels.values()
    assert rec["calls"] == 1 and rec["flops"] > 0 and rec["bytes"] > 0
    assert a.tally.peak_bytes >= sum(x.numel() * x.element_size()
                                     for x in (want if isinstance(want, tuple) else (want,)))


def test_scan_gradient_meta_route_matches_autograd():
    rng = np.random.default_rng(1)
    a = torch.rand(2, 20, 16, requires_grad=True)
    x = torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(np.float32)).requires_grad_()
    h0 = torch.zeros(2, 16, requires_grad=True)
    h, h_last = ref.linear_scan(a, x, h0)
    g = torch.ones_like(h)
    grads = torch.autograd.grad((h * g).sum() + h_last.sum(), (a, x, h0))
    got = meta.linear_scan_bwd(*_meta(a.detach(), h.detach(), h0.detach(), g, h_last.detach()))
    assert _sig(got) == _sig(tuple(grads))


def test_ops_on_meta_take_the_meta_route_and_launch_nothing():
    """``ops`` on meta tensors: no plain version (no score matrix in the
    peak), nothing counted in LAUNCHES, the backward kernel's route under
    autograd; cross attention (Sq != Sk) stays plain."""
    b, s, h, hd = 1, 512, 4, 64
    q = torch.empty((b, s, h, hd), device="meta", requires_grad=True)
    k = torch.empty((b, s, 2, hd), device="meta", requires_grad=True)
    ops.reset_launches()
    with op_analysis.OpAnalysis() as a:
        out = ops.flash_attention(q, k, k)
        out.sum().backward()
    assert not any(ops.LAUNCHES.values())
    assert set(a.tally.kernels) == {"flash_attention", "flash_attention_bwd"}
    scores = b * h * s * s * 4
    assert a.tally.peak_bytes < scores
    pairs = b * h * s * (s + 1) // 2
    assert a.tally.kernels["flash_attention"]["flops"] == 4 * hd * pairs
    with op_analysis.OpAnalysis() as a:
        ops.flash_attention(q[:, :8], k, k, causal=False)
    assert not a.tally.kernels and a.tally.flops == 4 * b * h * 8 * s * hd


@pytest.mark.parametrize("n", [1, 3, 7])
def test_a_chain_of_matmuls_counts_n_times_one(n):
    w = torch.empty((256, 256), device="meta")

    def chain(x):
        for _ in range(n):
            x = torch.matmul(x, w)
        return x

    x = torch.empty((64, 256), device="meta")
    _, tally = op_analysis.analyze(chain, x)
    assert tally.flops == n * 2 * 64 * 256 * 256
    assert tally.bytes == n * 4 * (64 * 256 * 2 + 256 * 256)
    assert tally.peak_bytes == min(n, 2) * 64 * 256 * 4


def _flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def test_dense_forward_flops_outside_attention_match_the_reference():
    """The reference's compiled forward (dots, by ``hlo_analysis``)
    against the port's aten FLOPs on meta: equal to 1% once the jnp
    oracle's full-matrix attention products are taken out (no difference
    remains: they are equal here).  The port's attention kernel counts
    the causal half; it is left out too."""
    cfg = dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")), vocab_size=512)
    tcfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), vocab_size=512)
    b, s = 2, 64
    jm = jax_build_model(cfg, remat=False)
    params = jm.init(jax.random.key(0))
    tokens = jnp.zeros((b, s), jnp.int32)
    hlo = jax.jit(lambda p, t: jm.forward(p, t)[0]).lower(params, tokens).compile().as_text()
    ref_flops = hlo_analysis.analyze(hlo).flops
    attention = cfg.n_layers * 4 * b * cfg.n_heads * s * s * cfg.head_dim
    model = params_from_jax(tcfg, _flat_params(params), device="cpu").to("meta")
    _, tally = op_analysis.analyze(lambda t: model(t)[0], torch.zeros((b, s), dtype=I32,
                                                                      device="meta"))
    port = tally.flops - sum(k["flops"] for k in tally.kernels.values())
    assert abs(port - (ref_flops - attention)) <= 0.01 * port, (port, ref_flops, attention)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ("areal-qwen-1.5b",))
def test_model_flops_estimate_matches_the_reference(arch):
    for name in SHAPES:
        assert dryrun.model_flops_estimate(get_model_config(arch), get_shape(name)) == \
            jdryrun.model_flops_estimate(jax_config(arch), jax_shape(name))


class _NoMesh(Exception):
    pass


def _reference_skips(arch, shape, monkeypatch, **kw):
    """The reference's record where it skips, else None (it would go on
    to build its 256-device mesh, which is stopped here)."""
    def stop(**_):
        raise _NoMesh
    monkeypatch.setattr(jdryrun, "make_production_mesh", stop)
    try:
        return jdryrun.build_dryrun(arch, shape, **kw)
    except _NoMesh:
        return None


FLAGS = [dict(), dict(paged_cache=True), dict(paged_cache=True, fused_decode=True),
         dict(fused_decode=True)]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_build_dryrun_records_every_shape_of_the_reduced_configs(arch, monkeypatch):
    """Every shape of every assigned arch, reduced, on meta: skipped with
    the reference's reason where the reference skips; else each mesh's
    argument bytes at the full shape, and a record with the one-card
    trace at a shape cut to seconds on the CPU, built with remat as the
    reference's (the xLSTM's train and prefill traced too: its sLSTM loop
    counted by the analysis past its third step)."""
    cfg = reduced(get_model_config(arch))
    model = model_mod.param_specs(cfg, dryrun.DTYPE)
    for name, full in SHAPES.items():
        for kw in FLAGS:
            paged, fused = kw.get("paged_cache", False), kw.get("fused_decode", False)
            want = _reference_skips(arch, name, monkeypatch, **kw)
            reason = dryrun.skip_reason(cfg, full, paged_cache=paged, fused_decode=fused)
            if want is not None:
                assert reason == want["reason"], (name, kw)
                rec = dryrun.build_dryrun(arch, name, cfg=cfg, shape=full, **kw)
                assert rec["status"] == "skipped" and rec["reason"] == want["reason"], (name, kw)
                continue
            assert reason is None, (name, kw)
            _, _, groups = dryrun.step_inputs(model, cfg, full, vocab_parallel=False,
                                              accum_steps=8, paged_cache=paged, block_size=16,
                                              fused_decode=fused)
            for mesh in dryrun.MESHES:
                mem = dryrun.mesh_memory(cfg, model, groups, mesh, fsdp=True, fsdp_pods=False,
                                         accum_steps=8, kind=full.kind)
                assert mem["argument_bytes"] > 0, (name, kw, mesh.name)
            shape = ShapeConfig(name, seq_len=min(full.seq_len, 64),
                                global_batch=min(full.global_batch, 8), kind=full.kind)
            cut = dryrun.build_dryrun(arch, name, cfg=cfg, shape=shape,
                                      prefill_chunk=16 if fused else 0, **kw)
            assert cut["status"] == "ok" and set(cut["meshes"]) == {"1x1", "32x8", "2x32x8"}
            ssm = cfg.family == "ssm" and shape.kind != "decode"
            assert cut["remat_policy"] == "none"
            for mesh_name, m in cut["meshes"].items():
                assert m["memory"]["argument_bytes"] > 0
                if mesh_name == "1x1":
                    continue
                if ssm:
                    assert m["program"] == "traced" and "reason" not in m, (name, mesh_name)
                    assert all(np.isfinite(m[k]) and m[k] > 0 for k in ("flops", "bytes"))
                    assert np.isfinite(m["memory"]["temp_bytes"]) and m["memory"]["temp_bytes"] > 0
                elif shape.kind == "decode":
                    # the serving steps on the mesh, the chunk step with them
                    assert m["program"] == "traced" and "reason" not in m, (name, mesh_name)
                    assert ("chunk" in m) == bool(fused and paged), (name, kw, mesh_name)
                else:
                    assert m["program"] == "traced" and m["collectives"], (name, mesh_name)
                    assert m["memory"]["temp_bytes"] > 0
            assert ("prox" in cut) == (shape.kind == "train")
            one = cut["meshes"]["1x1"]
            if ssm:
                assert one["program"] == "traced" and "reason" not in one, name
                assert all(np.isfinite(one[k]) and one[k] > 0 for k in ("flops", "bytes"))
                assert one["memory"]["temp_bytes"] > 0 and one["collectives"] == {}
            assert one["program"] == "traced" and one["flops"] > 0 and one["collectives"] == {}
            assert one["memory"]["temp_bytes"] > 0 and one["kernels"] or cfg.family == "ssm"
            assert ("chunk" in cut) == fused
            assert cut["model_flops"] == dryrun.model_flops_estimate(cfg, shape)
            json.dumps(cut)


def test_one_full_config_on_meta():
    """areal-qwen-1.5b, decode_32k on the paged pool with the fused tail
    and a 128-token chunk, whole: the trace counts 28 launches of each
    kernel and the argument bytes: the bf16 weights, the token and
    tables, and a pool of 128 slots x 32768 positions."""
    cfg = get_model_config("areal-qwen-1.5b")
    rec = dryrun.build_dryrun("areal-qwen-1.5b", "decode_32k", paged_cache=True,
                              fused_decode=True, prefill_chunk=128)
    one = rec["meshes"]["1x1"]
    assert one["kernels"]["fused_decode_tail"]["calls"] == cfg.n_layers
    assert rec["chunk"]["kernels"]["paged_prefill_attention"]["calls"] == cfg.n_layers
    pool = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads * cfg.head_dim * 2
    params = sum(p.numel() * 2 for p in model_mod.param_specs(cfg).parameters())
    tables = 128 * 2048 * 4
    assert one["memory"]["argument_bytes"] == params + pool + 128 * 4 + 128 * 4 + tables
    assert rec["meshes"]["32x8"]["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]


@pytest.mark.parametrize("shape_name,kernels", [
    ("train_4k", {"flash_attention", "flash_attention_bwd"}),
    ("prefill_32k", {"flash_attention"}), ("decode_32k", {"decode_attention"})])
def test_head_dim_80_steps_trace_through_the_kernels(shape_name, kernels):
    """h2o-danube-1.8b at full width (head_dim 80) on meta, at a cut
    shape: each step reaches its kernels, which take the width (the flash
    wrappers pad it to 128).  The train step is built with remat, as the
    dry run builds it: its backward runs each layer's flash forward
    again."""
    cfg = get_model_config("h2o-danube-1.8b")
    assert cfg.head_dim == 80
    full = get_shape(shape_name)
    shape = ShapeConfig(shape_name, seq_len=min(full.seq_len, 256), global_batch=2,
                        kind=full.kind)
    rec = dryrun.build_dryrun("h2o-danube-1.8b", shape_name, cfg=cfg, shape=shape, accum_steps=2)
    one = rec["meshes"]["1x1"]
    assert rec["status"] == "ok" and one["program"] == "traced"
    assert set(one["kernels"]) == kernels
    accum = 2 if shape.kind == "train" else 1
    want = {"flash_attention": cfg.n_layers * accum * (2 if shape.kind == "train" else 1),
            "flash_attention_bwd": cfg.n_layers * accum, "decode_attention": cfg.n_layers}
    assert {n: k["calls"] for n, k in one["kernels"].items()} == {n: want[n] for n in kernels}


def test_meta_routes_refuse_what_the_wrappers_refuse():
    q = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        meta.flash_attention(q, q, q)
    q = torch.empty((1, 8, 2, 64), device="meta", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        meta.flash_attention(q, q, q)
    q, kc = torch.empty((1, 2, 76), device="meta"), torch.empty((1, 16, 2, 76), device="meta")
    pos, t = torch.empty((1, 16), dtype=I32, device="meta"), torch.empty(1, dtype=I32, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        meta.decode_attention(q, kc, kc, pos, t)


def _record(program="traced"):
    one = {"n_devices": 1, "program": program, "memory": {"argument_bytes": 30e9}}
    if program == "traced":
        one.update(flops=989e12, bytes=6.7e12, collectives={}, kernels={})
        one["memory"]["temp_bytes"] = 60e9
    return {"arch": "a", "shape": "s", "status": "ok", "model_flops": 494.5e12,
            "meshes": {"1x1": one, "32x8": {"n_devices": 256, "program": "not traced",
                                            "memory": {"argument_bytes": 1e9}}}}


def test_roofline_of_a_hand_made_record(tmp_path):
    rows = roofline.rows_from_record(_record())
    one, big = rows
    assert one.compute_s == pytest.approx(1.0) and one.memory_s == pytest.approx(2.0)
    assert one.dominant == "memory" and one.collective_s == 0.0 and one.total_s == 2.0
    assert one.useful_ratio == pytest.approx(0.5) and not one.fits       # 30 + 60 GB > 80 GB
    assert not big.traced and big.fits and big.compute_s == 0.0
    (tmp_path / "r.json").write_text(json.dumps(_record()))
    (tmp_path / "skip.json").write_text(json.dumps({"arch": "b", "shape": "s",
                                                    "status": "skipped", "reason": "why"}))
    rows = roofline.load_rows(str(tmp_path))
    md = roofline.to_markdown(rows)
    assert "| memory |" in md and "(args)" in md and "skipped why" in md
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.HBM_PER_CARD == 80e9 and roofline.LINK_BW == 450e9


def test_no_tpu_constant_in_the_ports_roofline_or_dryrun():
    import inspect
    import re
    for mod in (roofline, dryrun):
        src = inspect.getsource(mod)
        for const in ("197e12", "819e9", "50e9", "16e9"):
            assert not re.search(r"(?<![\d.])" + const, src), (mod.__name__, const)

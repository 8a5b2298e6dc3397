"""The dry run's meta routes and the step functions on the card (``-m
cuda``; skipped without a CUDA device).

This file imports no JAX, so it runs on the GPU machine as it is:

  * each kernel's meta route (``kernels/meta.py``) against its CUDA
    wrapper at the serving and training shapes of areal-qwen-1.5b, the
    hybrid's head_dim 256 and h2o-danube-1.8b's head_dim 80: the same
    output shapes and dtypes, and the bytes the wrapper asks the
    allocator for over the call (its outputs and scratch: the allocator's
    requested bytes, before its rounding) equal to the meta route's peak
    under ``launch/op_analysis.py`` with its rounding off, the meta plan
    given the card's resident grid;
  * the kernels h2o-danube-1.8b's steps reach at head_dim 80 (flash
    forward and backward, padded to 128 by their wrappers; ring decode,
    zero-padded in shared memory) against their plain versions, within
    the tolerances of the kernels' own card tests: 2e-5 in f32, 2e-2 in
    bf16, of each output's largest entry;
  * ``train_step`` at accum_steps 2 against 1, and with the vocab-parallel
    loss, on the same rows of a reduced config in f32 on the card:
    metrics within 1e-5 relative, the updated parameters within 1e-5 max
    abs (lr 1e-3).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import fused_decode_tail as ft
from repro_torch.kernels import meta
from repro_torch.kernels import paged_decode_attention as pd
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.fused_decode_tail import fused_decode_tail_cuda
from repro_torch.kernels.linear_scan import linear_scan_bwd_cuda, linear_scan_cuda
from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda
from repro_torch.launch import op_analysis, steps
from repro_torch.models.model import build_model

BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, device):
    return torch.randn(shape, device=device).to(dtype)


def _case(name, device):
    """(CUDA wrapper, meta route, args on ``device``) of one kernel call."""
    r = lambda *s, dt=BF16: _rand(s, dt, device)
    if name == "flash_hd80":
        q, k, v = r(1, 2048, 32, 80), r(1, 2048, 8, 80), r(1, 2048, 8, 80)
        return flash_attention_cuda, meta.flash_attention, (q, k, v), dict(return_lse=True)
    if name == "flash_bwd_hd80":
        q, k, v = r(1, 1024, 32, 80), r(1, 1024, 8, 80), r(1, 1024, 8, 80)
        out, dout, lse = r(1, 1024, 32, 80), r(1, 1024, 32, 80), r(1, 32, 1024, dt=F32)
        return flash_attention_bwd_cuda, meta.flash_attention_bwd, (q, k, v, out, lse, dout), {}
    if name == "decode_hd80":
        q, kc, vc = r(16, 32, 80), r(16, 4096, 8, 80), r(16, 4096, 8, 80)
        pos = torch.arange(4096, dtype=I32, device=device).repeat(16, 1)
        t = torch.full((16,), 4095, dtype=I32, device=device)
        return decode_attention_cuda, meta.decode_attention, (q, kc, vc, pos, t), {}
    if name == "flash":
        q, k, v = r(1, 2048, 12, 128), r(1, 2048, 2, 128), r(1, 2048, 2, 128)
        seg = torch.zeros((1, 2048), dtype=I32, device=device)
        return flash_attention_cuda, meta.flash_attention, (q, k, v, seg), dict(return_lse=True)
    if name == "flash_bwd":
        q, k, v = r(1, 1024, 16, 256), r(1, 1024, 1, 256), r(1, 1024, 1, 256)
        out, dout = r(1, 1024, 16, 256), r(1, 1024, 16, 256)
        lse = r(1, 16, 1024, dt=F32)
        return flash_attention_bwd_cuda, meta.flash_attention_bwd, (q, k, v, out, lse, dout), {}
    if name == "decode":
        q, kc, vc = r(16, 12, 128), r(16, 4096, 2, 128), r(16, 4096, 2, 128)
        pos = torch.arange(4096, dtype=I32, device=device).repeat(16, 1)
        t = torch.full((16,), 4095, dtype=I32, device=device)
        return decode_attention_cuda, meta.decode_attention, (q, kc, vc, pos, t), {}
    tables = torch.arange(16 * 256, dtype=I32, device=device).reshape(16, 256)
    kp, vp = r(16 * 256, 16, 2, 128), r(16 * 256, 16, 2, 128)
    t = torch.full((16,), 4095, dtype=I32, device=device)
    if name == "paged_decode":
        return (paged_decode_attention_cuda, meta.paged_decode_attention,
                (r(16, 12, 128), kp, vp, tables, t), {})
    if name == "fused_tail":
        return (fused_decode_tail_cuda, meta.fused_decode_tail,
                (r(16, 12, 128), kp, vp, r(1536, 1536), tables, t), {})
    if name == "paged_prefill":
        qpos = torch.arange(3968, 4096, dtype=I32, device=device)[None]
        return (paged_prefill_attention_cuda, meta.paged_prefill_attention,
                (r(1, 128, 12, 128), kp, vp, tables[:1].contiguous(), qpos), {})
    a, x = r(2, 4096, 4096, dt=F32), r(2, 4096, 4096, dt=F32)
    h0 = r(2, 4096, dt=F32)
    if name == "scan":
        return linear_scan_cuda, meta.linear_scan, (a, x, h0), {}
    return linear_scan_bwd_cuda, meta.linear_scan_bwd, (a, x, h0, r(2, 4096, 4096, dt=F32)), {}


def _flat(out):
    return [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash", "flash_bwd", "decode", "paged_decode", "fused_tail",
                                  "paged_prefill", "scan", "scan_bwd", "flash_hd80",
                                  "flash_bwd_hd80", "decode_hd80"])
def test_meta_route_matches_the_wrapper(cuda, name, monkeypatch):
    fn, meta_fn, args, kw = _case(name, cuda)
    fn(*args, **kw)                       # the wrappers' persistent buffers
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    card_bytes = torch.cuda.memory_stats()["requested_bytes.all.peak"] - base
    monkeypatch.setattr(op_analysis, "ALLOC_BLOCK", 1)
    # on meta a split plan has no resident bound: give it the card's
    for mod in (dec, pd, ft):
        monkeypatch.setattr(mod, "_capacity", lambda *a, real=mod._capacity: real(*a[:-1], cuda))
    margs = tuple(x.to("meta") for x in args)
    with op_analysis.OpAnalysis() as a:
        want = meta_fn(*margs, **kw)
    assert [(tuple(x.shape), x.dtype) for x in _flat(want)] == \
        [(tuple(x.shape), x.dtype) for x in _flat(got)]
    assert a.tally.peak_bytes == card_bytes, (name, a.tally.peak_bytes, card_bytes)
    assert a.tally.kernels and a.tally.flops > 0


def _close(name, got, want, tol):
    scale = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=tol,
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(F32, 2e-5), (BF16, 2e-2)], ids=["f32", "bf16"])
def test_head_dim_80_kernels_match_the_plain_versions(cuda, dtype, tol):
    """h2o-danube-1.8b's attention (32 query heads over 8, head_dim 80):
    flash forward, its log-sum-exp and the backward over a ragged S of
    two packed segments and a -1 tail, with and without a window; ring
    decode over a cache with a free slot."""
    gen = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=gen).to(cuda, dtype)
    b, s, h, hkv, hd = 2, 333, 32, 8, 80
    q, k, v, dout = r(b, s, h, hd), r(b, s, hkv, hd), r(b, s, hkv, hd), r(b, s, h, hd)
    seg = torch.zeros((b, s), dtype=I32)
    seg[:, 200:], seg[:, 320:] = 1, -1
    seg = seg.to(cuda)
    for window in (0, 100):
        kw = dict(segment_ids=seg, window=window)
        out, lse = flash_attention_cuda(q, k, v, seg, window=window, return_lse=True)
        _close("out", out, ref.flash_attention(q, k, v, **kw), tol)
        _close("lse", lse, ref.flash_attention_lse(q, k, **kw), tol)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, window=window)
        want = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == w.shape
            _close(name, g, w, tol)
    w = 1000
    kc, vc, qd = r(3, w, hkv, hd), r(3, w, hkv, hd), r(3, h, hd)
    pos = torch.arange(w, dtype=I32, device=cuda).repeat(3, 1)
    pos[2] = -1                                          # a free slot: 0
    t = torch.tensor([w - 1, 517, 0], dtype=I32, device=cuda)
    got = decode_attention_cuda(qd, kc, vc, pos, t)
    _close("decode", got[:2], ref.decode_attention(qd, kc, vc, pos, t)[:2], tol)
    assert torch.all(got[2] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(accum_steps=2), dict(vocab_parallel_loss=True)],
                         ids=["accum_2", "vocab_parallel"])
def test_train_step_variants_hold_on_the_card(cuda, kw):
    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), vocab_size=512)
    model = build_model(cfg, device=cuda, dtype=F32)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    init = [p.detach().clone() for p in model.parameters()]
    rng = np.random.default_rng(0)
    rows, seq = 2, 256
    seg = np.zeros((rows, seq), np.int32)
    seg[:, 100:] = 1
    pos = np.concatenate([np.arange(100), np.arange(seq - 100)]).astype(np.int32)
    mask = np.zeros((rows, seq), np.float32)
    mask[:, 50:100] = mask[:, 180:] = 1                  # the same count a row
    behav = -3 * rng.random((rows, seq), dtype=np.float32)
    batch = {"tokens": rng.integers(3, 512, (rows, seq)).astype(np.int32),
             "positions": np.broadcast_to(pos, (rows, seq)).copy(), "segment_ids": seg,
             "advantages": rng.standard_normal((rows, seq)).astype(np.float32),
             "behav_logprob": behav, "prox_logprob": behav + 0.1, "loss_mask": mask}
    batch = {k: torch.from_numpy(np.asarray(v, dtype=v.dtype)).to(cuda) for k, v in batch.items()}
    rl = RLConfig(lr=1e-3)

    def run(**step_kw):
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
        opt = optim.init_state(list(model.parameters()))
        met = steps.make_train_step(model, rl, **step_kw)(opt, batch)
        return {k: float(v) for k, v in met.items()}, [p.detach().clone()
                                                      for p in model.parameters()]

    base, want = run()
    met, got = run(**kw)
    for k in base:
        np.testing.assert_allclose(met[k], base[k], rtol=1e-5, atol=1e-8, err_msg=k)
    diff = max((a - b).abs().max().item() for a, b in zip(got, want))
    assert diff <= 1e-5, diff

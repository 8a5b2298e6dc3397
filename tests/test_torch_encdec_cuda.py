"""The enc-dec and xLSTM paths on the card (``-m cuda``; skipped without a
CUDA device).

This file imports no JAX, so it runs on the GPU machine as it is:

  * the attention kernels at whisper-medium's shapes against their plain
    versions in f32 at 2e-5: the flash forward non-causal over S 1500
    (not a multiple of the key tile) at 16/16 heads of 64, its backward,
    and ring decode at group 1, hd 64 over W 1500 with every row visible
    (the cross attention), twice bitwise equal;
  * ``ops.flash_attention`` with Sq != Sk takes the plain route on the
    card too (nothing launched);
  * the reduced whisper's prefill and decode (a ring whose B·W is not a
    multiple of 4) and the reduced xLSTM's paged chunked engine, on the
    card and on the CPU: logits within 1e-4, tokens equal.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_model_config, reduced
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.kernels import ops, ref
from repro_torch.models.model import build_model

TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()


def close(got, want, tol=TOL):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(8, 1500), (2, 1500), (1, 77)])
def test_flash_noncausal_hd64_matches_plain(cuda, b, s):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
    rng = np.random.default_rng(s + b)
    q, k, v, dout = (randn(rng, (b, s, 16, 64)) for _ in range(4))
    out, lse = flash_attention_cuda(q, k, v, None, causal=False, return_lse=True)
    close(out, ref.flash_attention(q, k, v, causal=False))
    want_lse = ref.flash_attention_lse(q, k, causal=False)
    close(lse, want_lse)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, None, causal=False)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, None, causal=False)
    for g, a, w in zip(got, again, ref.flash_attention_bwd(q, k, v, out, want_lse, dout,
                                                           causal=False)):
        assert torch.equal(g, a)
        close(g, w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("w,visible", [(1500, True), (136, False)], ids=["cross", "self"])
def test_decode_group1_hd64_matches_plain(cuda, w, visible):
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    rng = np.random.default_rng(w)
    b = 8
    q, kc, vc = randn(rng, (b, 16, 64)), randn(rng, (b, w, 16, 64)), randn(rng, (b, w, 16, 64))
    if visible:
        pos = torch.arange(w, dtype=torch.int32, device="cuda").repeat(b, 1)
        t = torch.full((b,), w, dtype=torch.int32, device="cuda")
    else:
        t = torch.from_numpy(rng.integers(0, w, size=b).astype(np.int32)).cuda()
        pos = torch.arange(w, dtype=torch.int32, device="cuda").repeat(b, 1)
        pos = torch.where(pos <= t[:, None], pos, -1)
    got = decode_attention_cuda(q, kc, vc, pos, t)
    assert torch.equal(got, decode_attention_cuda(q, kc, vc, pos, t))
    close(got, ref.decode_attention(q, kc, vc, pos, t))


@pytest.mark.cuda
def test_cross_attention_takes_the_plain_route_on_the_card(cuda):
    rng = np.random.default_rng(0)
    q, k, v = randn(rng, (2, 12, 4, 64)), randn(rng, (2, 40, 4, 64)), randn(rng, (2, 40, 4, 64))
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, None, causal=False)
    assert not any(ops.LAUNCHES.values())
    close(out, ref.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=False))


@pytest.mark.cuda
def test_reduced_whisper_card_matches_cpu(cuda):
    cfg = reduced(get_model_config("whisper-medium"))
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(3, 11)))
    frames = torch.from_numpy((rng.standard_normal((3, 8, cfg.prefix_dim)) * 0.1)
                              .astype(np.float32))
    outs = {}
    for dev, m in (("cpu", cpu), ("cuda", gpu)):
        cache = m.init_cache(3, 11)          # B·W = 33: layer views off 16 bytes
        lg, cache = m.prefill(toks[:, :4].to(dev), cache, prefix_embeds=frames.to(dev))
        seq = [lg]
        for i in range(4, 11):
            lg, cache = m.decode_step(toks[:, i].to(dev), cache)
            seq.append(lg)
        outs[dev] = torch.stack(seq).cpu()
    close(outs["cuda"], outs["cpu"], 1e-4)


@pytest.mark.cuda
def test_reduced_xlstm_paged_chunked_engine_card_matches_cpu(cuda):
    cfg = dataclasses.replace(reduced(get_model_config("xlstm-1.3b")), n_layers=4,
                              vocab_size=tokenizer.VOCAB_SIZE)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=int(rng.integers(4, 16))).tolist()}
            for i in range(4)]
    runs = {}
    for dev in ("cpu", "cuda"):
        engine = RolloutEngine(copy.deepcopy(cpu).to(dev), EngineConfig(
            n_slots=4, prompt_len=16, max_gen_len=8, temperature=0.0, cache="paged",
            block_size=4, prefill_chunk=3), device=dev)
        assert engine.admit(reqs) == 4
        done = {}
        while engine.n_active:
            for f in engine.step():
                done[f.rid] = f
        runs[dev] = {r: f.response for r, f in done.items()}
    assert runs["cuda"] == runs["cpu"]

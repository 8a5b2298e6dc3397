"""The mixture-of-experts path on the card (``-m cuda``; skipped without a
CUDA device).

This file imports no JAX, so it runs on the GPU machine as it is:

  * ``moe_apply`` on the card against the same layer on the CPU, in f32
    at 1e-5, with the same assignments kept (one group and 32, drops
    included, and tied router probabilities), and twice bitwise equal on
    the card (no atomics in the combine);
  * the attention kernels at the shapes the MoE and VLM paths give them
    (head_dim 128 at groups 1, 2 and 16; the fused tail at 64 heads and
    ``wo`` 8192 x 4096) against their plain versions in f32 at 2e-5;
  * ``mean_empty_rows``: the paged kernels' rows that see no key take
    the plain version's value;
  * the reduced olmoe-1b-7b's chunked paged engine with the fused tail,
    greedy across an update, on the card and on the CPU: token for token.
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
from repro_torch.models import moe
from repro_torch.models.model import build_model

TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def small_cfg(**kw):
    return dataclasses.replace(reduced(get_model_config("olmoe-1b-7b")),
                               vocab_size=tokenizer.VOCAB_SIZE, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("t,tie", [(24, False), (256, False), (32, True)],
                         ids=["g1", "g32", "tied"])
def test_moe_apply_card_matches_cpu(cuda, t, tie):
    cfg = small_cfg()
    layer = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    layer.init_(torch.Generator().manual_seed(1))
    if tie:
        with torch.no_grad():
            layer.router.zero_()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(t, cfg.d_model))
                         .astype(np.float32))
    y, aux = moe.moe_apply(cfg, layer, x)
    card = copy.deepcopy(layer).to(cuda)
    gy, gaux = moe.moe_apply(cfg, card, x.to(cuda))
    again, _ = moe.moe_apply(cfg, card, x.to(cuda))
    assert torch.equal(gy, again)
    np.testing.assert_allclose(gy.cpu().numpy(), y.numpy(), atol=1e-5, rtol=1e-5)
    assert gaux["drop"].item() == aux["drop"].item()
    for k in ("lb", "z"):
        np.testing.assert_allclose(gaux[k].item(), aux[k].item(), rtol=1e-5)
    if t == 256:
        assert aux["drop"].item() > 0


def pool(rng, dev, n, bs, hkv, hd):
    return [torch.from_numpy(rng.normal(size=(n, bs, hkv, hd)).astype(np.float32)).to(dev)
            for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d_model", [(16, 16, 2048), (64, 4, 4096)],
                         ids=["olmoe-group1", "qwen3-group16"])
def test_moe_kernel_shapes(cuda, h, hkv, d_model):
    """Flash, ring decode, paged decode, paged prefill and the fused tail
    at hd 128 with these head groups, against their plain versions."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.fused_decode_tail import fused_decode_tail_cuda
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
    from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda
    rng = np.random.default_rng(3)
    hd, b, s = 128, 2, 200
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    q, k, v = f(b, s, h, hd), f(b, s, hkv, hd), f(b, s, hkv, hd)
    seg = torch.tensor([[0] * s, [0] * 150 + [-1] * 50], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(flash_attention_cuda(q, k, v, seg, causal=True),
                               ref.flash_attention(q, k, v, segment_ids=seg), atol=TOL, rtol=TOL)
    w = 96
    pos = torch.arange(w, dtype=torch.int32, device=cuda)[None].repeat(b, 1)
    tt = torch.tensor([95, 40], dtype=torch.int32, device=cuda)
    qd, kc, vc = f(b, h, hd), f(b, w, hkv, hd), f(b, w, hkv, hd)
    torch.testing.assert_close(decode_attention_cuda(qd, kc, vc, pos, tt),
                               ref.decode_attention(qd, kc, vc, pos, tt), atol=TOL, rtol=TOL)
    bs, n = 16, 12
    kp, vp = pool(rng, cuda, n, bs, hkv, hd)
    tables = torch.tensor([[3, 7, 1, 9, -1], [2, 4, 6, -1, -1]], dtype=torch.int32,
                          device=cuda)
    tq = torch.tensor([60, 40], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(paged_decode_attention_cuda(qd, kp, vp, tables, tq),
                               ref.paged_decode_attention(qd, kp, vp, tables, tq),
                               atol=TOL, rtol=TOL)
    wo = f(h * hd, d_model) * (h * hd) ** -0.5
    got = fused_decode_tail_cuda(qd, kp, vp, wo, tables, tq)
    want = ref.fused_decode_tail(qd, kp, vp, wo, tables, tq)
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()
    c = 16
    qc = f(b, c, h, hd)
    q_pos = (tq[:, None] - torch.arange(c, device=cuda).flip(0)[None]).to(torch.int32)
    torch.testing.assert_close(paged_prefill_attention_cuda(qc, kp, vp, tables, q_pos),
                               ref.paged_prefill_attention(qc, kp, vp, tables, q_pos),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_mean_empty_rows_on_the_card(cuda):
    """A free slot's decode row and a span's padded queries: with
    ``mean_empty_rows`` the card's paged decode, fused tail and paged
    prefill equal their plain versions on every row."""
    rng = np.random.default_rng(4)
    h, hkv, hd, bs, n = 8, 2, 64, 16, 10
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    kp, vp = pool(rng, cuda, n, bs, hkv, hd)
    tables = torch.tensor([[3, 7, 1, -1], [-1, -1, -1, -1]], dtype=torch.int32, device=cuda)
    tq = torch.tensor([40, 17], dtype=torch.int32, device=cuda)
    qd, wo = f(2, h, hd), f(h * hd, 256) * (h * hd) ** -0.5
    for name, args in (("paged_decode_attention", (qd, kp, vp, tables, tq)),
                       ("fused_decode_tail", (qd, kp, vp, wo, tables, tq))):
        got = getattr(ops, name)(*args, mean_empty_rows=True)
        want = getattr(ref, name)(*args)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    qc = f(2, 4, h, hd)
    q_pos = torch.tensor([[38, 39, 40, -1], [1, 2, -1, -1]], dtype=torch.int32, device=cuda)
    got = ops.paged_prefill_attention(qc, kp, vp, tables, q_pos, mean_empty_rows=True)
    torch.testing.assert_close(got, ref.paged_prefill_attention(qc, kp, vp, tables, q_pos),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_small_moe_paged_engine_card_matches_cpu(cuda):
    cfg = small_cfg()
    rng = np.random.default_rng(31)
    reqs = []
    for g in range(3):
        p = rng.integers(3, cfg.vocab_size, size=int(rng.integers(5, 24))).tolist()
        reqs += [{"rid": 3 * g + j, "prompt_id": g, "answer": None, "prompt": p}
                 for j in range(3)]
    ecfg = EngineConfig(n_slots=4, prompt_len=24, max_gen_len=12, temperature=0.0, seed=0,
                        cache="paged", block_size=4, prefill_chunk=3, fused_decode="fused")
    cpu0 = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda):
        m0, m1 = copy.deepcopy(cpu0).to(dev), copy.deepcopy(cpu0).to(dev)
        with torch.no_grad():
            for p in m1.parameters():
                p.mul_(1.01)
        engine = RolloutEngine(m0, ecfg, device=dev)
        done, pending, steps = {}, list(reqs), 0
        while len(done) < len(reqs):
            pending = pending[engine.admit(pending):]
            if steps == 4:
                engine.update_weights(m1, 1)
            for fin in engine.step():
                done[fin.rid] = fin
            steps += 1
        runs[str(dev)] = done
    want, got = runs["cpu"], runs[str(cuda)]
    for rid, fin in want.items():
        assert (got[rid].response, got[rid].versions) == (fin.response, fin.versions), rid

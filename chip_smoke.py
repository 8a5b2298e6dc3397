#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and runtime paths on one NVIDIA H100.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # environment, build and kernel checks only
    python3 chip_smoke.py --profile  # every phase, then torch.profiler traces of decode steps,
                                     # of a hybrid admission prefill and of a train step

Phases, each printing one JSON line:
  1. env      torch/CUDA versions, the card, its compute capability and
              ``nvidia-smi``'s name and power limit; TF32 off.
  2. build    every kernel of ``src/repro_torch/csrc`` built with nvcc for
              sm_90a, all at once, and ptxas's register/spill report.
  3. kernel   each Hopper kernel held against its plain PyTorch version, in
              bf16 and f32: the paged kernels over the case tables of
              ``tests/test_kernels.py`` and its poisoned partial blocks,
              paged prefill over spans at fixed starts (``PP_SPAN_CASES``)
              and every split plan (bitwise equal twice), paged decode and
              the fused tail over their edges (``PAGED_EDGE_CASES``: hd 40,
              block sizes 8/16/32, an unbound slot, a window opening inside
              a tile, B = 20 at D = 1536; forced split plans, every call
              twice, bitwise equal; at the serving shapes one call each
              captured in a CUDA graph and replayed), flash attention
              over its edges (``FLASH_EDGE_CASES``: ragged S with B > 1,
              padding segments, windows opening inside a tile), the linear
              scan over ``LS_CASES`` and ``LS_EDGE_CASES`` (ragged S and C,
              resets and underflowing products; every call twice, bitwise
              equal; a graph replay) and at ``LS_TIMED``'s shapes (the
              RG-LRU prefill's, each timed), decode attention over its edges
              (``DECODE_EDGE_CASES`` and ``HYBRID_DECODE_EDGE_CASES``: W = 1,
              ragged W, groups of 1/6/16, a slot that sees no key, windows
              opening inside a tile, forced split plans, a NaN tail past W;
              every call twice, bitwise equal; at the serving shapes one
              call captured in a CUDA graph and replayed), and every kernel
              at its serving path's shapes (flash and decode attention at
              both models' head widths, 128 and 256; flash at S=512 and
              768; paged prefill at [0, 128), [384, 512) and [512, 640)),
              where it is timed with CUDA events beside its bound, its plain
              version and one PyTorch library call computing the same
              function.  Paged decode, paged prefill and the fused tail
              (``wo`` 4096 x 4096, beside the unfused route: paged decode
              plus ``matmul(wo)``) also at the RG-LRU hybrid's local
              attention (head_dim 256, 16 query heads over one kv head, a
              window of 2048, pools past it; forced split plans, every
              call twice bitwise equal), and paged prefill
              over speculative decoding's verify spans (C = 3 at hd 256, C
              = 4 at areal-qwen-1.5b's widths), timed.
     train_kernel  the flash-attention backward kernel, and the forward's
              log-sum-exp, against their plain versions over ``BWD_SHAPES``
              x ``BWD_VARIANTS`` in f32 and bf16 (hd 64/128, B 1/4, S
              1/37/256/768, H/Hkv 4/2 and 12/2; causal, windowed,
              non-causal; packed segments with a -1 tail), every call twice
              bitwise equal, each timed beside the plain backward and
              SDPA's backward, and at the ``train`` phase's micro-batch
              (one packed row of 6144 tokens: 8 segments of 727, then
              padding); each gradient also within a norm-relative error
              ``NORM_TOL`` of its reference, whole and per head.  At that
              row the forward with its log-sum-exp is also checked and
              timed beside SDPA's forward (``train_forward``).  Then the
              backward at head_dim 256 in bf16 (``HD256_BWD_CASES`` and a
              packed row of 6144 tokens, 16 heads over one, window 2048,
              a segment longer than the window: ``HD256_TRAIN``, timed),
              and the scan's gradient kernel against autograd of the
              plain scan (B 1, S 6144, C 4096, f32, resets, h0; timed).
     moe_kernel  every attention kernel at the shapes the MoE and VLM
              paths give it (hd 128: flash at groups 1, 2 and 16, ring
              decode at groups 1 and 16, paged decode at group 1, paged
              prefill chunks of 128 at groups 1 and 16, the fused tail at
              olmoe's ``wo`` 2048 x 2048 and at qwen3-moe's 64 heads and
              8192 x 4096), bf16 and f32, timed in bf16.
     encdec_kernel  the kernels at whisper-medium's shapes: flash
              attention non-causal over B 8 x S 1500 at 16/16 heads of 64
              (with its log-sum-exp), its backward at the same shape, ring
              decode at group 1, hd 64 over W 1500 every row visible (the
              cross attention) and over the self-attention ring's width;
              bf16 and f32, timed in bf16 (``encdec_shapes`` in the
              ``kernels`` line).
  4. small    the reduced models through the kernels on the card against
              the plain path on the CPU, same weights, f32: the dense one's
              ring prefill and decode, paged prefill, chunked paged prefill,
              paged decode unfused and fused; the RG-LRU hybrid's ring
              prefill and decode (head_dim 256, MQA, a local window shorter
              than the prompt); ``small_train``: one ``train_step`` of the
              reduced dense model and one of the reduced hybrid (the scan
              and its gradient kernel) on the card and on the CPU;
              ``small_gateway``: the reduced dense model in f32 through the
              paged gateway with urgent traffic that preempts and its twin
              without, on both devices from host-drawn noise: trajectories
              equal across devices, and on the card preempted == twin;
              ``small_spec``: the reduced dense model (3 layers) and the
              hybrid in f32, ring and paged, prefill chunk 0 and 3: the
              speculative engine (k = 3) equals the plain engine on the
              card and itself on the CPU, token for token; ``small_moe``:
              the reduced olmoe-1b-7b in f32 at capacity factor 1.25 (tokens
              dropped), ring, paged (chunks of 3, the fused tail) and paged
              speculative (k = 2) across an update, card equal to CPU token
              for token; ``small_encdec``: the reduced whisper in f32 (8
              frames, a cross cache that ``init_cache`` sized 16), forward,
              prefill and 8 greedy decode steps, card against CPU (logits,
              greedy tokens); ``small_xlstm``: the reduced xlstm-1.3b at 4
              layers in f32 through every engine configuration the reference
              runs on it (``XLSTM_SMALL_SETUPS``), across an update, card
              equal to CPU token for token.
  5. serve    ``build_model(get_model_config("areal-qwen-1.5b"))`` at full
              width in bf16, random weights from a seeded generator, behind
              a ring-cache ``RolloutEngine``: after a warm-up on a throwaway
              engine, 8 requests admitted, decoded, interrupted by an
              ``update_weights`` with perturbed weights, decoded to the end.
  6. serve_paged  the same model behind the paged engine (blocks of 16,
              prefix sharing, ``evict="lru"``, chunked prefill of 128 and
              the fused decode tail): 2 prompts sampled 4 times each, one
              interrupting weight update that re-ingests every history.
  7. serve_paged_unfused  the same traffic with monolithic paged prefill
              (flash attention) and the unfused paged decode.
 7b. serve_gateway  the same model behind ``repro_torch.serve.Gateway``,
              128 tokens a request: ``gateway`` (paged, blocks of 16, LRU,
              chunked prefill of 128, fused tail; 4 background requests
              and 4 sessions x 3 turns at priority 2 sharing a 384-token
              prefix, 4 urgent requests at tick 32 that preempt, then the
              same traffic without them: the twin), ``evict`` (no
              preemption, a pool of 192 blocks, so LRU evicts), ``ring``
              (``launch/serve.py``'s defaults through ``run_offline``: the
              ring cache, whose chunked spans run the plain attention,
              timed), ``http`` (``GatewayServer`` on 127.0.0.1, 4 clients
              in two waves, ``/stats``, ``/metrics``, ``/healthz``) and
              ``cli`` (``python -m repro_torch.launch.serve`` on the card,
              the multi-turn environment, a Perfetto trace).
 7c. serve_spec  the same model greedy, ring then paged (chunks of 128,
              no fused tail), plain and with ``spec_decode=4`` at draft
              units 27 and 14, 96 tokens a request; the run at 14 takes an
              ``update_weights`` while a drafted round is pending.  Tokens/s,
              ms a round, acceptance, launches a round, agreement with the
              plain engine.
  8. serve_hybrid  ``recurrentgemma-9b`` (38 layers: 26 RG-LRU, 12 local
              attention at head_dim 256 over one kv head) at full width in
              bf16 behind the ring-cache engine, with phase 5's traffic and
              interruption, after the dense models are freed.
 8b. serve_hybrid_paged  the same model greedy on 4 prompts of 2304-2560
              tokens (past its window of 2048), 48 tokens each: the ring
              engine monolithic (the yardstick) and chunked (128), the paged
              engine (blocks of 16, chunks of 128) with ``spec_decode=3``,
              with the fused decode tail (12 launches a step), and plain
              with an interrupting ``update_weights`` that re-ingests
              every history; launches = 26 x spans (scan) and 12 x calls
              (each paged kernel); agreement with the ring.
 8c. train_hybrid  the hybrid's RL loop: recurrentgemma-9b at full width
              cut to 6 layers (2 x (rec, rec, local)), after its serving
              models are freed: the paged engine (chunked prefill of 128,
              the fused tail) generates 2 GRPO groups of 4 from prompts
              past the window, Algorithm 1 packs them into micro-batches
              of 4096 tokens, two ``train_step``s around an interrupting
              ``update_weights(trainer.params, 1)``; the step's split,
              trained tokens/s, peak memory and every kernel's launches
              (the fused tail, paged prefill, the scan and its gradient,
              flash forward and backward) checked against the layers.
  9. train    areal-qwen-1.5b at full width behind ``PPOTrainer`` (bf16
              weights, f32 m/v), after the hybrid is freed: the ring engine
              generates two GRPO groups of 16 answers, packed by Algorithm 1
              into micro-batches of 6144 tokens (6-10 sequences a row),
              ``train_step``, a second batch
              interrupted by ``update_weights(trainer.params, 1)``, a second
              ``train_step``; the step's time split, trained tokens/s, peak
              memory, flash forward and backward launches (28 x their
              calls), and the hand-off checked not to alias.
 10. train_loop  the virtual-clock training loop, ``run_training`` of
              ``repro_torch.launch.train`` as a user calls it, after the
              trainer is freed: the quickstart twin (``examples/
              quickstart.py``'s arguments: 12 steps, eta 4, 32 prompts x 4
              answers, 16 slots, laptop scale: 2 layers, d 256, head_dim 64,
              f32; its final held-out eval included), then 3 steps of the
              same loop and the same CPU run from one initialisation and one
              noise (``cpu_parity``, reported), ``laptop_multiturn`` (3
              steps with ``env="multiturn"``: chunked ring ingest and the
              environment's turns, masked out of the loss), then
              areal-qwen-1.5b at full
              width (``scale="pod"``, f32 weights, 3 steps).  One line a
              StepLog (with its ``train_step``'s section split), then each
              part's wall time, virtual clock, tokens/s over the engine's
              steps, peak memory (the ``ParameterStore``'s copies
              included), eval and launches; versions 1..n consecutive,
              staleness at most eta, an interrupting update, finite losses,
              and launches = layers x (prefills + 2 x micro-batches) for the
              forward, layers x decode steps, layers x micro-batches for the
              backward.
 11. threaded  the threaded runtime, ``run_training(runtime="threaded")``:
              the rollout and trainer threads each on its own CUDA stream,
              weights handed over by a copy on the trainer's stream that
              the rollout stream waits for.  ``laptop`` (the quickstart's
              settings, 12 steps, ring cache) and ``laptop_paged`` (paged,
              chunked prefill of 8), each then ``run_serial`` for 12 steps
              on fresh objects; ``streams_delta`` / ``streams_delta-q`` (6
              steps each, chunked publication streams: chunks and bytes a
              version); ``reward`` (``env="math"`` on 2 reward workers,
              the service's stats); ``ckpt`` (every 10th version spilled
              under ``build/``, each file read back against what was
              published); ``full_width`` (areal-qwen-1.5b, f32, 3 threaded
              steps, then 3 ``run_serial`` steps).  Each prints its StepLog
              walls, wall a step, trainer busy share, tokens generated
              during ``train_step``s, tokens/s and peak memory, and
              requires versions 1..n, staleness at most eta + 2, every
              trajectory consumed once, the engine's weights the trainer's
              (bitwise; under delta-q within the streams' summed declared
              tolerance), tokens generated during training, two distinct
              streams, and launches = layers x calls.
              In phases 5-12 launch counts are set to 0 just before the
              engine, the gateway or the loop is driven and read just after.
 12. fleet    the process fleet, ``run_training(runtime="fleet")``: the
              supervisor here, the rollout workers and a trainer replica
              as spawned processes on the same card, every message numpy
              (weights, m and v ship to the replica and back each step).
              ``laptop`` (the quickstart's settings, 2 rollout workers),
              ``laptop_1w`` (1 worker, printed beside phase 11's
              ``laptop`` and its serial twin), ``kill`` (``laptop_1w``'s
              settings, its worker SIGKILLed once a version is out and it
              holds requests: requeued, respawned, the replacement starts
              from the supervisor's weights) and ``full_width``
              (areal-qwen-1.5b, f32, 1 rollout worker, 3 steps, the
              module's default heartbeat timeout).  Each prints StepLog
              walls, wall a step (and steady, after the first StepLog,
              which starts the processes), the round trip to the replica
              split into its load, ``train_step``, host copy and the
              shipping, bytes each way, the longest gap between a
              worker's dispatched messages, per-process launches, threads,
              peak device memory and sampled peak RSS, and ``nvidia-smi
              --query-compute-apps``; requires versions 1..n, staleness at
              most eta + 2, every trajectory consumed once, finite losses,
              launches = layers x calls in each cleanly stopped worker, and
              each role's kernels launched in its own processes (counted
              there and reported on the heartbeats).
 13. profile  (``--profile`` only) device time of a few decode steps of
              each serving phase's engine by kernel kind, and the card's
              idle share of a decode step; of one admission prefill of the
              hybrid (the linear scan's share of its device time); of one
              more ``train_step``; of one more step of each loop; and of
              one more full-width threaded step, by CUDA stream, with the
              milliseconds during which both streams ran kernels.
 14. serve_moe  olmoe-1b-7b at full width and depth (16 layers, 64
              experts top 8, 6.92 B parameters) in bf16: phase 5's traffic
              on the ring engine (``serve_moe``), phase 6's on the paged
              engine (``serve_moe_paged``), the dropped share of one
              prefill and one decode step layer by layer and the experts'
              floor of a decode step (part ``probe``); part ``qwen3_cut``:
              qwen3-moe-235b-a22b at its published widths cut to 2 of 94
              layers, paged with the fused tail, 8 prompts of 512, 64
              tokens.  Launches = layers x calls.
 15. serve_vlm  internvl2-2b at full width and depth in bf16: the ring
              engine as the reference's (no prefix; 8 prompts of 512, 128
              tokens, an update), then part ``prefix``: 4 rows of 256
              projected prefix embeddings and 512 tokens through
              ``LM.prefill(prefix_embeds=)`` and 32 decode steps, each
              step's logits against ``LM.forward`` within ``VLM_TOL``.
 16. train_moe  the paper's loop on olmoe-1b-7b at full width cut to
              ``MOE_TRAIN_LAYERS`` layers: the paged engine (chunks of 128,
              the fused tail) generates 2 GRPO groups of 8, micro-batches
              of 6144 tokens, two ``train_step``s around an interrupting
              update; step split, tokens/s, the router's lb, z and drop,
              peak memory, launches.
 17. serve_encdec  whisper-medium whole (24 + 24 layers) in bf16: 8 rows
              of 1500 frames, prompts of 3-8 tokens, ``encode``, ``prefill``
              and 128 greedy ``decode_step``s (decode logits against
              ``forward`` within ``ENCDEC_TOL``; 48 decode launches a step);
              part ``grad``: forward and backward of mean(logits^2) at 128
              tokens a row (the flash backward once a layer).
 18. serve_xlstm  xlstm-1.3b whole (42 mLSTM, 6 sLSTM; 3.65 B parameters)
              in bf16: 8 prompts of 512 on every engine of ``XLSTM_SERVE``
              (ring and chunked at 256 tokens, paged, paged chunked with the
              fused-tail flag and ring speculative at 32), each with an
              interrupting update; no kernel launched.
 19. train_xlstm  xlstm-1.3b at full width cut to 8 layers (one 7:1
              unit): the ring engine generates 2 GRPO groups of 4, one
              ``train_step`` on micro-batches of 2048 tokens.
 20. steps    the production step functions of ``launch/steps.py`` on
              areal-qwen-1.5b at full width (bf16, f32 m and v), each at a
              shape cut to one card (``STEPS_*``): train (8 rows of 4096,
              accum_steps 8, with and without the vocab-parallel loss),
              prox, prefill (2 x 32768), serve on the ring, paged and
              fused caches (16 slots of 32768) and one chunk of 128; each
              beside the dry run's prediction for that shape on the
              one-card mesh (argument bytes, required equal to the
              inputs'; peak, required within ``STEPS_PEAK_RATIO`` of the
              card's for train and prefill; FLOPs; bound) with device ms,
              mfu and launches; accum_steps 2 against 1 and the
              vocab-parallel loss against the plain one in f32; part
              ``hybrid``: recurrentgemma-9b cut to 6 layers, prefill, serve
              and train steps (the scan and its gradient).
Then the script's wall time, the ``kernels`` line, the card's name and
power limit, and the result line.  Any failure raises, so the script exits non-zero.  It
exits non-zero with no result where no CUDA device is visible or the
port's sources are missing.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:69",
    "decode_attention": "src/repro/kernels/decode_attention.py:62",
    "paged_decode_attention": "src/repro/kernels/paged_decode_attention.py:77",
    "paged_prefill_attention": "src/repro/kernels/paged_prefill_attention.py:80",
    "fused_decode_tail": "src/repro/kernels/fused_decode_tail.py:89",
    "linear_scan": "src/repro/kernels/linear_scan.py:48",
    "flash_attention_bwd": "none: the gradient of ref.flash_attention by XLA autodiff "
                           "(src/repro/kernels/ref.py:25)",
    "linear_scan_bwd": "none: the gradient of ref.linear_scan by XLA autodiff "
                       "(src/repro/kernels/ref.py:273)",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["linear_scan_bwd"] = SOURCES["linear_scan"]     # its reverse-time mode
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# gradients, as a whole and per (batch, head): rms(got - want) within
# rel x rms(want) + floor.  bf16's rel: the kernel rounds P and dS to bf16
# (2^-9) for its products, and a dropped or misweighted tile moves a head's
# norm by far more than 1%.  The floor, 1e-4 of a typical entry, covers
# gradients that cancel to rounding noise: a token that sees only itself
# has dq = dk = 0 up to the f32 rounding of dO.v - D (~8e-7 rms at hd 128)
NORM_TOL = {"bfloat16": (1e-2, 1e-5), "float32": (1e-5, 1e-5)}


def require(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Mean device time of a call, by CUDA events around each launch, with
    the 50 MB L2 flushed before each one (the serving path meets every
    layer's cache cold).  A spin kernel queued ahead of each launch keeps
    the host's enqueue time (argument checks, allocation, the ctypes
    call) out of the interval between the events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(1_000_000)          # ~0.5 ms of device time
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


# ---------------------------------------------------------------------------
# kernel inputs at the serving path's shapes
# ---------------------------------------------------------------------------

def flash_inputs(torch, np, rng, dtype, b, s, h, hkv, hd):
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, hd), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, hd), dtype=np.float32))
    # right-padded rows, as a prefill of prompts of mixed lengths
    lengths = rng.integers(s // 2, s + 1, size=b)
    seg = np.where(np.arange(s)[None, :] < lengths[:, None], 0, -1).astype(np.int32)
    cuda = lambda x: x.to("cuda", dtype).contiguous()
    return cuda(q), cuda(k), cuda(v), torch.from_numpy(seg).cuda()


def ring_state(np, rng, b, w, t_hi):
    """cache_pos / t of ring caches whose slots hold the latest position
    <= t with that residue mod W, t spread over [0, t_hi), and about a
    tenth of the slots emptied."""
    t = rng.integers(0, t_hi, size=b).astype(np.int32)
    slot = np.arange(w)[None, :]
    latest = t[:, None] - ((t[:, None] - slot) % w)
    pos = np.where(latest >= 0, latest, -1).astype(np.int32)
    pos[rng.random((b, w)) < 0.1] = -1
    pos[np.arange(b), t % w] = t                       # the token itself is written
    return pos, t


def decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, w):
    q = torch.from_numpy(rng.standard_normal((b, h, hd), dtype=np.float32))
    kc = torch.from_numpy(rng.standard_normal((b, w, hkv, hd), dtype=np.float32))
    vc = torch.from_numpy(rng.standard_normal((b, w, hkv, hd), dtype=np.float32))
    pos, t = ring_state(np, rng, b, w, 2 * w)
    cuda = lambda x: x.to("cuda", dtype).contiguous()
    return (cuda(q), cuda(kc), cuda(vc), torch.from_numpy(pos).cuda(),
            torch.from_numpy(t).cuda())


# b, h, hkv, hd, w, window, variant: W = 1 and ragged W (not a multiple
# of the 16-key tile), groups of 1, 6 and 16, B = 64 with W = 32, windows
# opening inside a tile, a slot that sees no key ("empty": it gives 0),
# forced split plans 1, 2 and one per tile ("plans"), and B = 1 caches
# that are a view [:, :W] of a longer buffer whose tail is NaN
# ("nan_tail": no row past W is read).  Every call runs twice and must
# give the same bits.  Head widths of areal-qwen-1.5b's path, then of the
# hybrid's local attention.
DECODE_EDGE_CASES = [
    (2, 12, 2, 128, 1, 0, None), (3, 12, 2, 128, 17, 0, None), (2, 12, 2, 128, 100, 0, None),
    (2, 6, 2, 64, 1000, 0, None), (2, 4, 4, 64, 200, 0, None), (2, 6, 1, 64, 300, 0, None),
    (2, 16, 1, 64, 130, 40, None), (2, 8, 8, 128, 300, 0, None), (2, 6, 1, 128, 257, 0, None),
    (2, 32, 2, 128, 333, 50, None), (64, 12, 2, 128, 32, 0, None),
    (2, 12, 2, 128, 1000, 37, None), (3, 12, 2, 128, 768, 0, "empty"),
    (2, 12, 2, 128, 1000, 0, "plans"), (1, 12, 2, 128, 100, 0, "nan_tail")]
HYBRID_DECODE_EDGE_CASES = [
    (1, 16, 1, 256, 1, 0, None), (2, 16, 1, 256, 100, 0, None), (2, 2, 2, 256, 150, 0, None),
    (2, 12, 2, 256, 515, 0, None), (2, 16, 1, 256, 2048, 1000, None),
    (3, 16, 1, 256, 300, 0, "empty"), (2, 16, 1, 256, 768, 100, "plans"),
    (1, 16, 1, 256, 777, 0, "nan_tail")]


def graph_check(torch, name: str, call) -> str:
    """One call of a kernel captured in a CUDA graph (a cooperative launch
    whose barriers read their base from their counts when they run)
    replays to the bits of the eager call, twice."""
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()                                  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(out, eager), f"{name}: a graph replay differs")
    return "bitwise equal to the eager call, twice"


def decode_graph_check(torch, q, kc, vc, pos, t) -> str:
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    return graph_check(torch, "decode_attention",
                       lambda: decode_attention_cuda(q, kc, vc, pos, t))


def decode_edge_check(torch, np, dtype, cases, table: str, seed: int) -> None:
    """decode attention over an edge-case table, against its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import TILE, decode_attention_split

    dn = str(dtype).split(".")[1]
    rng = np.random.default_rng(seed)
    err = 0.0
    for case in cases:
        b, h, hkv, hd, w, window, variant = case
        q, kc, vc, pos, t = decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, w)
        if variant == "empty":
            pos[-1] = -1
        if variant == "nan_tail":
            tail = lambda x: torch.cat([x, torch.full_like(x[:, :64], float("nan"))], 1)[:, :w]
            kc, vc = tail(kc), tail(vc)
        want = ref.decode_attention(q, kc, vc, pos, t, window=window)
        live = slice(0, b - 1) if variant == "empty" else slice(0, b)
        for n_split in (None, 1, 2, -(-w // TILE)) if variant == "plans" else (None,):
            got = decode_attention_split(q, kc, vc, pos, t, n_split, window=window)
            again = decode_attention_split(q, kc, vc, pos, t, n_split, window=window)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"decode_attention {case} n_split={n_split}: two calls differ")
            err = max(err, check("decode_attention", got[live], want[live], dn,
                                 (case, n_split)))
            if variant == "empty":
                require(bool(torch.all(got[-1] == 0)),
                        f"decode_attention {case}: a slot that sees no key is not 0")
    emit({"phase": "kernel", "name": "decode_attention", "dtype": dn, "cases": table,
          "max_abs_err": err, "tol": TOL[dn]})


# b, s, h, hkv, hd, window, segments, causal: ragged S (not a multiple of
# 64 or 128), padding segments at the tail ("pad"), packed segments (True),
# windows whose first visible key falls inside a tile; head_dim 64/128/256;
# and without the causal mask
FLASH_EDGE_CASES = [
    (3, 577, 4, 2, 128, 0, "pad", True), (2, 200, 4, 1, 64, 0, "pad", True),
    (2, 577, 16, 1, 256, 0, "pad", True), (2, 300, 4, 2, 128, 100, "pad", True),
    (1, 577, 16, 1, 256, 200, True, True), (2, 200, 4, 2, 64, 70, False, True),
    (2, 130, 6, 2, 64, 48, True, True), (1, 96, 4, 2, 256, 0, False, True),
    (2, 200, 4, 2, 128, 0, "pad", False), (1, 300, 4, 1, 256, 100, True, False),
    (2, 130, 6, 2, 64, 0, False, False)]


def edge_inputs(torch, np, rng, dtype, b, s, h, hkv, hd, segs):
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
               for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    seg = None
    if segs == "pad":
        lengths = rng.integers(s // 2, s + 1, size=b)
        seg = np.where(np.arange(s)[None, :] < lengths[:, None], 0, -1).astype(np.int32)
    elif segs:
        seg = np.sort(rng.integers(0, 4, size=(b, s)), axis=1).astype(np.int32)
    return q, k, v, None if seg is None else torch.from_numpy(seg).cuda()


def flash_mask(torch, seg, s, window, causal=True):
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    mask = qpos >= kpos if causal else torch.ones((s, s), dtype=torch.bool, device="cuda")
    if window:
        mask &= (qpos - kpos) < window
    return mask[None, None] & (seg[:, None, :, None] == seg[:, None, None, :])


def decode_mask(pos, t, window):
    tb = t[:, None]
    valid = (pos >= 0) & (pos <= tb)
    if window:
        valid &= pos > tb - window
    return valid


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def bound(flops: float, byts: float, dtype_name: str):
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate of their type, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], byts / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def check(name, got, want, dtype_name, case) -> float:
    import torch
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype_name]
    bad = err > tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"{name} {case} {dtype_name}: max abs err {err.max().item()} "
                             f"over tolerance {tol}")
    return err.max().item()


def rms_rel(got, want) -> float:
    """rms(got - want) / rms(want) over the whole tensor."""
    d, w = got.float() - want.float(), want.float()
    return (d.square().mean().sqrt() / w.square().mean().sqrt().clamp_min(1e-30)).item()


def check_norm(name, got, want, dtype_name, case) -> float:
    """Hold a (B, S, H, hd) gradient by its rms error, whole and per
    (batch, head): rms(got - want) <= rel x rms(want) + floor.  Returns
    the largest per-head error over ``rel x rms(want) + floor``."""
    rel, floor = NORM_TOL[dtype_name]
    d, w = got.float() - want.float(), want.float()
    err = d.square().mean().sqrt().item()
    lim = rel * w.square().mean().sqrt().item() + floor
    head_err = d.square().mean(dim=(1, 3)).sqrt()
    head_lim = rel * w.square().mean(dim=(1, 3)).sqrt() + floor
    worst = (head_err / head_lim).max().item()
    if err > lim or worst > 1.0:
        raise AssertionError(f"{name} {case} {dtype_name}: rms err {err} over {lim}, or a "
                             f"head's over its limit by {worst}x")
    return max(err / lim, worst)


def kernel_phase(torch, np, quick: bool):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    rng = np.random.default_rng(0)
    b, h, hkv, hd = 8, 12, 2, 128            # areal-qwen-1.5b, 8 slots
    prompt, max_len = 512, 768                # prompt width; re-prefill (max_len) width
    timer = None if quick else Timer(torch)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        # ---- flash attention: prefill and re-prefill widths, one windowed case
        for s, window in ((prompt, 0), (max_len, 0), (prompt, 256)):
            q, k, v, seg = flash_inputs(torch, np, rng, dtype, b, s, h, hkv, hd)
            case = f"B={b} S={s} H={h} Hkv={hkv} hd={hd} window={window}"
            got = flash_attention_cuda(q, k, v, seg, causal=True, window=window)
            want = ref.flash_attention(q, k, v, segment_ids=seg, causal=True, window=window)
            torch.cuda.synchronize()
            err = check("flash_attention", got, want, dn, case)
            rec = {"phase": "kernel", "name": "flash_attention", "dtype": dn, "case": case,
                   "max_abs_err": err, "tol": TOL[dn]}
            if timer is not None and window == 0:
                mask = flash_mask(torch, seg, s, window)
                pairs = mask.sum().item() * h
                flops = 4.0 * hd * pairs
                byts = nbytes(q, k, v, seg, got)
                kx, vx = k.transpose(1, 2), v.transpose(1, 2)
                qx = q.transpose(1, 2)
                rec.update(
                    ms=timer(lambda: flash_attention_cuda(q, k, v, seg, causal=True)),
                    plain_ms=timer(lambda: ref.flash_attention(q, k, v, segment_ids=seg)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)),
                    flops=flops, bytes=byts,
                    bound_ms=1e3 * max(flops / PEAK_FLOPS[dn], byts / PEAK_BYTES),
                    bound_by="operations" if flops / PEAK_FLOPS[dn] > byts / PEAK_BYTES
                    else "bytes")
            emit(rec)
            if "ms" in rec and dn == "bfloat16" and s == prompt:
                results["flash_attention"] = rec
        # ---- flash attention's edges: ragged S with B > 1 (TMA zero-fills the
        # rows past S), padding segments, windows opening inside a tile
        err = 0.0
        erng = np.random.default_rng(10)     # its own: the cases after keep their inputs
        for b_, s_, h_, hkv_, hd_, window, segs, causal in FLASH_EDGE_CASES:
            q, k, v, seg = edge_inputs(torch, np, erng, dtype, b_, s_, h_, hkv_, hd_, segs)
            got = flash_attention_cuda(q, k, v, seg, causal=causal, window=window)
            want = ref.flash_attention(q, k, v, segment_ids=seg, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max(err, check("flash_attention", got, want, dn,
                                 (b_, s_, h_, hkv_, hd_, window, segs, causal)))
        emit({"phase": "kernel", "name": "flash_attention", "dtype": dn,
              "cases": "FLASH_EDGE_CASES", "max_abs_err": err, "tol": TOL[dn]})
        # ---- decode attention: ring caches at W = max_len, window 0 and > 0
        for window in (0, 256):
            q, kc, vc, pos, t = decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, max_len)
            case = f"B={b} W={max_len} H={h} Hkv={hkv} hd={hd} window={window}"
            got = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            again = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            want = ref.decode_attention(q, kc, vc, pos, t, window=window)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"decode_attention {case}: two calls differ")
            err = check("decode_attention", got, want, dn, case)
            rec = {"phase": "kernel", "name": "decode_attention", "dtype": dn, "case": case,
                   "max_abs_err": err, "tol": TOL[dn]}
            if dn == "bfloat16" and window == 0:
                rec["graph_replay"] = decode_graph_check(torch, q, kc, vc, pos, t)
            if timer is not None and window == 0:
                valid = decode_mask(pos, t, window)
                n_valid = valid.sum().item()
                flops = 4.0 * hd * h * n_valid
                # K and V rows the mask keeps, every position, q, t and out
                byts = (2 * n_valid * hkv * hd * kc.element_size()
                        + nbytes(pos, t, q, got))
                mask = valid[:, None, None, :]
                qx = q[:, :, None, :]
                kx, vx = kc.transpose(1, 2), vc.transpose(1, 2)
                rec.update(
                    ms=timer(lambda: decode_attention_cuda(q, kc, vc, pos, t)),
                    plain_ms=timer(lambda: ref.decode_attention(q, kc, vc, pos, t)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)),
                    flops=flops, bytes=byts,
                    bound_ms=1e3 * max(flops / PEAK_FLOPS[dn], byts / PEAK_BYTES),
                    bound_by="operations" if flops / PEAK_FLOPS[dn] > byts / PEAK_BYTES
                    else "bytes")
            emit(rec)
            if "ms" in rec and dn == "bfloat16":
                results["decode_attention"] = rec
        decode_edge_check(torch, np, dtype, DECODE_EDGE_CASES, "DECODE_EDGE_CASES", seed=12)
    return results


# ---------------------------------------------------------------------------
# paged kernels: the case tables of tests/test_kernels.py, the poisoned
# partial blocks and the paged engine's own shapes
# ---------------------------------------------------------------------------

PD_CASES = [   # b, h, hkv, hd, bs, entries, window
    (1, 4, 4, 32, 8, 4, 0), (2, 8, 2, 64, 16, 6, 0), (3, 8, 1, 80, 8, 5, 16),
    (2, 4, 2, 128, 32, 3, 48)]
FT_CASES = [   # b, h, hkv, hd, bs, entries, window, d_model
    (1, 4, 4, 32, 8, 4, 0, 48), (2, 8, 2, 64, 16, 6, 0, 128), (3, 8, 1, 80, 8, 5, 16, 56),
    (2, 4, 2, 128, 32, 3, 48, 96)]
PP_CASES = [   # b, c, h, hkv, hd, bs, entries, window
    (1, 8, 4, 4, 32, 8, 4, 0), (2, 5, 8, 2, 64, 16, 6, 0), (3, 16, 8, 1, 80, 8, 5, 16),
    (2, 3, 4, 2, 128, 32, 3, 48)]


# b, c, h, hkv, hd, bs, entries, window, span start, n_split (bf16; f32
# takes one split): spans at 0, mid-block, [384, 512) and [512, 640)
PP_SPAN_CASES = [
    (1, 128, 12, 2, 128, 16, 48, 0, 0, 2), (2, 100, 8, 2, 64, 16, 12, 0, 7, 2),
    (1, 128, 12, 2, 128, 16, 48, 0, 384, 1), (1, 128, 12, 2, 128, 16, 48, 0, 384, 8),
    (2, 128, 12, 2, 128, 16, 48, 0, 512, 10), (3, 70, 8, 1, 80, 8, 40, 48, 200, 2),
    (2, 150, 4, 2, 32, 16, 20, 0, 140, 3)]


# b, h, hkv, hd, bs, entries, window, d_model, variant: the paged decode
# kernels' edges (as tests/test_torch_paged_kernels.py's KERNEL_CASES):
# hd 40 (not a multiple of 16), block sizes 8, 16 and 32, a slot whose
# table is all unbound ("unbound"), a window opening inside a tile, B = 20
# slots at D = 1536 (two row tiles of the fused tail's projection).  Each
# at forced split plans 1, 2 and the most the resident grid takes, and the
# wrapper's; every call twice, bitwise equal.
PAGED_EDGE_CASES = [
    (3, 8, 2, 40, 16, 10, 0, 64, None), (4, 12, 2, 128, 8, 64, 0, 256, None),
    (4, 12, 2, 128, 16, 32, 0, 256, None), (4, 12, 2, 128, 32, 16, 0, 256, None),
    (3, 12, 2, 128, 16, 20, 0, 128, "unbound"), (3, 12, 2, 128, 16, 20, 37, 128, None),
    (20, 12, 2, 128, 16, 48, 0, 1536, None)]


def paged_edge_check(torch, np, dtype, seed: int) -> None:
    """Both paged decode kernels over PAGED_EDGE_CASES, against their
    plain versions."""
    from repro_torch.kernels import fused_decode_tail as ft
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import ref

    dn = str(dtype).split(".")[1]
    code = 1 if dtype == torch.bfloat16 else 0
    rng = np.random.default_rng(seed)
    errs = {"paged_decode_attention": 0.0, "fused_decode_tail": 0.0}
    for case in PAGED_EDGE_CASES:
        b, h, hkv, hd, bs, entries, window, d, variant = case
        kp, vp, tab, t = paged_case(np, rng, b, hkv, hd, bs, entries)
        if variant == "unbound":
            tab[0] = -1
        q = rng.standard_normal((b, h, hd), dtype=np.float32)
        wo = rng.standard_normal((h * hd, d), dtype=np.float32) * (h * hd) ** -0.5
        q, kp, vp, wo = (torch.from_numpy(x).to("cuda", dtype) for x in (q, kp, vp, wo))
        tab, t = torch.from_numpy(tab).cuda(), torch.from_numpy(t).cuda()
        act = tab.max(dim=1).values >= 0
        want = {"paged_decode_attention": ref.paged_decode_attention(q, kp, vp, tab, t,
                                                                     window=window),
                "fused_decode_tail": ref.fused_decode_tail(q, kp, vp, wo, tab, t,
                                                           window=window)}
        cap = min(pd._capacity(code, hd, q.device), ft._capacity(code, h, hkv, hd, q.device))
        most = min(-(-entries * bs // 16), cap // (b * hkv))
        for n_split in sorted({1, min(2, most), most}) + [None]:
            for name, call, chk in (
                    ("paged_decode_attention",
                     lambda: pd.paged_decode_attention_split(q, kp, vp, tab, t, n_split,
                                                             window=window), check),
                    ("fused_decode_tail",
                     lambda: ft.fused_decode_tail_split(q, kp, vp, wo, tab, t, n_split,
                                                        window=window), check_scaled)):
                got, again = call(), call()
                torch.cuda.synchronize()
                where = (case, n_split)
                require(torch.equal(got, again), f"{name} {where}: two calls differ")
                require(bool(torch.all(got[~act] == 0)),
                        f"{name} {where}: a slot with no visible key is not 0")
                errs[name] = max(errs[name], chk(name, got[act], want[name][act], dn, where))
    emit({"phase": "kernel", "dtype": dn, "cases": "PAGED_EDGE_CASES, forced split plans",
          "max_abs_err": errs, "tol": TOL[dn]})


def span_case(np, rng, b, c, hkv, hd, bs, entries, start):
    """Pool and tables whose slot s holds a span of c queries ending at
    t = start + c - 1 - s, its entries bound up to t and unbound after."""
    n_pool = b * entries + 2
    kp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    perm = rng.permutation(n_pool)
    tables = np.full((b, entries), -1, np.int32)
    t = np.array([start + c - 1 - s for s in range(b)], np.int32)
    for s in range(b):
        nb = int(t[s]) // bs + 1
        tables[s, :nb] = perm[s * entries:s * entries + nb]
    return kp, vp, tables, t


def paged_case(np, rng, b, hkv, hd, bs, entries):
    """Pool, tables and t as ``tests/test_kernels.py::_paged_case`` makes
    them: partial last blocks, unbound tails, and the last slot empty
    when b > 1."""
    n_pool = b * entries + 2
    kp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    tables = np.full((b, entries), -1, np.int32)
    t = np.zeros((b,), np.int32)
    perm = rng.permutation(n_pool)
    nxt = 0
    for i in range(b):
        if b > 1 and i == b - 1:
            continue
        nb = int(rng.integers(1, entries + 1))
        tables[i, :nb] = perm[nxt:nxt + nb]
        nxt += nb
        t[i] = int(rng.integers((nb - 1) * bs, nb * bs))
    return kp, vp, tables, t


def engine_pool(np, rng, b, hkv, hd, bs, entries, t_lo, t_hi, group=4):
    """A pool as the paged engine leaves it: slots in groups of ``group``
    that share the first t_lo // bs blocks (their prompt's full blocks),
    each slot's own blocks after them, positions t in [t_lo, t_hi)."""
    n_pool = b * entries
    kp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    perm = iter(rng.permutation(n_pool).tolist())
    tables = np.full((b, entries), -1, np.int32)
    t = rng.integers(t_lo, t_hi, size=b).astype(np.int32)
    shared = {}
    n_shared = t_lo // bs
    for i in range(b):
        if i // group not in shared:
            shared[i // group] = [next(perm) for _ in range(n_shared)]
        tables[i, :n_shared] = shared[i // group]
        for e in range(n_shared, int(t[i]) // bs + 1):
            tables[i, e] = next(perm)
    return kp, vp, tables, t


def distinct_rows(tab, valid, bs: int) -> int:
    """Pool rows (block, offset) that some slot's mask keeps, each counted
    once: a prompt block shared by a group is read once per call, not once
    per slot.  tab (B, E) int32, valid (B, E*bs) bool."""
    import torch
    pos = torch.arange(tab.shape[1] * bs, device=tab.device)
    row = tab[:, pos // bs].long() * bs + pos % bs
    return torch.unique(row[valid]).numel()


def check_scaled(name, got, want, dtype_name, case) -> float:
    """max |got - want| within tol times the output's largest magnitude:
    each output of the fused tail sums H * hd products of contexts that
    are themselves rounded to the working dtype."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not torch.isfinite(got.float()).all() or not err <= TOL[dtype_name] * scale:
        raise AssertionError(f"{name} {case} {dtype_name}: max abs err {err} over "
                             f"{TOL[dtype_name]} x output scale {scale}")
    return err


def paged_kernel_phase(torch, np, quick: bool):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_decode_tail import fused_decode_tail_cuda
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
    from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda

    rng = np.random.default_rng(1)
    cuda = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", dt)
    dev_i = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    timer = None if quick else Timer(torch)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        errs = {"paged_decode_attention": 0.0, "fused_decode_tail": 0.0,
                "paged_prefill_attention": 0.0}
        # ---- the case tables ------------------------------------------
        for b, h, hkv, hd, bs, entries, window in PD_CASES:
            kp, vp, tab, t = paged_case(np, rng, b, hkv, hd, bs, entries)
            q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
            kp, vp, tab, t = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(t)
            got = paged_decode_attention_cuda(q, kp, vp, tab, t, window=window)
            want = ref.paged_decode_attention(q, kp, vp, tab, t, window=window)
            torch.cuda.synchronize()
            act = tab.max(dim=1).values >= 0
            errs["paged_decode_attention"] = max(errs["paged_decode_attention"], check(
                "paged_decode_attention", got[act], want[act], dn, (b, h, hkv, hd, bs, window)))
            require(bool(torch.all(got[~act] == 0)),
                    "paged_decode_attention: an empty slot is not 0")
        for b, h, hkv, hd, bs, entries, window, d in FT_CASES:
            kp, vp, tab, t = paged_case(np, rng, b, hkv, hd, bs, entries)
            q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
            wo = cuda(rng.standard_normal((h * hd, d), dtype=np.float32) * hd ** -0.5, dtype)
            kp, vp, tab, t = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(t)
            got = fused_decode_tail_cuda(q, kp, vp, wo, tab, t, window=window)
            want = ref.fused_decode_tail(q, kp, vp, wo, tab, t, window=window)
            torch.cuda.synchronize()
            act = tab.max(dim=1).values >= 0
            errs["fused_decode_tail"] = max(errs["fused_decode_tail"], check_scaled(
                "fused_decode_tail", got[act], want[act], dn, (b, h, hkv, hd, bs, window, d)))
        for b, c, h, hkv, hd, bs, entries, window in PP_CASES:
            kp, vp, tab, t = paged_case(np, rng, b, hkv, hd, bs, entries)
            q = cuda(rng.standard_normal((b, c, h, hd), dtype=np.float32), dtype)
            qpos = t[:, None] - np.arange(c)[::-1][None, :]
            qpos = np.where(qpos >= 0, qpos, -1).astype(np.int32)
            kp, vp, tab, qp = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(qpos)
            got = paged_prefill_attention_cuda(q, kp, vp, tab, qp, window=window)
            want = ref.paged_prefill_attention(q, kp, vp, tab, qp, window=window)
            torch.cuda.synchronize()
            ok = (qp >= 0) & (tab.max(dim=1).values >= 0)[:, None]
            errs["paged_prefill_attention"] = max(errs["paged_prefill_attention"], check(
                "paged_prefill_attention", got[ok], want[ok], dn,
                (b, c, h, hkv, hd, bs, window)))
            require(bool(torch.all(got[qp < 0] == 0)),
                    "paged_prefill_attention: a padded row is not 0")
        # ---- poisoned partial blocks (test_kernels.py:174, :243) -------
        b, h, hkv, hd, bs, d = 1, 2, 2, 32, 8, 24
        q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
        kp = cuda(rng.standard_normal((4, bs, hkv, hd), dtype=np.float32), dtype)
        vp = cuda(rng.standard_normal((4, bs, hkv, hd), dtype=np.float32), dtype)
        wo = cuda(rng.standard_normal((h * hd, d), dtype=np.float32), dtype)
        tab = torch.tensor([[2, 1]], dtype=torch.int32, device="cuda")
        t = torch.tensor([bs + 2], dtype=torch.int32, device="cuda")
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[1, 4:] = 1e3
        vp2[1, 4:] = -1e3
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"], check(
            "paged_decode_attention", paged_decode_attention_cuda(q, kp2, vp2, tab, t),
            ref.paged_decode_attention(q, kp, vp, tab, t), dn, "poisoned tail"))
        errs["fused_decode_tail"] = max(errs["fused_decode_tail"], check_scaled(
            "fused_decode_tail", fused_decode_tail_cuda(q, kp2, vp2, wo, tab, t),
            ref.fused_decode_tail(q, kp, vp, wo, tab, t), dn, "poisoned tail"))
        emit({"phase": "kernel", "dtype": dn, "cases": "PD/FT/PP tables and poisoned tails",
              "max_abs_err": errs, "tol": TOL[dn]})
        paged_edge_check(torch, np, dtype, seed=14)

        # ---- the paged engine's shapes --------------------------------
        b, h, hkv, hd, bs, entries, dm = 8, 12, 2, 128, 16, 48, 1536
        kp, vp, tab, t = engine_pool(np, rng, b, hkv, hd, bs, entries, 256, 768)
        q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
        wo = cuda(rng.standard_normal((h * hd, dm), dtype=np.float32) * (h * hd) ** -0.5, dtype)
        kp, vp, tab, t = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(t)
        case = f"B={b} H={h} Hkv={hkv} hd={hd} pool=({kp.shape[0]}, {bs}) E={entries}"
        kg, vg, kpos = ref.gather_pool(kp, vp, tab)
        valid = decode_mask(kpos, t, 0)
        n_valid = valid.sum().item()                 # (slot, key) pairs: the FLOPs
        # bytes: each visible pool row once, though 4 slots see a shared one
        kv_bytes = 2 * distinct_rows(tab, valid, bs) * hkv * hd * kp.element_size()
        qx, kx, vx = q[:, :, None, :], kg.transpose(1, 2), vg.transpose(1, 2)
        mask = valid[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask,
                                                      enable_gqa=True)
        for name, fn, plain, lib, flops, byts in (
                ("paged_decode_attention",
                 lambda: paged_decode_attention_cuda(q, kp, vp, tab, t),
                 lambda: ref.paged_decode_attention(q, kp, vp, tab, t),
                 sdpa, 4.0 * hd * h * n_valid, kv_bytes + nbytes(q, tab, t, q)),
                ("fused_decode_tail",
                 lambda: fused_decode_tail_cuda(q, kp, vp, wo, tab, t),
                 lambda: ref.fused_decode_tail(q, kp, vp, wo, tab, t),
                 lambda: torch.matmul(sdpa().reshape(b, h * hd), wo),
                 4.0 * hd * h * n_valid + 2.0 * b * h * hd * dm,
                 kv_bytes + nbytes(q, tab, t, wo) + b * dm * q.element_size())):
            got, again, want = fn(), fn(), plain()
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"{name} {case}: two calls differ")
            chk = check_scaled if name == "fused_decode_tail" else check
            rec = {"phase": "kernel", "name": name, "dtype": dn, "case": case,
                   "max_abs_err": chk(name, got, want, dn, case), "tol": TOL[dn]}
            if dn == "bfloat16":
                rec["graph_replay"] = graph_check(torch, name, fn)
            if timer is not None:
                rec.update(ms=timer(fn), plain_ms=timer(plain), library_ms=timer(lib),
                           flops=flops, bytes=byts, kv_bytes=kv_bytes, **bound(flops, byts, dn))
                if name == "fused_decode_tail":   # the unfused path it stands against
                    rec["paged_decode_plus_matmul_ms"] = timer(lambda: torch.matmul(
                        paged_decode_attention_cuda(q, kp, vp, tab, t).reshape(b, h * hd), wo))
            emit(rec)
            if dn == "bfloat16":
                results[name] = rec
        # chunked-prefill spans of C=128 queries on slot 0's table, its
        # entries bound up to the span's end: the engine's first span [0,
        # 128), an admission span [384, 512) and a re-ingest span [512, 640)
        c = 128
        srng = np.random.default_rng(11)     # its own: the cases after keep their inputs
        used = set(tab.flatten().tolist())
        spare = [i for i in range(kp.shape[0]) if i not in used]
        for start in (0, 384, 512):
            tab1 = tab[:1].clone()
            need = (start + c + bs - 1) // bs
            tab1[0, need:] = -1
            for e in range(need):
                if tab1[0, e] < 0:
                    tab1[0, e] = spare.pop()
            qc = cuda(srng.standard_normal((1, c, h, hd), dtype=np.float32), dtype)
            qpos = torch.arange(start, start + c, dtype=torch.int32, device="cuda")[None]
            case = f"B=1 C={c} H={h} Hkv={hkv} hd={hd} q_pos=[{start}, {start + c})"
            fn = lambda: paged_prefill_attention_cuda(qc, kp, vp, tab1, qpos)
            plain = lambda: ref.paged_prefill_attention(qc, kp, vp, tab1, qpos)
            got, want = fn(), plain()
            torch.cuda.synchronize()
            rec = {"phase": "kernel", "name": "paged_prefill_attention", "dtype": dn,
                   "case": case, "tol": TOL[dn],
                   "max_abs_err": check("paged_prefill_attention", got, want, dn, case)}
            if dn == "bfloat16":
                # every split plan, from one split to one per visible key
                # tile, computes the same function, and twice the same bits
                for n_split in (1, 2, (start + c + 63) // 64):
                    got = paged_prefill_attention_cuda(qc, kp, vp, tab1, qpos, n_split=n_split)
                    again = paged_prefill_attention_cuda(qc, kp, vp, tab1, qpos,
                                                         n_split=n_split)
                    torch.cuda.synchronize()
                    require(torch.equal(got, again),
                            f"paged_prefill_attention {case} n_split={n_split}: two calls differ")
                    rec["max_abs_err"] = max(rec["max_abs_err"], check(
                        "paged_prefill_attention", got, want, dn, f"{case} n_split={n_split}"))
            if timer is not None:
                kg1, vg1, kpos1 = ref.gather_pool(kp, vp, tab1)
                vis = (kpos1[:, None, :] >= 0) & (kpos1[:, None, :] <= qpos[:, :, None])
                n_keys = ((kpos1 >= 0) & (kpos1 < start + c)).sum().item()
                flops = 4.0 * hd * h * vis.sum().item()
                byts = 2 * n_keys * hkv * hd * kp.element_size() + nbytes(qc, qpos, tab1, qc)
                lmask = vis[:, None]
                qx1, kx1, vx1 = qc.transpose(1, 2), kg1.transpose(1, 2), vg1.transpose(1, 2)
                rec.update(ms=timer(fn), plain_ms=timer(plain),
                           library_ms=timer(lambda: F.scaled_dot_product_attention(
                               qx1, kx1, vx1, attn_mask=lmask, enable_gqa=True)),
                           flops=flops, bytes=byts, **bound(flops, byts, dn))
            emit(rec)
            if dn == "bfloat16" and start == 384:
                results["paged_prefill_attention"] = rec
        # spans of the kernel tests' table at fixed starts, forced plans
        err = 0.0
        for b_, c_, h_, hkv_, hd_, bs_, entries_, window, start, n_split in PP_SPAN_CASES:
            kp_, vp_, tab_, t_ = span_case(np, srng, b_, c_, hkv_, hd_, bs_, entries_, start)
            q = cuda(srng.standard_normal((b_, c_, h_, hd_), dtype=np.float32), dtype)
            qpos = t_[:, None] - np.arange(c_)[::-1][None, :]
            qpos = np.where(qpos >= 0, qpos, -1).astype(np.int32)
            kp_, vp_, tab_, qp = cuda(kp_, dtype), cuda(vp_, dtype), dev_i(tab_), dev_i(qpos)
            ns = n_split if dn == "bfloat16" else 1
            got = paged_prefill_attention_cuda(q, kp_, vp_, tab_, qp, window=window, n_split=ns)
            again = paged_prefill_attention_cuda(q, kp_, vp_, tab_, qp, window=window,
                                                 n_split=ns)
            want = ref.paged_prefill_attention(q, kp_, vp_, tab_, qp, window=window)
            torch.cuda.synchronize()
            case = (b_, c_, h_, hkv_, hd_, bs_, window, start, ns)
            require(torch.equal(got, again), f"paged_prefill_attention {case}: two calls differ")
            require(bool(torch.all(got[qp < 0] == 0)),
                    f"paged_prefill_attention {case}: a padded row is not 0")
            err = max(err, check("paged_prefill_attention", got[qp >= 0], want[qp >= 0], dn,
                                 case))
        emit({"phase": "kernel", "name": "paged_prefill_attention", "dtype": dn,
              "cases": "PP_SPAN_CASES, forced split plans", "max_abs_err": err,
              "tol": TOL[dn]})
    return results


# ---------------------------------------------------------------------------
# the RG-LRU hybrid's kernels: the linear scan, and attention at head_dim 256
# ---------------------------------------------------------------------------

LS_CASES = [(1, 32, 16), (2, 64, 64), (1, 100, 200), (3, 256, 128)]   # tests/test_kernels.py
# ragged shapes: one step, around both default spans (32 and 128 steps),
# C not a multiple of the 32-channel tile or of 4; "resets": a = 0 at
# chosen steps and a run of 1e-12 whose slice products underflow
LS_EDGE_CASES = [(2, 1, 33, None), (2, 31, 200, None), (8, 33, 4096, None),
                 (1, 127, 4100, None), (1, 129, 4100, None), (2, 300, 200, "resets"),
                 (8, 300, 4096, "resets")]
# the shapes the RG-LRU prefill gives the scan: recurrentgemma-9b's lru_width
# 4096, 8 slots at S=512 (the table row), the engine's admission and
# re-prefill lengths, one slot, and bf16
LS_TIMED = [(8, 512, 4096, "float32"), (8, 463, 4096, "float32"), (8, 559, 4096, "float32"),
            (1, 512, 4096, "float32"), (1, 4096, 4096, "float32"), (8, 512, 4096, "bfloat16")]
LS_NO_LIBRARY = ("no single PyTorch call computes a diagonal linear recurrence; "
                 "a cumprod/cumsum form underflows where the decay products vanish")


def ls_inputs(torch, np, rng, dtype, b, s, c, variant=None):
    a = rng.uniform(0.5, 1.0, size=(b, s, c)).astype(np.float32)
    if variant == "resets":
        a[:, [32, 41, 64, 130]] = 0.0
        a[:, 96:112] = 1e-12
    cuda = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to("cuda", dtype)
    return (cuda(a), cuda(rng.standard_normal((b, s, c), dtype=np.float32)),
            cuda(rng.standard_normal((b, c), dtype=np.float32)))


def ls_check(torch, a, x, h0, dn, case) -> float:
    """linear_scan twice (bitwise equal) against its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.linear_scan import linear_scan_cuda
    got, again = linear_scan_cuda(a, x, h0), linear_scan_cuda(a, x, h0)
    want = ref.linear_scan(a, x, h0)
    torch.cuda.synchronize()
    require(all(torch.equal(u, v) for u, v in zip(got, again)),
            f"linear_scan {case}: two calls differ")
    return max(check("linear_scan", got[0], want[0], dn, case),
               check("linear_scan", got[1], want[1], dn, case))


def hybrid_kernel_phase(torch, np, quick: bool):
    """linear_scan over the case tables (with and without h0; every call
    twice, bitwise equal) and at ``LS_TIMED``'s shapes, a graph replay
    at the serving shape; flash attention at B=8 S=512 H=16 Hkv=1 hd=256
    and across a local window (S=2560, window 2048); ring decode
    attention at B=8 W=768 and on a wrapped ring of width 2048 with
    window 2048."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.linear_scan import linear_scan_cuda, scan_plan

    rng = np.random.default_rng(3)
    timer = None if quick else Timer(torch)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        err = 0.0
        for b, s, c, variant in [case + (None,) for case in LS_CASES] + LS_EDGE_CASES:
            a, x, h0 = ls_inputs(torch, np, rng, dtype, b, s, c, variant)
            for init in (h0, None):
                err = max(err, ls_check(torch, a, x, init, dn,
                                        (b, s, c, variant, init is not None)))
        emit({"phase": "kernel", "name": "linear_scan", "dtype": dn,
              "cases": "LS_CASES and LS_EDGE_CASES with and without h0, twice bitwise equal",
              "max_abs_err": err, "tol": TOL[dn]})
    scan = None
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for b, s, c, dn in LS_TIMED:
        a, x, _ = ls_inputs(torch, np, rng, getattr(torch, dn), b, s, c)
        case = f"B={b} S={s} C={c} h0=None"
        v, w, l = scan_plan(b, c, getattr(torch, dn))
        rec = {"phase": "kernel", "name": "linear_scan", "dtype": dn, "case": case,
               "plan": {"V": v, "W": w, "L": l, "span": w * l, "tile": 32 * v,
                        "blocks": b * -(-c // (32 * v)), "sms": n_sm},
               "max_abs_err": ls_check(torch, a, x, None, dn, case), "tol": TOL[dn]}
        if scan is None:
            rec["graph_replay"] = graph_check(torch, "linear_scan",
                                              lambda: linear_scan_cuda(a, x)[0])
        if timer is not None:
            flops = 2.0 * b * s * c
            byts = 3 * nbytes(a) + b * c * a.element_size()      # a, x, h, h_last
            rec.update(ms=timer(lambda: linear_scan_cuda(a, x)),
                       plain_ms=timer(lambda: ref.linear_scan(a, x), iters=5, warmup=1),
                       library_ms=None, library=LS_NO_LIBRARY, flops=flops, bytes=byts,
                       **bound(flops, byts, dn))
        emit(rec)
        scan = scan or rec
        del a, x

    h, hkv, hd = 16, 1, 256                   # recurrentgemma-9b's local attention
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for b, s, window in ((8, 512, 0), (2, 2560, 2048)):
            q, k, v, seg = flash_inputs(torch, np, rng, dtype, b, s, h, hkv, hd)
            case = f"B={b} S={s} H={h} Hkv={hkv} hd={hd} window={window}"
            got = flash_attention_cuda(q, k, v, seg, causal=True, window=window)
            want = ref.flash_attention(q, k, v, segment_ids=seg, causal=True, window=window)
            torch.cuda.synchronize()
            rec = {"phase": "kernel", "name": "flash_attention", "dtype": dn, "case": case,
                   "max_abs_err": check("flash_attention", got, want, dn, case),
                   "tol": TOL[dn]}
            del want
            if timer is not None and dn == "bfloat16" and s == 512:
                mask = flash_mask(torch, seg, s, window)
                flops = 4.0 * hd * mask.sum().item() * h
                byts = nbytes(q, k, v, seg, got)
                qx, kx, vx = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                rec.update(
                    ms=timer(lambda: flash_attention_cuda(q, k, v, seg, causal=True)),
                    plain_ms=timer(lambda: ref.flash_attention(q, k, v, segment_ids=seg)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)),
                    flops=flops, bytes=byts, **bound(flops, byts, dn))
            emit(rec)
        for b, w, window in ((8, 768, 0), (8, 2048, 2048)):
            q, kc, vc, pos, t = decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, w)
            case = f"B={b} W={w} H={h} Hkv={hkv} hd={hd} window={window} t<{2 * w}"
            got = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            again = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            want = ref.decode_attention(q, kc, vc, pos, t, window=window)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"decode_attention {case}: two calls differ")
            rec = {"phase": "kernel", "name": "decode_attention", "dtype": dn, "case": case,
                   "max_abs_err": check("decode_attention", got, want, dn, case),
                   "tol": TOL[dn]}
            if dn == "bfloat16" and w == 768:
                rec["graph_replay"] = decode_graph_check(torch, q, kc, vc, pos, t)
            if timer is not None and dn == "bfloat16" and w == 768:
                valid = decode_mask(pos, t, window)
                n_valid = valid.sum().item()
                flops = 4.0 * hd * h * n_valid
                byts = 2 * n_valid * hkv * hd * kc.element_size() + nbytes(pos, t, q, got)
                qx, kx, vx = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
                mask = valid[:, None, None, :]
                rec.update(
                    ms=timer(lambda: decode_attention_cuda(q, kc, vc, pos, t)),
                    plain_ms=timer(lambda: ref.decode_attention(q, kc, vc, pos, t)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)),
                    flops=flops, bytes=byts, **bound(flops, byts, dn))
            emit(rec)
        decode_edge_check(torch, np, dtype, HYBRID_DECODE_EDGE_CASES,
                          "HYBRID_DECODE_EDGE_CASES", seed=13)
    return {"linear_scan": scan}


# ---------------------------------------------------------------------------
# the paged kernels at the hybrid's local attention, and verify spans
# ---------------------------------------------------------------------------

# recurrentgemma-9b's local attention, and its width (the fused tail's wo)
HD256 = dict(h=16, hkv=1, hd=256, window=2048, d_model=4096)


def window_pool(np, rng, b, hkv, hd, bs, entries, t_lo, t_hi):
    """A pool whose slots each hold their own blocks, bound up to a t in
    [t_lo, t_hi): past the window when t_lo > window."""
    n_pool = b * entries
    kp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    perm = rng.permutation(n_pool)
    t = rng.integers(t_lo, t_hi, size=b).astype(np.int32)
    tables = np.full((b, entries), -1, np.int32)
    for i in range(b):
        nb = int(t[i]) // bs + 1
        tables[i, :nb] = perm[i * entries:i * entries + nb]
    return kp, vp, tables, t


def span_attention_cost(torch, kp, tab, qpos, h, hd, window):
    """(flops, K/V bytes, SDPA's bool mask (B, 1, C, E bs), gathered k, v)
    of a paged span: each visible (query, key) pair's 4 hd flops a head,
    each visible pool row read once."""
    from repro_torch.kernels import ref
    kg, vg, kpos = ref.gather_pool(kp, kp, tab)
    qp = qpos[:, :, None]
    vis = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qp) & (qp >= 0)
    if window:
        vis &= kpos[:, None, :] > qp - window
    rows = vis.any(dim=1)                                  # (B, E bs): rows some query sees
    hkv = kp.shape[2]
    return (4.0 * hd * h * vis.sum().item(),
            2 * rows.sum().item() * hkv * hd * kp.element_size(), vis[:, None], kg)


def hd256_fused_tail(torch, np, rng, dtype, timer, results) -> None:
    """The fused decode tail at the hybrid's widths (head_dim 256, 16 query
    heads over one kv head, a window of 2048, ``wo`` 4096 x 4096): B = 8
    slots at t in [2304, 2560), 3 slots whose window opens inside a tile
    and 4 short histories; at forced split plans, every call twice bitwise
    equal.  In bf16 at B = 8, timed beside the bound, the plain version,
    SDPA plus ``matmul(wo)`` (the library) and the unfused route (paged
    decode plus ``matmul(wo)``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_decode_tail as ft
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda

    h, hkv, hd, window = HD256["h"], HD256["hkv"], HD256["hd"], HD256["window"]
    dm = HD256["d_model"]
    dn = str(dtype).split(".")[1]
    code = 1 if dtype == torch.bfloat16 else 0
    cuda = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", dtype)
    dev_i = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    wo = cuda(rng.standard_normal((h * hd, dm), dtype=np.float32) * (h * hd) ** -0.5)
    for b, bs, entries, t_lo, t_hi in ((8, 16, 160, 2304, 2560), (3, 32, 80, 2049, 2050),
                                       (4, 16, 40, 100, 600)):
        kp, vp, tab, t = window_pool(np, rng, b, hkv, hd, bs, entries, t_lo, t_hi)
        q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32))
        kp, vp, tab, t = cuda(kp), cuda(vp), dev_i(tab), dev_i(t)
        case = (f"B={b} H={h} Hkv={hkv} hd={hd} D={dm} bs={bs} E={entries} t in [{t_lo}, "
                f"{t_hi}) window={window}")
        want = ref.fused_decode_tail(q, kp, vp, wo, tab, t, window=window)
        most = min(-(-entries * bs // 16), ft._capacity(code, h, hkv, hd, q.device) // b)
        err = 0.0
        for n_split in sorted({1, 2, most}) + [None]:
            got = ft.fused_decode_tail_split(q, kp, vp, wo, tab, t, n_split, window=window)
            again = ft.fused_decode_tail_split(q, kp, vp, wo, tab, t, n_split, window=window)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"fused_decode_tail {case} n_split={n_split}: two calls differ")
            err = max(err, check_scaled("fused_decode_tail", got, want, dn,
                                        f"{case} n_split={n_split}"))
        rec = {"phase": "kernel", "name": "fused_decode_tail", "dtype": dn, "case": case,
               "split_plans": "1, 2, most, wrapper's", "max_abs_err": err, "tol": TOL[dn],
               "tol_of": "the output's largest magnitude"}
        if timer is not None and dn == "bfloat16" and b == 8:
            fn = lambda: ft.fused_decode_tail_cuda(q, kp, vp, wo, tab, t, window=window)
            flops, kv_bytes, vis, kg = span_attention_cost(torch, kp, tab, t[:, None], h, hd,
                                                           window)
            _, vg, _ = ref.gather_pool(kp, vp, tab)
            qx, kx, vx = q[:, :, None, :], kg.transpose(1, 2), vg.transpose(1, 2)
            flops += 2.0 * b * h * hd * dm
            byts = kv_bytes + nbytes(q, tab, t, wo) + b * dm * q.element_size()
            rec.update(
                ms=timer(fn),
                plain_ms=timer(lambda: ref.fused_decode_tail(q, kp, vp, wo, tab, t,
                                                             window=window)),
                library_ms=timer(lambda: torch.matmul(F.scaled_dot_product_attention(
                    qx, kx, vx, attn_mask=vis, enable_gqa=True).reshape(b, h * hd), wo)),
                library="scaled_dot_product_attention (bool mask) + matmul(wo)",
                paged_decode_plus_matmul_ms=timer(lambda: torch.matmul(
                    paged_decode_attention_cuda(q, kp, vp, tab, t, window=window)
                    .reshape(b, h * hd), wo)),
                flops=flops, bytes=byts, kv_bytes=kv_bytes, **bound(flops, byts, dn))
            results["fused_decode_tail"] = rec
        emit(rec)


def hd256_kernel_phase(torch, np, quick: bool):
    """paged_decode_attention, paged_prefill_attention and the fused decode
    tail at the hybrid's local attention (head_dim 256, 16 query heads
    over one kv head, a window of 2048; the tail's ``wo`` 4096 x 4096)
    over pools past the window, in bf16 and f32 against their plain
    versions, at forced split plans, every call twice bitwise equal;
    timed in bf16 beside the bound, the plain version and SDPA (bool
    mask; plus ``matmul(wo)`` for the tail).  Then the verify spans of
    speculative decoding (C = k queries a slot) at areal-qwen-1.5b's
    widths, timed."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda

    rng = np.random.default_rng(25)
    timer = None if quick else Timer(torch)
    h, hkv, hd, window = HD256["h"], HD256["hkv"], HD256["hd"], HD256["window"]
    cuda = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", dt)
    dev_i = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        code = 1 if dtype == torch.bfloat16 else 0
        # ---- decode: B = 8 slots at t in [2304, 2560), and short histories
        for b, bs, entries, t_lo, t_hi in ((8, 16, 160, 2304, 2560), (3, 32, 80, 2049, 2050),
                                           (4, 16, 40, 100, 600)):
            kp, vp, tab, t = window_pool(np, rng, b, hkv, hd, bs, entries, t_lo, t_hi)
            q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
            kp, vp, tab, t = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(t)
            case = (f"B={b} H={h} Hkv={hkv} hd={hd} bs={bs} E={entries} t in [{t_lo}, {t_hi}) "
                    f"window={window}")
            want = ref.paged_decode_attention(q, kp, vp, tab, t, window=window)
            most = min(-(-entries * bs // 16), pd._capacity(code, hd, q.device) // b)
            err = 0.0
            for n_split in sorted({1, 2, most}) + [None]:
                got = pd.paged_decode_attention_split(q, kp, vp, tab, t, n_split, window=window)
                again = pd.paged_decode_attention_split(q, kp, vp, tab, t, n_split,
                                                        window=window)
                torch.cuda.synchronize()
                require(torch.equal(got, again),
                        f"paged_decode_attention {case} n_split={n_split}: two calls differ")
                err = max(err, check("paged_decode_attention", got, want, dn,
                                     f"{case} n_split={n_split}"))
            rec = {"phase": "kernel", "name": "paged_decode_attention", "dtype": dn,
                   "case": case, "split_plans": "1, 2, most, wrapper's", "max_abs_err": err,
                   "tol": TOL[dn]}
            if timer is not None and dn == "bfloat16" and b == 8:
                fn = lambda: pd.paged_decode_attention_cuda(q, kp, vp, tab, t, window=window)
                flops, kv_bytes, vis, kg = span_attention_cost(torch, kp, tab, t[:, None], h, hd,
                                                               window)
                _, vg, _ = ref.gather_pool(kp, vp, tab)
                qx, kx, vx = q[:, :, None, :], kg.transpose(1, 2), vg.transpose(1, 2)
                rec.update(ms=timer(fn),
                           plain_ms=timer(lambda: ref.paged_decode_attention(
                               q, kp, vp, tab, t, window=window)),
                           library_ms=timer(lambda: F.scaled_dot_product_attention(
                               qx, kx, vx, attn_mask=vis, enable_gqa=True)),
                           flops=flops, bytes=kv_bytes + nbytes(q, tab, t, q),
                           **bound(flops, kv_bytes + nbytes(q, tab, t, q), dn))
                results["paged_decode_attention"] = rec
            emit(rec)
        # ---- prefill: a chunk of 128 past the window, and verify spans of 3
        for b, c, bs, entries, t_lo, t_hi in ((1, 128, 16, 160, 2431, 2432),
                                              (4, 3, 16, 160, 2304, 2560),
                                              (2, 70, 32, 80, 2100, 2300)):
            kp, vp, tab, t = window_pool(np, rng, b, hkv, hd, bs, entries, t_lo, t_hi)
            qpos = t[:, None] - np.arange(c)[::-1][None, :]
            qpos = np.where(qpos >= 0, qpos, -1).astype(np.int32)
            q = cuda(rng.standard_normal((b, c, h, hd), dtype=np.float32), dtype)
            kp, vp, tab, qp = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(qpos)
            case = (f"B={b} C={c} H={h} Hkv={hkv} hd={hd} bs={bs} E={entries} q_pos ending in "
                    f"[{t_lo}, {t_hi}) window={window}")
            want = ref.paged_prefill_attention(q, kp, vp, tab, qp, window=window)
            err = 0.0
            for n_split in ((None, 1, 3, 8) if dn == "bfloat16" else (None,)):
                got = paged_prefill_attention_cuda(q, kp, vp, tab, qp, window=window,
                                                   n_split=n_split)
                again = paged_prefill_attention_cuda(q, kp, vp, tab, qp, window=window,
                                                     n_split=n_split)
                torch.cuda.synchronize()
                require(torch.equal(got, again),
                        f"paged_prefill_attention {case} n_split={n_split}: two calls differ")
                err = max(err, check("paged_prefill_attention", got, want, dn,
                                     f"{case} n_split={n_split}"))
            rec = {"phase": "kernel", "name": "paged_prefill_attention", "dtype": dn,
                   "case": case, "max_abs_err": err, "tol": TOL[dn]}
            if timer is not None and dn == "bfloat16" and c in (128, 3):
                fn = lambda: paged_prefill_attention_cuda(q, kp, vp, tab, qp, window=window)
                flops, kv_bytes, vis, kg = span_attention_cost(torch, kp, tab, qp, h, hd, window)
                _, vg, _ = ref.gather_pool(kp, vp, tab)
                qx, kx, vx = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
                byts = kv_bytes + nbytes(q, qp, tab, q)
                rec.update(ms=timer(fn),
                           plain_ms=timer(lambda: ref.paged_prefill_attention(
                               q, kp, vp, tab, qp, window=window)),
                           library_ms=timer(lambda: F.scaled_dot_product_attention(
                               qx, kx, vx, attn_mask=vis, enable_gqa=True)),
                           flops=flops, bytes=byts, **bound(flops, byts, dn))
                results["paged_prefill_attention" if c == 128 else "verify_hd256"] = rec
            emit(rec)
        hd256_fused_tail(torch, np, rng, dtype, timer, results)
    # ---- verify spans at areal-qwen-1.5b's widths: C = 4 queries for 8 slots
    if timer is not None:
        b, c, h, hkv, hd, bs, entries = 8, 4, 12, 2, 128, 16, 48
        kp, vp, tab, t = window_pool(np, rng, b, hkv, hd, bs, entries, 259, 768)
        qpos = (t[:, None] - np.arange(c)[::-1][None, :]).astype(np.int32)   # ending at t
        q = cuda(rng.standard_normal((b, c, h, hd), dtype=np.float32), torch.bfloat16)
        kp, vp = cuda(kp, torch.bfloat16), cuda(vp, torch.bfloat16)
        tab, qp = dev_i(tab), dev_i(qpos)
        case = f"B={b} C={c} H={h} Hkv={hkv} hd={hd} bs={bs} E={entries} spans ending in [259, 768)"
        fn = lambda: paged_prefill_attention_cuda(q, kp, vp, tab, qp)
        got, want = fn(), ref.paged_prefill_attention(q, kp, vp, tab, qp)
        torch.cuda.synchronize()
        flops, kv_bytes, vis, kg = span_attention_cost(torch, kp, tab, qp, h, hd, 0)
        _, vg, _ = ref.gather_pool(kp, vp, tab)
        qx, kx, vx = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
        byts = kv_bytes + nbytes(q, qp, tab, q)
        rec = {"phase": "kernel", "name": "paged_prefill_attention", "dtype": "bfloat16",
               "case": case, "tol": TOL["bfloat16"],
               "max_abs_err": check("paged_prefill_attention", got, want, "bfloat16", case),
               "ms": timer(fn), "plain_ms": timer(lambda: ref.paged_prefill_attention(
                   q, kp, vp, tab, qp)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   qx, kx, vx, attn_mask=vis, enable_gqa=True)),
               "flops": flops, "bytes": byts, **bound(flops, byts, "bfloat16")}
        emit(rec)
        results["verify_hd128"] = rec
    return results


# ---------------------------------------------------------------------------
# small model: kernels on the card against the plain path on the CPU
# ---------------------------------------------------------------------------

def paged_steps(torch, np, m, toks, length, tok):
    """The paged LM methods on the small model: a monolithic prefill of
    two rows sharing their first block, a third row ingested in spans of
    8, then decode steps unfused and fused with one row held back.
    Returns every logits tensor and the final pool and positions."""
    dev = toks.device
    bs, n_blocks = 4, 24
    tables = torch.tensor([[3, 7, 1, 9, 12, 13, 20, 21],
                           [3, 5, 11, 14, 15, 16, 22, -1],
                           [2, 4, 6, 8, 10, 17, 18, 19]], dtype=torch.int32, device=dev)
    cache = m.init_paged_cache(3, n_blocks, bs)
    s = toks.shape[1]
    rows = toks[:2].clone()
    rows[1, :bs] = rows[0, :bs]
    e = torch.arange(s, device=dev) // bs
    dest = tables[:2].gather(1, e[None].expand(2, -1).long())
    dest[1, :bs] = -1                                   # slot 1 shares slot 0's block
    logits, cache = m.prefill_paged(rows, cache, dest, torch.tensor([0, 1], device=dev),
                                    length=length[:2])
    out = [logits]
    c = 8
    for begin in range(0, s, c):
        span = toks[2:3, begin:begin + c]
        d = tables[2:3].gather(1, (torch.arange(begin, begin + c, device=dev) // bs)[None].long())
        logits, cache = m.prefill_chunk_paged(
            span, cache, tables[2:3], d, torch.tensor([2], device=dev),
            torch.tensor([begin], dtype=torch.int32, device=dev),
            torch.tensor([c], dtype=torch.int32, device=dev))
        out.append(logits)
    for step in range(4):
        active = torch.tensor([True, step >= 2, True], device=dev)
        logits, cache = m.decode_step_paged(tok[:3], cache, tables, active,
                                            fused_tail=step % 2 == 1)
        out.append(logits)
    return [x.float().cpu() for x in out] + [cache["k_pool"].cpu(), cache["t"].cpu()]


def small_phase(torch, np):
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.data import tokenizer
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                              vocab_size=tokenizer.VOCAB_SIZE)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    b, s, max_len = 4, 24, 32
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, s)))
    length = torch.tensor([24, 17, 9, 1], dtype=torch.int32)
    out = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        dev = m.device
        cache = m.init_cache(b, max_len)
        logits, cache = m.prefill(toks.to(dev), cache, length=length.to(dev))
        steps = [logits]
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b,))) if name == "cpu" \
            else out["tok"]
        out["tok"] = tok
        active = torch.tensor([True, True, False, True], device=dev)
        for _ in range(4):
            logits, cache = m.decode_step(tok.to(dev), cache, active)
            steps.append(logits)
        out[name] = [x.float().cpu() for x in steps] + [cache["k"].cpu(), cache["pos"].cpu()]
        out[name] += paged_steps(torch, np, m, toks.to(dev), length.to(dev), tok.to(dev))
    tol = 1e-3   # f32 on both sides; other libraries, other summation orders
    err = 0.0
    for a, c in zip(out["cpu"], out["cuda"]):
        if a.dtype == torch.int32:
            if not torch.equal(a, c):
                raise AssertionError("cache positions differ between the card and the CPU")
            continue
        e = (a - c).abs().max().item()
        if not (e <= tol + tol * a.abs().max().item()):
            raise AssertionError(f"small model: card vs CPU max abs err {e}")
        err = max(err, e)
    emit({"phase": "small", "config": cfg.name, "max_abs_err": err, "tol": tol})


def small_hybrid_phase(torch, np):
    """The reduced RG-LRU hybrid, card against CPU: pattern (rec, rec,
    local) with a remainder (5 layers), head_dim 256 over one kv head, a
    local window of 8 under a prompt of 24; ring prefill, then decode
    steps with one row held back.  Compares logits, the local layers'
    K/V and positions and the recurrent layers' h and conv state."""
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.data import tokenizer
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")),
                              vocab_size=tokenizer.VOCAB_SIZE, n_layers=5,
                              block_pattern=("rec", "rec", "local"), n_heads=2, n_kv_heads=1,
                              head_dim=256, d_model=128, d_ff=256, lru_width=128,
                              local_window=8)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    require(gpu.n_rec == 4 and gpu.n_attn == 1, f"layer kinds {gpu.kinds}")
    rng = np.random.default_rng(4)
    b, s, max_len = 4, 24, 32
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, s)))
    length = torch.tensor([24, 17, 9, 1], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b,)))
    out = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        dev = m.device
        cache = m.init_cache(b, max_len)
        logits, cache = m.prefill(toks.to(dev), cache, length=length.to(dev))
        steps = [logits]
        active = torch.tensor([True, True, False, True], device=dev)
        for _ in range(4):
            logits, cache = m.decode_step(tok.to(dev), cache, active)
            steps.append(logits)
        out[name] = [x.float().cpu() for x in steps] + [
            cache[k].cpu() for k in ("k", "v", "pos", "h", "conv", "t")]
    tol = 1e-3   # f32 on both sides; other libraries, other summation orders
    err = 0.0
    for a, c in zip(out["cpu"], out["cuda"]):
        if a.dtype == torch.int32:
            require(torch.equal(a, c), "cache positions differ between the card and the CPU")
            continue
        e = (a - c).abs().max().item()
        require(e <= tol + tol * a.abs().max().item(), f"small hybrid: card vs CPU max abs err {e}")
        err = max(err, e)
    emit({"phase": "small", "config": f"{cfg.name} {cfg.block_pattern} x {cfg.n_layers}",
          "head_dim": cfg.head_dim, "n_kv_heads": cfg.n_kv_heads,
          "local_window": cfg.local_window, "max_abs_err": err, "tol": tol})


def small_configs():
    """The reduced models of the small phases: areal-qwen-1.5b's with 3
    layers (so a draft runs 2 of 3 units), and the RG-LRU hybrid of
    ``small_hybrid_phase`` (head_dim 256 over one kv head, a local window
    of 8)."""
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.data import tokenizer

    dense = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                                vocab_size=tokenizer.VOCAB_SIZE, n_layers=3)
    hybrid = dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")),
                                 vocab_size=tokenizer.VOCAB_SIZE, n_layers=5,
                                 block_pattern=("rec", "rec", "local"), n_heads=2, n_kv_heads=1,
                                 head_dim=256, d_model=128, d_ff=256, lru_width=128,
                                 local_window=8)
    return {"dense": dense, "hybrid": hybrid}


def small_spec_phase(torch, np):
    """Speculative decoding on the reduced models in f32, card against
    CPU: for the dense model and the hybrid, ring and paged (blocks of 4),
    prefill chunk 0 and 3, the spec engine (k = 3) equals the plain
    engine token for token on the card, and equals the spec engine on
    the CPU token for token; every plain engine equals the ring engine
    with monolithic prefill.  Paged rounds run the paged prefill kernel
    (verify, commit) and the paged decode kernel (drafts), the hybrid's
    at head_dim 256; ring rounds the ring decode kernel."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.data import tokenizer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    rng = np.random.default_rng(6)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, tokenizer.VOCAB_SIZE, size=int(n)).tolist()}
            for i, n in enumerate(rng.integers(9, 25, size=6))]
    cells = []
    ops.reset_launches()
    for family, cfg in small_configs().items():
        cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        gpu = build_model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        yardstick = None        # the ring engine's, monolithic prefill
        for cache in ("ring", "paged"):
            for chunk in (0, 3):
                kw = dict(n_slots=4, prompt_len=24, max_gen_len=16, seed=3, temperature=0.0,
                          cache=cache, block_size=4, prefill_chunk=chunk,
                          rng="request" if chunk else "auto")
                out, stats = {}, None
                for name, m, extra in (("plain", gpu, {}), ("spec", gpu, {"spec_decode": 3}),
                                       ("spec_cpu", cpu, {"spec_decode": 3})):
                    eng = RolloutEngine(m, EngineConfig(**kw, **extra), device=m.device)
                    done, pending, steps = {}, list(reqs), 0
                    while len(done) < len(reqs):      # 6 requests through 4 slots
                        pending = pending[eng.admit(pending):]
                        for f in eng.step():
                            done[f.rid] = f
                        steps += 1
                        require(steps < 500, f"small_spec: requests did not finish")
                    out[name] = {r: f.response for r, f in done.items()}
                    if name == "spec":
                        stats = eng.stats()
                cell = f"{family}/{cache}/chunk{chunk}"
                require(out["spec"] == out["plain"], f"small_spec {cell}: spec != plain")
                require(out["spec"] == out["spec_cpu"], f"small_spec {cell}: card != CPU")
                require(stats["spec_rounds"] > 0, f"small_spec {cell}: no round")
                yardstick = yardstick or out["plain"]
                require(out["plain"] == yardstick,
                        f"small_spec {cell}: the plain engine differs from the ring's monolithic")
                cells.append({"cell": cell, "spec_rounds": stats["spec_rounds"],
                              "draft_acceptance_rate": stats["draft_acceptance_rate"],
                              "accepted_tokens_per_step": stats["accepted_tokens_per_step"]})
    launches = dict(ops.LAUNCHES)
    for name in ("paged_decode_attention", "paged_prefill_attention", "decode_attention",
                 "linear_scan"):
        require(launches[name] > 0, f"small_spec: {name} never launched")
    emit({"phase": "small_spec", "dtype": "float32", "cells": cells,
          "spec_equals_plain": True, "card_equals_cpu": True,
          "plain_equals_ring_monolithic": True, "launches": launches})


SMALL_GW = dict(n_slots=4, prompt_len=24, max_gen_len=24, seed=0, cache="paged", block_size=4,
                evict="lru", prefill_chunk=8, fused_decode="fused")


def host_noise(torch, seed: int):
    """Gumbel noise of request ``rid``'s draw ``draw`` from a host
    generator seeded as the ``"request"`` scheme keys it: the same draws
    for an engine on any device."""
    from repro_torch.core.rollout import request_seed
    tiny = torch.finfo(torch.float32).tiny

    def noise(rid, draw, shape):
        g = torch.Generator().manual_seed(request_seed(seed, rid, draw))
        return -torch.log(-torch.log(torch.rand(shape, generator=g).clamp_min(tiny)))
    return noise


def small_gateway_run(torch, np, model, urgent: bool):
    """6 requests at priority 2 through the paged gateway (4 slots), and
    with ``urgent`` 2 more at priority 0 after 6 ticks, which preempt.
    Returns (tokens of the 6 by rid, gateway stats, engine, probe)."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.data import tokenizer
    from repro_torch.serve import Gateway

    engine = RolloutEngine(model, EngineConfig(**SMALL_GW), device=model.device,
                           noise=host_noise(torch, SMALL_GW["seed"]))
    probe = GatewayProbe(engine)
    gw = Gateway(engine)
    rng = np.random.default_rng(0)
    prompt = lambda: rng.integers(3, tokenizer.VOCAB_SIZE, size=int(rng.integers(9, 20))).tolist()
    rids = [gw.submit(prompt(), priority=2) for _ in range(6)]
    urgents = [prompt() for _ in range(2)]
    for _ in range(6):
        gw.pump()
    if urgent:
        for p in urgents:
            gw.submit(p, priority=0, sla=20)
    gw.run_until_idle()
    return {r: gw.drain(r)["tokens"] for r in rids}, gw.stats(), engine, probe


def small_gateway_phase(torch, np):
    """``small_gateway``: the reduced dense model in f32 (the ``small``
    phase's weights) through the paged gateway, blocks of 4, LRU, chunked
    prefill of 8, the fused tail, with urgent traffic that preempts and
    its twin without, on the card and on the CPU, each fed the same
    host-drawn Gumbel noise.  Each run's trajectories must be equal
    between the devices, and on the card the preempted run equal to its
    twin token for token (f32: a resumed history is re-ingested by paged
    prefill where decode wrote it first)."""
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.data import tokenizer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                              vocab_size=tokenizer.VOCAB_SIZE)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    runs = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        for urgent in (True, False):
            ops.reset_launches()
            runs[name, urgent] = small_gateway_run(torch, np, m, urgent)
            if name == "cuda":
                _, _, engine, probe = runs[name, urgent]
                require_launches(dict(ops.LAUNCHES), gateway_launches(cfg.n_layers, probe,
                                                                      engine))
    for urgent in (True, False):
        require(runs["cuda", urgent][0] == runs["cpu", urgent][0],
                f"small_gateway (urgent={urgent}): the card's trajectories differ from the CPU's")
    st = runs["cuda", True][1]
    require(st["preemptions"] >= 1 and st["resumes"] == st["preemptions"],
            f"small_gateway: preemptions {st['preemptions']}, resumes {st['resumes']}")
    require(runs["cuda", False][1]["preemptions"] == 0, "small_gateway: the twin preempted")
    require(runs["cuda", True][0] == runs["cuda", False][0],
            "small_gateway: the preempted run differs from its twin on the card")
    emit({"phase": "small", "part": "small_gateway", "config": cfg.name,
          "engine": SMALL_GW, "preemptions": st["preemptions"], "resumes": st["resumes"],
          "tokens": sum(len(t) for t in runs["cuda", True][0].values()),
          "cpu_equals_card": True, "preempted_equals_twin": True})


# ---------------------------------------------------------------------------
# the serving path at full width
# ---------------------------------------------------------------------------

def build_models(torch):
    """areal-qwen-1.5b at full width in bf16: random weights from seed 0,
    and the perturbed policy of version 1 (every weight times 1.01)."""
    from repro_torch.configs import get_model_config
    from repro_torch.models.model import build_model

    cfg = get_model_config("areal-qwen-1.5b")
    t0 = time.perf_counter()
    m0 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    m0.init(torch.Generator(device="cuda").manual_seed(0))
    m1 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p1, p0 in zip(m1.parameters(), m0.parameters()):
            p1.copy_(p0 * 1.01)
    torch.cuda.synchronize()
    return {"cfg": cfg, "m0": m0, "m1": m1, "init_s": time.perf_counter() - t0,
            "params": sum(p.numel() for p in m0.parameters())}


def check_finished(cfg, done, n: int) -> None:
    """Every request finished with finite logprobs <= 0, tokens in the
    vocabulary, and at least one trajectory spans versions 0 and 1."""
    require(len(done) == n, f"finished {len(done)} of {n}")
    require(any(set(f.versions) == {0, 1} for f in done.values()),
            "no trajectory spans versions 0 and 1")
    for f in done.values():
        require(len(f.response) == len(f.logprobs) == len(f.versions) >= 1, f"rid {f.rid}")
        require(all(math.isfinite(x) and x <= 1e-6 for x in f.logprobs),
                f"rid {f.rid}: a logprob is not finite or above 0")
        require(all(0 <= x < cfg.vocab_size for x in f.response),
                f"rid {f.rid}: a token outside the vocabulary")
        require(f.versions == sorted(f.versions), f"rid {f.rid}: versions out of order")


def require_launches(launches, want) -> None:
    for name, n in want.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times, expected {n}")


def count_ingests(engine):
    """Wrap the engine's span ingest so that it counts its calls."""
    calls = {"n": 0}
    ingest_one = engine._ingest_one_chunk

    def counted():
        calls["n"] += 1
        ingest_one()
    engine._ingest_one_chunk = counted
    return calls


def serve_phase(torch, np, models, name: str = "serve", max_gen_len: int = 256,
                interrupt_at: int = 96, min_prompt: int = 256):
    """The ring engine at full width: 8 prompts of ``min_prompt``-512
    tokens, ``max_gen_len`` tokens each at temperature 1, a weight update
    after ``interrupt_at`` decode steps that re-prefills every history
    under version 1.  ``name``: the phase's name in its record."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    n_slots, prompt_len = 8, 512
    # the engine owns its model and copies updates into it: a copy of m0,
    # so that m0 keeps version 0's weights for the phases after this one
    engine = RolloutEngine(copy.deepcopy(m0), EngineConfig(
        n_slots=n_slots, prompt_len=prompt_len, max_gen_len=max_gen_len,
        temperature=1.0, seed=0, dtype=torch.bfloat16))
    rng = np.random.default_rng(0)
    lengths = rng.integers(min_prompt, prompt_len + 1, size=n_slots)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=int(n)).tolist()}
            for i, n in enumerate(lengths)]
    # lazy set-up (cuBLAS handles and heuristics, the allocator's pools)
    # happens once per process: pay it on a throwaway engine, report it
    t0 = time.perf_counter()
    warm = RolloutEngine(m0, EngineConfig(n_slots=n_slots, prompt_len=prompt_len,
                                          max_gen_len=max_gen_len, dtype=torch.bfloat16))
    warm.admit(reqs)
    for _ in range(2):
        warm.step()
    del warm
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    t0 = time.perf_counter()
    admitted = engine.admit(reqs)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    prefill_calls, decode_steps = 1, 0
    done = {}
    step_ms, reprefill_ms = [], None
    while len(done) < n_slots:
        if decode_steps == interrupt_at:
            t0 = time.perf_counter()
            require(engine.update_weights(m1, version=1), "update_weights was deferred")
            torch.cuda.synchronize()
            reprefill_ms = 1e3 * (time.perf_counter() - t0)
            prefill_calls += 1
        t0 = time.perf_counter()
        fin = engine.step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        decode_steps += 1
        for f in fin:
            done[f.rid] = f
        if decode_steps > max_gen_len + 1:
            raise AssertionError("requests did not finish")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require(admitted == n_slots, f"admitted {admitted} of {n_slots}")
    check_finished(cfg, done, n_slots)
    n_layers = cfg.n_layers
    require_launches(launches, {"flash_attention": n_layers * prefill_calls,
                                "decode_attention": n_layers * decode_steps,
                                "paged_decode_attention": 0, "paged_prefill_attention": 0,
                                "fused_decode_tail": 0, "flash_attention_bwd": 0})
    st = engine.stats()
    decode_s = sum(step_ms) / 1e3
    rec = {"phase": name, "model": cfg.name, "params": models["params"],
           "dtype": "bfloat16", "n_slots": n_slots, "prompt_len": prompt_len,
           "max_gen_len": max_gen_len, "prompt_lengths": [int(x) for x in lengths],
           "init_s": models["init_s"],
           "warmup_s": warmup_s,
           "prefill_ms": prefill_ms, "reprefill_ms": reprefill_ms,
           "decode_steps": decode_steps, "prefill_calls": prefill_calls,
           "decode_step_ms_mean": sum(step_ms) / len(step_ms),
           "decode_step_ms_median": sorted(step_ms)[len(step_ms) // 2],
           "decode_step_ms_p95": sorted(step_ms)[int(0.95 * len(step_ms))],
           "generated_tokens_per_s": st["tokens_generated"] / decode_s,
           "peak_memory_gb": peak_gb, "launches": launches, "stats": st,
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done.values())}
    emit(rec)
    return launches, engine, reqs, rec["decode_step_ms_mean"]


def serve_paged_phase(torch, np, models, fused: bool, name: str = ""):
    """The paged engine at full width.  ``fused``: chunked prefill of 128
    tokens and the fused decode tail (phase ``serve_paged``); else
    monolithic paged prefill through flash attention and the unfused
    paged decode (phase ``serve_paged_unfused``).  Two prompts of 256-512
    tokens are each sampled 4 times, so the group's full prompt blocks are
    shared; a weight update after 96 decode steps re-ingests every history
    under version 1.  ``name``: the phase's name in its record."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    name = name or ("serve_paged" if fused else "serve_paged_unfused")
    n_slots, group, max_gen_len, interrupt_at = 8, 4, 256, 96
    ecfg = EngineConfig(n_slots=n_slots, prompt_len=512, max_gen_len=max_gen_len,
                        cache="paged", block_size=16, prefill_chunk=128 if fused else 0,
                        fused_decode="fused" if fused else None, evict="lru",
                        temperature=1.0, seed=0, dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(256, 513, size=n_slots // group)]
    reqs = [{"rid": g * group + k, "prompt_id": g, "answer": None, "prompt": p}
            for g, p in enumerate(prompts) for k in range(group)]

    # lazy set-up of this path (allocator pools, cuBLAS heuristics of its
    # shapes) is paid on a throwaway engine and reported
    t0 = time.perf_counter()
    warm = RolloutEngine(m0, ecfg)
    warm.admit(reqs[:2])
    while warm.stats()["tokens_generated"] < 4:
        warm.step()
    del warm
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    engine = RolloutEngine(copy.deepcopy(m0), ecfg)     # m0 keeps version 0's weights
    ingests = count_ingests(engine)

    ops.reset_launches()
    t_admit = time.perf_counter()
    admitted = engine.admit(reqs)
    torch.cuda.synchronize()
    admit_ms = 1e3 * (time.perf_counter() - t_admit)
    prefill_calls = 0 if fused else 1
    decode_ms, mixed_ms = [], []
    admission_ingest_ms = None if fused else admit_ms
    reingest_ms = t_update = None
    blocks_peak = engine.blocks_in_use()
    done = {}
    while len(done) < n_slots:
        if engine.decode_dispatches == interrupt_at and t_update is None:
            t_update = time.perf_counter()
            require(engine.update_weights(m1, version=1), "update_weights was deferred")
            if not fused:
                torch.cuda.synchronize()
                reingest_ms = 1e3 * (time.perf_counter() - t_update)
                prefill_calls += 1
        n_ingest, n_decode = ingests["n"], engine.decode_dispatches
        t0 = time.perf_counter()
        fin = engine.step()
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t0)
        if ingests["n"] > n_ingest:
            mixed_ms.append(dt)
        elif engine.decode_dispatches > n_decode:
            decode_ms.append(dt)
        if fused and not engine._ingest_queue:
            if admission_ingest_ms is None:
                admission_ingest_ms = 1e3 * (time.perf_counter() - t_admit)
            if t_update is not None and reingest_ms is None:
                reingest_ms = 1e3 * (time.perf_counter() - t_update)
        blocks_peak = max(blocks_peak, engine.blocks_in_use())
        for f in fin:
            done[f.rid] = f
        require(len(decode_ms) + len(mixed_ms) < 3 * max_gen_len, "requests did not finish")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require(admitted == n_slots, f"admitted {admitted} of {n_slots}")
    check_finished(cfg, done, n_slots)
    st = engine.stats()
    require(st["prefix_reused_blocks"] > 0, "no prompt block was shared")
    L = cfg.n_layers
    decode_steps = st["decode_dispatches"]
    if fused:
        want = {"paged_prefill_attention": L * ingests["n"],
                "fused_decode_tail": L * decode_steps, "flash_attention": 0,
                "decode_attention": 0, "paged_decode_attention": 0}
    else:
        want = {"flash_attention": L * prefill_calls, "paged_decode_attention": L * decode_steps,
                "paged_prefill_attention": 0, "fused_decode_tail": 0, "decode_attention": 0}
    want["flash_attention_bwd"] = 0
    require_launches(launches, want)
    steps = decode_ms + mixed_ms
    rec = {"phase": name, "model": cfg.name, "dtype": "bfloat16",
           "engine": {k: v for k, v in vars(ecfg).items() if k not in ("dtype", "continuation")},
           "prompt_lengths": [len(p) for p in prompts], "group": group,
           "warmup_s": warmup_s, "admit_ms": admit_ms,
           "admission_ingest_ms": admission_ingest_ms, "reingest_ms": reingest_ms,
           "ingest_calls": ingests["n"], "prefill_calls": prefill_calls,
           "decode_steps": decode_steps, "steps": len(steps),
           "decode_only_step_ms_mean": sum(decode_ms) / len(decode_ms),
           "decode_only_step_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
           "steps_with_ingest": len(mixed_ms),
           "step_with_ingest_ms_mean": sum(mixed_ms) / len(mixed_ms) if mixed_ms else None,
           "generated_tokens_per_s": st["tokens_generated"] / (sum(steps) / 1e3),
           "peak_memory_gb": peak_gb, "blocks_in_use_peak": blocks_peak,
           "pool_blocks": engine.n_blocks, "launches": launches, "stats": st,
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done.values())}
    emit(rec)
    return launches, engine, reqs, rec["decode_only_step_ms_mean"]


# ---------------------------------------------------------------------------
# self-speculative decoding at full width
# ---------------------------------------------------------------------------

def drive_timed(torch, engine, reqs, interrupt=None):
    """Admit ``reqs`` and step to the end, timing each step (host clock to
    a synchronise).  ``interrupt(engine)`` runs before each step.
    Returns (finished by rid, step ms, ms of each speculative round: its
    draft step plus its verify+commit step, ms of the admission)."""
    t0 = time.perf_counter()
    require(engine.admit(reqs) == len(reqs), "the engine did not take every request")
    torch.cuda.synchronize()
    admit_ms = 1e3 * (time.perf_counter() - t0)
    done, step_ms, round_ms, draft_ms = {}, [], [], None
    while engine.n_active:
        if interrupt is not None:
            interrupt(engine)
        pending = engine.spec_decode and engine.spec_pending
        t0 = time.perf_counter()
        for f in engine.step():
            done[f.rid] = f
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t0)
        step_ms.append(dt)
        if engine.spec_decode:
            if engine.spec_pending:
                draft_ms = dt
            elif pending and draft_ms is not None:
                round_ms.append(draft_ms + dt)
                draft_ms = None
        require(len(step_ms) <= 4 * engine.max_gen_len + 64, "requests did not finish")
    return done, step_ms, round_ms, admit_ms


def agreement(done, want) -> dict:
    """Trajectories equal to ``want``'s, and the share of tokens before
    each pair's first difference."""
    same = sum(done[r].response == f.response for r, f in want.items())
    lead = 0
    for r, f in want.items():
        a, b = done[r].response, f.response
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        lead += n
    return {"identical_trajectories": same, "of": len(want),
            "tokens_before_first_difference": lead / max(1, sum(len(f.response)
                                                               for f in want.values()))}


def serve_spec_phase(torch, np, models):
    """areal-qwen-1.5b at full width in bf16, greedy: the ring engine,
    then the paged engine (blocks of 16, chunked prefill of 128, no
    fused tail), each plain and with ``spec_decode=4`` at the default
    ``spec_draft_units`` (27 of 28 units) and at 14; 8 prompts of 256-512
    tokens, 96 generated tokens each.  The run at 14 takes an
    ``update_weights`` to version 1 while a drafted round is pending:
    the round is discarded and generation goes on.  Prints tokens/s, ms
    a round, the acceptance rate, accepted tokens a round and per
    full-model pass, launches of each kernel a round, and agreement with
    the plain engine on the same prompts (bf16: a near-tie between
    verify's chunk attention and the plain decode kernel can flip an
    argmax)."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    L, k = cfg.n_layers, 4
    rng = np.random.default_rng(7)
    lengths = rng.integers(256, 513, size=8)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=int(n)).tolist()}
            for i, n in enumerate(lengths)]
    parts, launches_by_part = {}, {}
    for cache in ("ring", "paged"):
        base = dict(n_slots=8, prompt_len=512, max_gen_len=96, temperature=0.0, seed=0,
                    dtype=torch.bfloat16, cache=cache)
        if cache == "paged":
            base.update(block_size=16, prefill_chunk=128)
        # the spans' shapes warm up on a throwaway engine
        warm = RolloutEngine(m0, EngineConfig(**base, spec_decode=k))
        warm.admit(reqs[:2])
        for _ in range(12):
            warm.step()
        del warm
        torch.cuda.synchronize()
        plain = None
        for du in (None, 27, 14):
            name = f"{cache}/plain" if du is None else f"{cache}/spec{k}/units{du}"
            interrupting = du == 14
            extra = {} if du is None else {"spec_decode": k, "spec_draft_units": du}
            engine = RolloutEngine(copy.deepcopy(m0) if interrupting else m0,
                                   EngineConfig(**base, **extra))
            spans = count_ingests(engine)
            hit = {}

            def interrupt(e):
                if e.spec_pending and e.spec_rounds >= 6 and not hit:
                    hit["round"] = e.spec_rounds
                    require(e.update_weights(m1, version=1), "update_weights was deferred")
                    require(not e.spec_pending, "the drafted round survived update_weights")
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            done, step_ms, round_ms, admit_ms = drive_timed(
                torch, engine, reqs, interrupt if interrupting else None)
            launches = dict(ops.LAUNCHES)
            st = engine.stats()
            require(len(done) == len(reqs), f"{name}: finished {len(done)} of {len(reqs)}")
            for f in done.values():
                require(all(math.isfinite(x) and x <= 1e-6 for x in f.logprobs),
                        f"{name} rid {f.rid}: a logprob is not finite or above 0")
            prefills = 1 + (1 if interrupting else 0)
            if du is None:
                plain = done
                want = ({"flash_attention": L * prefills, "decode_attention": L * len(step_ms)}
                        if cache == "ring" else
                        {"paged_prefill_attention": L * spans["n"],
                         "paged_decode_attention": L * st["decode_dispatches"]})
            else:
                drafts = st["decode_dispatches"] - 2 * st["spec_rounds"]
                want = {"decode_attention" if cache == "ring" else "paged_decode_attention":
                        du * (k - 1) * drafts}
                if cache == "ring":        # verify and commit: the plain chunk attention
                    want["flash_attention"] = L * prefills
                else:
                    want["paged_prefill_attention"] = L * (spans["n"] + 2 * st["spec_rounds"])
            for kname in ("flash_attention", "decode_attention", "paged_decode_attention",
                          "paged_prefill_attention", "fused_decode_tail", "linear_scan",
                          "flash_attention_bwd"):
                want.setdefault(kname, 0)
            require_launches(launches, want)
            rec = {"phase": "serve_spec", "part": name, "model": cfg.name, "dtype": "bfloat16",
                   "cache": cache, "spec_decode": k if du else 0, "spec_draft_units": du,
                   "prompt_lengths": [int(x) for x in lengths], "max_gen_len": 96,
                   "admit_ms": admit_ms, "steps": len(step_ms),
                   "step_ms_mean": sum(step_ms) / len(step_ms),
                   "generated_tokens_per_s": st["tokens_generated"] / (sum(step_ms) / 1e3),
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": launches}
            if cache == "paged":
                rec["ingest_spans"] = spans["n"]
            if du is not None:
                rounds = max(1, st["spec_rounds"])
                rec.update(
                    spec_rounds=st["spec_rounds"], drafts=drafts,
                    round_ms_mean=sum(round_ms) / max(1, len(round_ms)),
                    draft_acceptance_rate=st["draft_acceptance_rate"],
                    accepted_tokens_per_slot_round=st["accepted_tokens"]
                    / max(1, engine.spec_member_rounds),
                    accepted_tokens_per_step=st["accepted_tokens_per_step"],
                    launches_per_round={n: c / rounds for n, c in launches.items() if c})
                if interrupting:
                    require(hit and st["interruptions"] == 1, f"{name}: no mid-round update")
                    require(any(set(f.versions) == {0, 1} for f in done.values()),
                            f"{name}: no trajectory spans versions 0 and 1")
                    # the tokens sampled under version 0 against the plain run's
                    v0 = [(x, plain[r].response[i]) for r, f in done.items()
                          for i, (x, v) in enumerate(zip(f.response, f.versions))
                          if v == 0 and i < len(plain[r].response)]
                    rec.update(interrupted_at_round=hit["round"],
                               version0_tokens_equal_to_plain=sum(x == y for x, y in v0)
                               / max(1, len(v0)))
                else:
                    rec["agreement_with_plain"] = agreement(done, plain)
            emit(rec)
            parts[name] = rec
            launches_by_part[name] = launches
            del engine
        torch.cuda.empty_cache()
    # the same weights in f32, ring, 32 tokens: whether bf16 rounding is
    # what parts speculation from the plain engine (a near-tie argmax)
    from repro_torch.models.model import build_model
    m32 = build_model(cfg, device="cuda", dtype=torch.float32)
    m32.load_state_dict(m0.state_dict())
    base32 = dict(n_slots=8, prompt_len=512, max_gen_len=32, temperature=0.0, seed=0)
    plain32, _, _, _ = drive_timed(torch, RolloutEngine(m32, EngineConfig(**base32)), reqs)
    eng32 = RolloutEngine(m32, EngineConfig(**base32, spec_decode=k))
    spec32, _, _, _ = drive_timed(torch, eng32, reqs)
    rec = {"phase": "serve_spec", "part": "ring/f32/spec4/units27", "model": cfg.name,
           "dtype": "float32", "max_gen_len": 32,
           "draft_acceptance_rate": eng32.draft_acceptance_rate,
           "agreement_with_plain": agreement(spec32, plain32)}
    emit(rec)
    parts[rec["part"]] = rec
    del m32, eng32
    torch.cuda.empty_cache()
    return launches_by_part, parts


# ---------------------------------------------------------------------------
# the serving gateway at full width (SLA scheduling, sessions, preempt/resume)
# ---------------------------------------------------------------------------

# areal-qwen-1.5b bf16, 8 slots, prompts of 512, 128 generated tokens (cut
# from the other serve phases' 256 to keep the phase short)
GW_ENGINE = dict(n_slots=8, prompt_len=512, max_gen_len=128, cache="paged", block_size=16,
                 evict="lru", prefill_chunk=128, fused_decode="fused", rng="request",
                 temperature=1.0, seed=0)
GW_SESSIONS, GW_TURNS, GW_PREFIX, GW_OWN = 4, 3, 384, 128
# 4 sessionless requests beside the sessions' first turns fill the 8 slots,
# so that the urgent arrivals find none free and preempt
GW_BACKGROUND = 4
GW_URGENT_AT, GW_URGENT, GW_URGENT_SLA = 32, 4, 64
# the evict part's pool, 8 x 24 blocks: 8 running requests hold at most
# 24 + 8 x 16 = 152 with the prefix shared, so parked prefixes must be
# evicted; the worst-case pool (8 x 40 = 320) never fills under this traffic
GW_EVICT_BLOCKS = 192
GW_HTTP_PROMPT = "q: what is 12+34*5? think step by step, then answer. 2+3="


class GatewayProbe:
    """Wraps one engine's ``step``, ``preempt_slot`` and
    ``_ingest_one_chunk`` on the instance: the ``Finished`` records, the
    response length of each preempted request when it was preempted, and
    the spans ingested."""

    def __init__(self, engine):
        self.finished, self.preempted_at, self.ingests = {}, {}, 0
        step, preempt, ingest = engine.step, engine.preempt_slot, engine._ingest_one_chunk

        def counted_step():
            out = step()
            for f in out:
                self.finished[f.rid] = f
            return out

        def counted_preempt(i):
            snap = preempt(i)
            self.preempted_at.setdefault(snap["rid"], len(snap["response"]))
            return snap

        def counted_ingest():
            self.ingests += 1
            ingest()
        engine.step, engine.preempt_slot = counted_step, counted_preempt
        engine._ingest_one_chunk = counted_ingest


def gateway_traffic(torch, np, engine, vocab: int, *, urgent: bool, preempt: bool = True,
                    max_ticks: int = 3000):
    """Drive a ``Gateway`` over ``engine`` with the phase's traffic, tick
    by tick (one ``pump`` each, host clock around it and a synchronise):
    ``GW_BACKGROUND`` sessionless requests and ``GW_SESSIONS`` sessions'
    first turns at tick 0, all at priority 2: a 384-token prefix common to
    all, then 128 tokens of their own; each session's next turn (128 new
    tokens, under the gateway's session rule) submitted when its last one
    ends, ``GW_TURNS`` a session; with ``urgent``, ``GW_URGENT`` requests
    at priority 0 with an SLA of ``GW_URGENT_SLA`` ticks at tick
    ``GW_URGENT_AT``.  Every subscriber queue is read after each tick.
    Returns what each request streamed, its end record, the tick each
    token arrived, the tick walls and the gateway."""
    from repro_torch.serve import Gateway

    rng = np.random.default_rng(5)
    prefix = rng.integers(3, vocab, size=GW_PREFIX).tolist()
    own = lambda: rng.integers(3, vocab, size=GW_OWN).tolist()
    background = [prefix + own() for _ in range(GW_BACKGROUND)]
    first = [prefix + own() for _ in range(GW_SESSIONS)]
    later = [[own() for _ in range(GW_TURNS - 1)] for _ in range(GW_SESSIONS)]
    urgents = [prefix + own() for _ in range(GW_URGENT)]

    gw = Gateway(engine, preempt=preempt)
    live, submitted_at, session_of = {}, {}, {}
    streamed, ends, arrivals = {}, {}, {}

    def submit(tokens, **kw):
        rid = gw.submit(tokens, **kw)
        live[rid] = gw.events(rid)
        submitted_at[rid] = gw.now()
        streamed[rid], arrivals[rid] = [], []
        return rid

    for p in background:
        submit(p, priority=2)
    for s in range(GW_SESSIONS):
        session_of[submit(first[s], session=f"s{s}", priority=2)] = (s, 1)
    tick_ms = []
    while gw.has_work():
        if urgent and gw.now() == GW_URGENT_AT:
            for p in urgents:
                submit(p, priority=0, sla=GW_URGENT_SLA)
        t0 = time.perf_counter()
        gw.pump()
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        for rid, q in list(live.items()):
            while not q.empty():
                kind, val = q.get_nowait()
                if kind == "tok":
                    streamed[rid].append(val)
                    arrivals[rid].append(gw.now())
                    continue
                ends[rid] = val
                gw.release(rid)
                del live[rid]
                s, turn = session_of.get(rid, (None, 0))
                if s is not None and turn < GW_TURNS:
                    session_of[submit(later[s][turn - 1], session=f"s{s}",
                                      priority=2)] = (s, turn + 1)
        require(len(tick_ms) < max_ticks, f"the gateway did not drain in {max_ticks} ticks")
    return {"streamed": streamed, "ends": ends, "arrivals": arrivals,
            "submitted_at": submitted_at, "tick_ms": tick_ms, "gw": gw}


def pct(xs, q: float):
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))] if ys else None


def gateway_checks(run, probe, engine, n_requests: int) -> dict:
    """Every request ended; streamed tokens == the end record's == the
    engine's ``Finished`` response; nothing queued, running or parked;
    every pool block released.  Returns the latencies in ms (TTFT from the
    submit tick to the first token's, ITL between a request's tokens,
    each over the tick walls) beside the gateway's own in ticks."""
    gw, ends = run["gw"], run["ends"]
    st = gw.stats()
    require(len(ends) == n_requests == st["completed"],
            f"{len(ends)} of {n_requests} requests ended ({st['completed']} completed)")
    for rid, end in ends.items():
        f = probe.finished[rid]
        require(run["streamed"][rid] == end["tokens"] == f.response,
                f"rid {rid}: streamed, drained and finished tokens differ")
        require(all(math.isfinite(x) and x <= 1e-6 for x in f.logprobs),
                f"rid {rid}: a logprob is not finite or above 0")
    require((st["queued"], st["running"], st["parked"]) == (0, 0, 0), f"not idle: {st}")
    al = engine.allocator
    require(all(al.refcount(b) == 0 for b in range(al.n_blocks)), "a block's refcount leaked")
    require(al.n_free + al.n_cached == al.n_blocks,
            f"free {al.n_free} + cached {al.n_cached} != {al.n_blocks} blocks")
    cum = [0.0]
    for ms in run["tick_ms"]:
        cum.append(cum[-1] + ms)
    ttft = [cum[run["arrivals"][r][0]] - cum[run["submitted_at"][r]] for r in ends]
    itl = [cum[b] - cum[a] for r in ends for a, b in zip(run["arrivals"][r],
                                                            run["arrivals"][r][1:])]
    return {"ttft_ms_p50": pct(ttft, 0.5), "ttft_ms_p99": pct(ttft, 0.99),
            "itl_ms_p50": pct(itl, 0.5), "itl_ms_p99": pct(itl, 0.99)}


def gateway_record(torch, part, run, probe, engine, launches, extra) -> dict:
    st = run["gw"].stats()
    walls = run["tick_ms"]
    gen = sum(len(f.response) for f in probe.finished.values())
    rec = {"phase": "serve_gateway", "part": part, "ticks": len(walls),
           "tick_ms_mean": sum(walls) / len(walls), "tick_ms_median": pct(walls, 0.5),
           "tick_ms_p99": pct(walls, 0.99), "wall_s": sum(walls) / 1e3,
           "generated_tokens": gen, "generated_tokens_per_s": gen / (sum(walls) / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ingest_calls": probe.ingests, "decode_steps": engine.decode_dispatches,
           "pool_blocks": engine.n_blocks, "launches": launches, "gateway": st,
           "engine": {k: v for k, v in engine.stats().items()
                      if k in ("prefill_tokens", "reprefill_tokens", "prefix_reused_blocks",
                               "evictions", "revivals", "deferred", "preemptions", "resumes",
                               "decode_steps_during_prefill")}}
    rec.update(extra)
    return rec


def gateway_launches(L, probe, engine) -> dict:
    return {"paged_prefill_attention": L * probe.ingests,
            "fused_decode_tail": L * engine.decode_dispatches, "flash_attention": 0,
            "decode_attention": 0, "paged_decode_attention": 0, "flash_attention_bwd": 0}


def serve_gateway_phase(torch, np, models):
    """The serving gateway at full width: areal-qwen-1.5b in bf16 (random
    weights from seed 0) behind ``repro_torch.serve.Gateway``.  Parts:
    ``gateway`` (the paged engine: sessions, prefix reuse, urgent traffic
    that preempts, then the same traffic without it, the twin), ``evict``
    (no preemption, a pool small enough that LRU evicts parked session
    prefixes), ``ring`` (``launch/serve.py``'s defaults: ring cache,
    chunked prefill of one prompt, ``run_offline``), ``http``
    (``GatewayServer`` on 127.0.0.1 over the ``gateway`` engine) and
    ``cli`` (``python -m repro_torch.launch.serve`` in a subprocess, the
    multi-turn environment, a Perfetto trace).  Returns the launches of
    the parts that drive a kernel, by part."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0 = models["cfg"], models["m0"]
    L = cfg.n_layers
    ecfg = EngineConfig(**GW_ENGINE, dtype=torch.bfloat16)
    out = {}

    # part gateway: with urgent traffic, then the twin without
    runs = {}
    for urgent in (True, False):
        engine = RolloutEngine(m0, ecfg)
        probe = GatewayProbe(engine)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        run = gateway_traffic(torch, np, engine, cfg.vocab_size, urgent=urgent)
        launches = dict(ops.LAUNCHES)
        n = GW_BACKGROUND + GW_SESSIONS * GW_TURNS + (GW_URGENT if urgent else 0)
        lat = gateway_checks(run, probe, engine, n)
        require_launches(launches, gateway_launches(L, probe, engine))
        runs[urgent] = (run, probe, engine, launches, lat)
    run, probe, engine, launches, lat = runs[True]
    twin_run, twin, twin_engine, _, twin_lat = runs[False]
    st, twin_st = run["gw"].stats(), twin_run["gw"].stats()
    require(st["preemptions"] >= 1 and st["resumes"] == st["preemptions"],
            f"preemptions {st['preemptions']}, resumes {st['resumes']}")
    require(twin_st["preemptions"] == 0, f"the twin preempted {twin_st['preemptions']} times")
    for s in (st, twin_st):
        require(s["session_hits"] == GW_SESSIONS * (GW_TURNS - 1),
                f"session_hits {s['session_hits']}")
        require(s["prefix_hit_rate"] > 0, "no prompt block was shared")
    resumed = {}
    for rid, n_at in probe.preempted_at.items():
        got, want = probe.finished[rid], twin.finished[rid]
        after = list(zip(got.response[n_at:], want.response[n_at:]))
        first_diff = next((k for k, (a, b) in enumerate(after) if a != b), None)
        resumed[rid] = {"preempted_at": n_at, "tokens_after": len(got.response) - n_at,
                        "equal_to_twin": sum(a == b for a, b in after),
                        "first_difference": first_diff,
                        "logprob_diff_first_after": (abs(got.logprobs[n_at] - want.logprobs[n_at])
                                                     if n_at < min(len(got.logprobs),
                                                                   len(want.logprobs))
                                                     else None)}
    emit(gateway_record(torch, "gateway", run, probe, engine, launches, {
        **lat, "resumed": resumed, "twin": {
            "ticks": len(twin_run["tick_ms"]), "tick_ms_mean": sum(twin_run["tick_ms"])
            / len(twin_run["tick_ms"]), "gateway": twin_st, **twin_lat}}))
    out["gateway"] = launches

    # part evict: the same traffic, no preemption, a pool LRU must evict from
    ev_engine = RolloutEngine(m0, ecfg.replace(n_blocks=GW_EVICT_BLOCKS))
    ev_probe = GatewayProbe(ev_engine)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ev = gateway_traffic(torch, np, ev_engine, cfg.vocab_size, urgent=True, preempt=False)
    ev_launches = dict(ops.LAUNCHES)
    ev_lat = gateway_checks(ev, ev_probe, ev_engine,
                            GW_BACKGROUND + GW_SESSIONS * GW_TURNS + GW_URGENT)
    require_launches(ev_launches, gateway_launches(L, ev_probe, ev_engine))
    ev_st = ev["gw"].stats()
    require(ev_st["evictions"] > 0, f"no parked block was evicted from {GW_EVICT_BLOCKS}")
    require(ev_st["preemptions"] == 0, "preempt=False preempted")
    emit(gateway_record(torch, "evict", ev, ev_probe, ev_engine, ev_launches, ev_lat))
    out["evict"] = ev_launches
    del ev_engine, ev_probe, ev, twin_engine, twin, twin_run

    out["ring"] = gateway_ring_part(torch, models)
    gateway_http_part(torch, engine)
    gateway_cli_part()
    return out


def gateway_ring_part(torch, models) -> dict:
    """``launch/serve.py`` at its defaults at full width: the parser with
    its flags, ``cli.engine_config_from_args`` through ``build_gateway``
    (the ring cache, chunked prefill of one prompt), then ``run_offline``
    with ``--env math --requests 16``.  The plain chunked-prefill
    attention (no kernel: ``ops.chunked_prefill_attention``) is timed by
    CUDA events around each call, beside the ticks that ingest."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    ap = argparse.ArgumentParser()
    serve.add_flags(ap)
    args = ap.parse_args(["--env", "math", "--requests", "16"])
    gw, env = serve.build_gateway(args, model=models["m0"])
    engine = gw.engine
    ec = engine.engine_config
    require((ec.cache, ec.prefill_chunk) == ("ring", args.prompt_len),
            f"serve's defaults gave cache {ec.cache!r}, prefill_chunk {ec.prefill_chunk}")
    probe = GatewayProbe(engine)
    plain = ops.chunked_prefill_attention
    events = []

    def timed_plain(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        o = plain(*a, **kw)
        end.record()
        events.append((start, end))
        return o
    pump = gw.pump
    ticks = []

    def timed_pump():
        n_ingest = probe.ingests
        t0 = time.perf_counter()
        done = pump()
        torch.cuda.synchronize()
        ticks.append((1e3 * (time.perf_counter() - t0), probe.ingests > n_ingest))
        return done
    gw.pump = timed_pump
    ops.chunked_prefill_attention = timed_plain
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        summary = serve.run_offline(gw, env, args)
    finally:
        ops.chunked_prefill_attention = plain
    launches = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    attn_ms = [s.elapsed_time(e) for s, e in events]
    keys = ["requests", "ticks", "generated_tokens", "tokens_per_s", "mean_len", "env",
            "verified_ok", "verified", "sessions", "sla_misses", "preemptions", "resumes",
            "evictions", "revivals", "deferred", "prefix_hit_rate", "session_hits",
            "ttft_p50", "ttft_p99"]
    require(list(summary) == keys, f"run_offline's summary keys {list(summary)}")
    require(summary["requests"] == 16 and summary["generated_tokens"] > 0, f"{summary}")
    L = models["cfg"].n_layers
    require_launches(launches, {"decode_attention": L * engine.decode_dispatches,
                                "flash_attention": 0, "paged_prefill_attention": 0,
                                "paged_decode_attention": 0, "fused_decode_tail": 0,
                                "flash_attention_bwd": 0})
    require(len(attn_ms) == L * probe.ingests,
            f"{len(attn_ms)} plain attention calls for {probe.ingests} spans")
    ingest_ticks = [t for t in ticks if t[1]]
    decode_ticks = [t[0] for t in ticks if not t[1]]
    ingest_ms = sum(t[0] for t in ingest_ticks)
    emit({"phase": "serve_gateway", "part": "ring", "summary": summary,
          "engine_config": {k: v for k, v in vars(ec).items() if k not in ("dtype", "continuation")},
          "ingest_calls": probe.ingests, "decode_steps": engine.decode_dispatches,
          "ticks_with_ingest": len(ingest_ticks),
          "tick_with_ingest_ms_mean": ingest_ms / max(len(ingest_ticks), 1),
          "tick_decode_only_ms_mean": sum(decode_ticks) / max(len(decode_ticks), 1),
          "plain_chunk_attention_ms_per_span": sum(attn_ms) / max(probe.ingests, 1),
          "plain_chunk_attention_share_of_ingest_ticks": sum(attn_ms) / ingest_ms
          if ingest_ms else None,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches})
    return launches


def gateway_http_part(torch, engine) -> None:
    """``GatewayServer`` over the ``gateway`` part's engine on 127.0.0.1
    (a free port): 4 clients with sessions in two waves of 2, each
    streaming a completion of ``GW_HTTP_PROMPT`` (3 blocks of 16, shared),
    then ``/stats``, ``/metrics`` and ``/healthz``.  A failure to bind
    fails the phase."""
    import threading
    import urllib.request
    from repro_torch.serve import Gateway, GatewayServer

    engine.release_driver()               # the server's driver thread takes over
    reused0 = engine.prefix_reused_blocks
    srv = GatewayServer(Gateway(engine), port=0)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    results, walls = {}, {}

    def client(i):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"{base}/v1/completions", headers={
            "Content-Type": "application/json"}, data=json.dumps(
            {"prompt": GW_HTTP_PROMPT, "session": f"u{i}"}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = [json.loads(ln) for ln in r.read().splitlines() if ln.strip()]
        walls[i] = time.perf_counter() - t0

    try:
        for wave in range(2):
            ts = [threading.Thread(target=client, args=(2 * wave + j,)) for j in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
                require(not t.is_alive(), "an HTTP client did not finish")
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            st = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
    require(len(results) == 4, f"{len(results)} of 4 streams returned")
    for i, lines in results.items():
        require(lines and lines[-1].get("done") is True, f"client {i}: no done line")
        require([ln["token"] for ln in lines[:-1]] == lines[-1]["tokens"],
                f"client {i}: streamed tokens differ from the done line's")
    reused = st["prefix_reused_blocks"] - reused0
    require(reused > 0, "the HTTP sessions shared no prefix block")
    require("repro_gateway_ttft_bucket" in metrics, "/metrics lacks repro_gateway_ttft_bucket")
    require(health == {"ok": True}, f"/healthz said {health}")
    emit({"phase": "serve_gateway", "part": "http", "port": srv.port,
          "client_wall_s": walls, "tokens": {i: len(r[-1]["tokens"]) for i, r in results.items()},
          "ttft_ms": {i: r[-1]["ttft"] for i, r in results.items()},
          "prefix_reused_blocks": reused, "completed": st["completed"],
          "ttft_p50_ms": st["ttft_p50"], "ttft_p99_ms": st["ttft_p99"],
          "itl_p50_ms": st["itl_p50"], "itl_p99_ms": st["itl_p99"],
          "metrics_lines": len(metrics.splitlines())})


def gateway_cli_part() -> None:
    """``python -m repro_torch.launch.serve`` as a user runs it, on the
    card at the launcher's reduced config: the paged cache, chunked
    prefill of 16, the multi-turn environment (64 generated tokens, so
    that a first turn leaves room for the environment's reply), and a
    Perfetto trace written under ``build/``."""
    trace_path = ROOT / "build" / "serve_trace.json"
    trace_path.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--cache", "paged",
           "--prefill-chunk", "16", "--env", "multiturn", "--max-gen", "64",
           "--trace-out", str(trace_path.relative_to(ROOT))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"serve exited {proc.returncode}: {proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    require(summary.get("continuations", 0) > 0, f"no continuation: {summary}")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {}
    for ev in events:
        names[ev["name"]] = names.get(ev["name"], 0) + 1
    missing = [n for n in ("engine.step", "engine.ingest", "gw.admit", "gw.ttft")
               if not names.get(n)]
    require(not missing, f"the trace lacks {missing}")
    emit({"phase": "serve_gateway", "part": "cli", "command": " ".join(cmd[1:]),
          "wall_s": wall_s, "summary": summary, "trace_events": names})


def build_hybrid_models(torch):
    """recurrentgemma-9b at full width in bf16: random weights from seed
    0, and the perturbed policy of version 1 (every weight times 1.01;
    ``lam`` stays f32)."""
    from repro_torch.configs import get_model_config
    from repro_torch.models.model import build_model

    cfg = get_model_config("recurrentgemma-9b")
    t0 = time.perf_counter()
    m0 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    m0.init(torch.Generator(device="cuda").manual_seed(0))
    m1 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p1, p0 in zip(m1.parameters(), m0.parameters()):
            p1.copy_(p0 * 1.01)
    torch.cuda.synchronize()
    require(m0.blocks[0].rec.lam.dtype == torch.float32, "lam is not f32 in the bf16 model")
    return {"cfg": cfg, "m0": m0, "m1": m1, "init_s": time.perf_counter() - t0,
            "params": sum(p.numel() for p in m0.parameters()),
            "weight_gb": sum(p.numel() * p.element_size() for p in m0.parameters()) / 1e9}


def serve_hybrid_phase(torch, np, models):
    """``serve``'s traffic and interruption on recurrentgemma-9b: 8
    prompts of 256-512 tokens, 256 generated tokens each, one
    interrupting ``update_weights`` after 96 decode steps.  Every prefill
    call runs the linear scan once per RG-LRU layer and flash attention
    once per local layer; every decode step runs decode attention once
    per local layer."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    n_slots, prompt_len, max_gen_len, interrupt_at = 8, 512, 256, 96
    ecfg = EngineConfig(n_slots=n_slots, prompt_len=prompt_len, max_gen_len=max_gen_len,
                        temperature=1.0, seed=0, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    lengths = rng.integers(256, prompt_len + 1, size=n_slots)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=int(n)).tolist()}
            for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    warm = RolloutEngine(m0, ecfg)
    warm.admit(reqs)
    for _ in range(2):
        warm.step()
    del warm
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    engine = RolloutEngine(m0, ecfg)
    ops.reset_launches()
    t0 = time.perf_counter()
    admitted = engine.admit(reqs)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    prefill_calls, decode_steps = 1, 0
    done = {}
    step_ms, reprefill_ms = [], None
    while len(done) < n_slots:
        if decode_steps == interrupt_at:
            t0 = time.perf_counter()
            require(engine.update_weights(m1, version=1), "update_weights was deferred")
            torch.cuda.synchronize()
            reprefill_ms = 1e3 * (time.perf_counter() - t0)
            prefill_calls += 1
        t0 = time.perf_counter()
        fin = engine.step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        decode_steps += 1
        for f in fin:
            done[f.rid] = f
        require(decode_steps <= max_gen_len + 1, "requests did not finish")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require(admitted == n_slots, f"admitted {admitted} of {n_slots}")
    check_finished(cfg, done, n_slots)
    require((m0.n_rec, m0.n_attn) == (26, 12), f"layer kinds {m0.kinds}")
    require_launches(launches, {"linear_scan": m0.n_rec * prefill_calls,
                                "flash_attention": m0.n_attn * prefill_calls,
                                "decode_attention": m0.n_attn * decode_steps,
                                "paged_decode_attention": 0, "paged_prefill_attention": 0,
                                "fused_decode_tail": 0, "flash_attention_bwd": 0})
    st = engine.stats()
    rec = {"phase": "serve_hybrid", "model": cfg.name, "params": models["params"],
           "weight_gb": models["weight_gb"], "dtype": "bfloat16",
           "layers": {"rec": m0.n_rec, "local": m0.n_attn}, "n_slots": n_slots,
           "prompt_len": prompt_len, "max_gen_len": max_gen_len,
           "prompt_lengths": [int(x) for x in lengths], "init_s": models["init_s"],
           "warmup_s": warmup_s, "prefill_ms": prefill_ms, "reprefill_ms": reprefill_ms,
           "decode_steps": decode_steps, "prefill_calls": prefill_calls,
           "decode_step_ms_mean": sum(step_ms) / len(step_ms),
           "decode_step_ms_median": sorted(step_ms)[len(step_ms) // 2],
           "decode_step_ms_p95": sorted(step_ms)[int(0.95 * len(step_ms))],
           "generated_tokens_per_s": st["tokens_generated"] / (sum(step_ms) / 1e3),
           "peak_memory_gb": peak_gb, "launches": launches, "stats": st,
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done.values())}
    emit(rec)
    return launches, engine, reqs, rec["decode_step_ms_mean"], prefill_ms


def serve_hybrid_paged_phase(torch, np, models):
    """recurrentgemma-9b at full width in bf16, greedy, on 4 prompts of
    2304-2560 tokens (past the local window of 2048), 48 generated tokens
    each: the ring engine with monolithic prefill (the yardstick), the
    ring engine with chunked prefill of 128, the paged engine (blocks of
    16, chunks of 128) with ``spec_decode=3``, the same paged engine with
    the fused decode tail (12 ``fused_decode_tail`` launches a decode
    step, head_dim 256 over one kv head, ``wo`` 4096 x 4096), and last the
    paged engine plain, with an interrupting ``update_weights`` (new
    weights, version 2) after 16 decode steps that re-ingests every
    history.  Runs after
    ``serve_hybrid``, whose update left version 1's weights in ``m0``.
    Each chunk, verify and commit span runs the linear scan once per
    RG-LRU layer (26) from the slots' state, and each paged call its
    kernel once per local layer (12; a draft step the first 11 units'
    11)."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    n_rec, n_attn = m0.n_rec, m0.n_attn
    rng = np.random.default_rng(9)
    lengths = rng.integers(2304, 2561, size=4)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=int(n)).tolist()}
            for i, n in enumerate(lengths)]
    base = dict(n_slots=4, prompt_len=2560, max_gen_len=48, temperature=0.0, seed=0,
                dtype=torch.bfloat16)
    chunk = dict(prefill_chunk=128)
    paged = dict(cache="paged", block_size=16, prefill_chunk=128)
    runs = (("ring", {}), ("ring_chunked", chunk), ("paged_spec3", dict(paged, spec_decode=3)),
            ("paged_fused", dict(paged, fused_decode="fused")), ("paged", paged))
    out, launches_by_part, ref = {}, {}, None
    for name, extra in runs:
        engine = RolloutEngine(m0, EngineConfig(**base, **extra))
        spans = count_ingests(engine)
        update = {}

        def interrupt(e):
            if name == "paged" and e.decode_dispatches == 16 and not update:
                with torch.no_grad():
                    for p in m1.parameters():
                        p.mul_(0.99)
                update["t"] = time.perf_counter()
                require(e.update_weights(m1, version=2), "update_weights was deferred")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t_admit = time.perf_counter()
        require(engine.admit(reqs) == len(reqs), f"{name}: not every request admitted")
        torch.cuda.synchronize()
        admit_ms = 1e3 * (time.perf_counter() - t_admit)
        done, decode_ms, mixed_ms = {}, [], []
        ingest_ms = admit_ms if not engine.prefill_chunk else None
        reingest_ms = None
        while engine.n_active:
            interrupt(engine)
            n_span, n_dec = spans["n"], engine.decode_dispatches
            t0 = time.perf_counter()
            for f in engine.step():
                done[f.rid] = f
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (mixed_ms if spans["n"] > n_span else decode_ms).append(1e3 * (t1 - t0))
            if engine.prefill_chunk and not engine._ingest_queue:
                if ingest_ms is None:
                    ingest_ms = 1e3 * (t1 - t_admit)
                if update and reingest_ms is None:
                    reingest_ms = 1e3 * (t1 - update["t"])
            require(len(decode_ms) + len(mixed_ms) < 600, f"{name}: requests did not finish")
        launches = dict(ops.LAUNCHES)
        st = engine.stats()
        require(len(done) == len(reqs), f"{name}: finished {len(done)} of {len(reqs)}")
        for f in done.values():
            require(all(math.isfinite(x) and x <= 1e-6 for x in f.logprobs),
                    f"{name} rid {f.rid}: a logprob is not finite or above 0")
            require(all(0 <= x < cfg.vocab_size for x in f.response),
                    f"{name} rid {f.rid}: a token outside the vocabulary")
        rounds = st["spec_rounds"]
        drafts = st["decode_dispatches"] - 2 * rounds
        if name == "ring":
            want = {"linear_scan": n_rec, "flash_attention": n_attn,
                    "decode_attention": n_attn * st["decode_dispatches"]}
        elif name == "ring_chunked":
            want = {"linear_scan": n_rec * spans["n"],
                    "decode_attention": n_attn * st["decode_dispatches"]}
        else:
            calls = spans["n"] + 2 * rounds
            # a draft step runs the first units' local layers, 2 steps a round of 3
            n_draft = (m0.kinds[:engine._spec_draft_units * len(m0.pattern)].count("local")
                       if rounds else 0)
            want = {"linear_scan": n_rec * calls, "paged_prefill_attention": n_attn * calls,
                    "paged_decode_attention": (n_draft * 2 * drafts if rounds
                                               else n_attn * st["decode_dispatches"])}
            if engine.fused_decode == "fused":    # one fused launch a local layer a step
                want["paged_decode_attention"] = 0
                want["fused_decode_tail"] = n_attn * st["decode_dispatches"]
        for kname in ("flash_attention", "decode_attention", "paged_decode_attention",
                      "paged_prefill_attention", "fused_decode_tail", "linear_scan",
                      "flash_attention_bwd"):
            want.setdefault(kname, 0)
        require_launches(launches, want)
        steps = decode_ms + mixed_ms
        rec = {"phase": "serve_hybrid_paged", "part": name, "model": cfg.name,
               "dtype": "bfloat16", "engine": {k: v for k, v in extra.items()},
               "prompt_lengths": [int(x) for x in lengths], "max_gen_len": base["max_gen_len"],
               "admit_ms": admit_ms, "ingest_ms": ingest_ms, "reingest_ms": reingest_ms,
               "ingest_spans": spans["n"], "decode_dispatches": st["decode_dispatches"],
               "decode_only_step_ms_mean": sum(decode_ms) / max(1, len(decode_ms)),
               "decode_only_step_ms_median": sorted(decode_ms)[len(decode_ms) // 2]
               if decode_ms else None,
               "steps_with_ingest": len(mixed_ms),
               # over the admission and every step: ingest is in the steps when chunked
               "run_s": (admit_ms + sum(steps)) / 1e3,
               "generated_tokens_per_s": st["tokens_generated"] * 1e3 / (admit_ms + sum(steps)),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches, "stats": st}
        if rounds:
            rec.update(spec_rounds=rounds, drafts=drafts,
                       draft_acceptance_rate=st["draft_acceptance_rate"],
                       accepted_tokens_per_step=st["accepted_tokens_per_step"],
                       launches_per_round={n: c / rounds for n, c in launches.items() if c})
        if ref is None:
            ref = done
        elif name == "paged":
            require(st["interruptions"] == 1 and reingest_ms is not None,
                    "paged: no interrupting update")
            v0 = [(x, ref[r].response[i]) for r, f in done.items()
                  for i, (x, v) in enumerate(zip(f.response, f.versions))
                  if v == 0 and i < len(ref[r].response)]
            rec["pre_update_tokens_equal_to_ring"] = sum(x == y for x, y in v0) / max(1, len(v0))
        else:
            rec["agreement_with_ring"] = agreement(done, ref)
        emit(rec)
        out[name] = rec
        launches_by_part[name] = launches
        del engine
        torch.cuda.empty_cache()
    return launches_by_part, out


# ---------------------------------------------------------------------------
# the trainer's path: the flash backward kernel, a laptop-scale train step
# against the CPU, and train steps at full width fed by the ring engine
# ---------------------------------------------------------------------------

# b, s, h, hkv, hd of the train phase's micro-batch: one packed row of
# 6144 tokens holding 8 segments of 727 (471 + 256), then padding
TRAIN_SHAPE = (1, 6144, 12, 2, 128)
TRAIN_SEGMENTS = [727] * 8
# the kernel's cases: B x S x (H, Hkv) x head_dim, each causal, causal with
# a window and non-causal, all over packed segments with a -1 tail
BWD_SHAPES = [(b, s, h, hkv, hd) for hd in (64, 128) for b in (1, 4) for s in (1, 37, 256, 768)
              for h, hkv in ((4, 2), (12, 2))]
BWD_VARIANTS = (("causal", True, 0), ("window", True, 100), ("full", False, 0))


def bwd_inputs(torch, np, rng, dtype, b, s, h, hkv, hd, seg_lens=None):
    """q, k, v, dout and packed segment ids: segments of random lengths
    then a -1 padding tail (``seg_lens`` fixes the segments' lengths)."""
    x = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
         for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd))]
    seg = np.full((b, s), -1, np.int32)
    for r in range(b):
        lens = seg_lens or rng.integers(1, max(2, s // 2), size=4).tolist()
        o = 0
        for i, n in enumerate(lens):
            n = min(n, s - o)
            seg[r, o:o + n] = i
            o += n
    return (*x, torch.from_numpy(seg).to("cuda"))


def bwd_flops_bytes(torch, seg, s, h, window, causal, q, k, grads):
    """Operations and bytes the backward must do at these inputs: five
    products of 2·hd flops per visible (query, key) pair (S and dP
    recomputed, dV, dK, dQ: 2.5x the forward's two), and q, k, v, out,
    dout, lse and seg read once, dq, dk, dv written once (v as large as k)."""
    mask = flash_mask(torch, seg, s, window, causal)
    flops = 10.0 * q.shape[-1] * mask.sum().item() * h
    byts = 3 * nbytes(q) + 2 * nbytes(k) + nbytes(seg) + 4 * q.shape[0] * h * s + \
        nbytes(*grads)
    return mask, flops, byts


def train_forward(torch, F, timer, q, k, v, seg, mask, kw, case, iters):
    """The flash forward with its log-sum-exp at the train phase's packed
    row, against its plain version, timed beside SDPA's forward with the
    same bool mask.  Its bound: two products of 2·hd flops per visible
    pair; q, k, v and seg read once, out and lse written once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    b, s, h, hd = q.shape
    out, _ = flash_attention_cuda(q, k, v, seg, return_lse=True, **kw)
    err = check("flash_attention", out, ref.flash_attention(q, k, v, segment_ids=seg, **kw),
                "bfloat16", case)
    flops = 4.0 * hd * mask.sum().item() * h
    byts = 2 * nbytes(q) + 2 * nbytes(k) + nbytes(seg) + 4 * b * h * s
    qx, kx, vx = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask, enable_gqa=True)
    return {"phase": "train_kernel", "name": "flash_attention", "dtype": "bfloat16",
            "case": f"{case}, forward with its log-sum-exp", "max_abs_err": err,
            "ms": timer(lambda: flash_attention_cuda(q, k, v, seg, return_lse=True, **kw),
                        *iters),
            "library_ms": timer(sdpa, *iters), "flops": flops, "bytes": byts,
            **bound(flops, byts, "bfloat16")}


# the hybrid's local attention in training: head_dim 256 (bf16 only), 16
# query heads over one kv head, a window of 2048; b, s, h, hkv, window,
# causal, segment lengths (then a -1 tail): a window crossing tile edges,
# no window at a group of 4, non-causal with a window at 6 heads over 2,
# and a packed row of 6144 tokens (the train phase's micro-batch) whose
# segments include one longer than the window
HD256_BWD_CASES = [(1, 520, 16, 1, 130, True, [400]), (2, 200, 4, 1, 0, True, None),
                   (1, 333, 6, 2, 70, False, [150, 120])]
HD256_TRAIN = (1, 6144, 16, 1, 2048, True, [2600, 1500, 1200, 700])


def hd256_backward(torch, np, rng, timer):
    """The backward kernel at head_dim 256 in bf16 (the two warpgroups of
    a block split the accumulated columns) against the plain backward:
    element by element and by ``NORM_TOL``, whole and per head, every call
    twice bitwise equal; the forward's log-sum-exp too.  At
    ``HD256_TRAIN`` timed beside the plain backward and SDPA's backward
    (bool mask).  Returns that case's record."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    dn, hd, row = "bfloat16", 256, None
    for b, s, h, hkv, window, causal, segs in HD256_BWD_CASES + [HD256_TRAIN]:
        train = (b, s, h, hkv, window, causal, segs) == HD256_TRAIN
        q, k, v, dout, seg = bwd_inputs(torch, np, rng, torch.bfloat16, b, s, h, hkv, hd, segs)
        kw = dict(causal=causal, window=window)
        case = f"B={b} S={s} H={h} Hkv={hkv} hd={hd} window={window} causal={causal} " \
               f"segments={segs}"
        out, lse = flash_attention_cuda(q, k, v, seg, return_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw)
        want_lse = ref.flash_attention_lse(q, k, segment_ids=seg, **kw)
        want = ref.flash_attention_bwd(q, k, v, out, want_lse, dout, segment_ids=seg, **kw)
        torch.cuda.synchronize()
        err, norm = check("flash_attention lse", lse, want_lse, dn, case), 0.0
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            require(torch.equal(g, a), f"flash_attention_bwd {case}: {name} differs between "
                                       "two calls")
            err = max(err, check(f"flash_attention_bwd {name}", g, w, dn, case))
            norm = max(norm, check_norm(f"flash_attention_bwd {name}", g, w, dn, case))
        rec = {"phase": "train_kernel", "name": "flash_attention_bwd", "dtype": dn,
               "case": case, "max_abs_err": err, "tol": TOL[dn],
               "norm_rel_err": {n: rms_rel(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                                   got, want)},
               "max_norm_err_over_limit": norm, "norm_tol": NORM_TOL[dn]}
        if train and timer is not None:
            mask, flops, byts = bwd_flops_bytes(torch, seg, s, h, window, causal, q, k, got)
            qx, kx, vx = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask, enable_gqa=True)
            dx = dout.transpose(1, 2)
            rec.update(
                ms=timer(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw),
                         20, 3),
                plain_ms=timer(lambda: ref.flash_attention_bwd(
                    q, k, v, out, lse, dout, segment_ids=seg, **kw), 5, 1),
                library_ms=timer(lambda: torch.autograd.grad(sdpa, (qx, kx, vx), dx,
                                                             retain_graph=True), 5, 1),
                library="scaled_dot_product_attention backward (bool mask)",
                flops=flops, bytes=byts, **bound(flops, byts, dn))
            del sdpa, mask, qx, kx, vx
        emit(rec)
        if train:
            row = rec
    return row


# the scan's gradient over HD256_TRAIN's packed row: B 1, S 6144, C 4096
# (the RG-LRU's width) in f32, resets at its segment starts, identity
# steps over its padding, and an h0
SCAN_BWD = (1, 6144, 4096)


def scan_backward(torch, np, rng, timer):
    """``ops.linear_scan`` under autograd on the card, whose backward is
    the reverse-time kernel, against ``torch.autograd`` of the plain scan
    on the same inputs: da, dx, dh0 in f32 (``check``), the kernel's
    gradients twice bitwise equal; timed beside the plain backward (the
    autograd of the plain scan's loop, forward included) and the forward
    kernel at the same shape.  No PyTorch call computes it."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.linear_scan import linear_scan_bwd_cuda, linear_scan_cuda

    b, s, c = SCAN_BWD
    dn = "float32"
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", torch.float32)
    a = rng.uniform(0.9, 0.999, size=(b, s, c)).astype(np.float32)
    x = rng.standard_normal((b, s, c), dtype=np.float32)
    starts = np.cumsum([0] + HD256_TRAIN[-1])
    a[:, starts[:-1]] = 0.0                            # each segment's first step
    a[:, starts[-1]:], x[:, starts[-1]:] = 1.0, 0.0    # the padding: identity steps
    a, x = f32(a), f32(x)
    h0 = f32(rng.standard_normal((b, c), dtype=np.float32))
    g = f32(rng.standard_normal((b, s, c), dtype=np.float32))
    g_last = f32(rng.standard_normal((b, c), dtype=np.float32))
    case = f"B={b} S={s} C={c} resets at {starts[:-1].tolist()}, identity steps from " \
           f"{int(starts[-1])}, h0"

    def grads(fn):
        ia, ix, ih0 = (t.clone().requires_grad_() for t in (a, x, h0))
        h, h_last = fn(ia, ix, ih0)
        torch.autograd.backward((h, h_last), (g, g_last))
        return h.detach(), (ia.grad, ix.grad, ih0.grad)

    before = dict(ops.LAUNCHES)
    h, got = grads(ops.linear_scan)
    torch.cuda.synchronize()
    require(ops.LAUNCHES["linear_scan_bwd"] == before["linear_scan_bwd"] + 1,
            "ops.linear_scan's backward did not launch the gradient kernel")
    _, want = grads(ref.linear_scan)
    # each entry sums up to thousands of decayed upstream terms, so the
    # summation order moves it by the rounding of the largest of them:
    # within tol x the gradient's largest magnitude, as the card's tests
    err = max(check_scaled(f"linear_scan_bwd {n}", u, w, dn, case)
              for n, u, w in zip(("da", "dx", "dh0"), got, want))
    fn = lambda: linear_scan_bwd_cuda(a, h, h0, g, g_last)
    first, again = fn(), fn()
    torch.cuda.synchronize()
    require(all(torch.equal(u, w) for u, w in zip(first, again)),
            "linear_scan_bwd: two calls differ")
    rec = {"phase": "train_kernel", "name": "linear_scan_bwd", "dtype": dn, "case": case,
           "max_abs_err": err, "tol": TOL[dn], "tol_of": "each gradient's largest magnitude",
           "library_ms": None,
           "library": "none: no PyTorch call computes the gradient of a diagonal linear "
                      "recurrence"}
    if timer is not None:
        # a, h, g read once, dx and da written once; h0, g_last, dh0 once;
        # about 5 flops an element (two scans' multiply-adds, da's product)
        byts = 5 * nbytes(a) + 3 * nbytes(h0)
        flops = 5.0 * a.numel()
        rec.update(ms=timer(fn), forward_ms=timer(lambda: linear_scan_cuda(a, x, h0)),
                   plain_ms=timer(lambda: grads(ref.linear_scan), 3, 1),
                   plain="torch.autograd of ref.linear_scan, forward and backward",
                   flops=flops, bytes=byts, **bound(flops, byts, dn))
    emit(rec)
    return rec


def train_kernel_phase(torch, np, quick: bool):
    """The flash-attention backward kernel against its plain version over
    ``BWD_SHAPES`` x ``BWD_VARIANTS`` in f32 and bf16, with the forward's
    log-sum-exp against its plain version; every call twice, bitwise
    equal.  Each case is timed beside the plain backward and SDPA's
    backward; the train phase's micro-batch (``TRAIN_SEGMENTS`` packed in
    one row) is timed longer and gives the kernels line its row.  Every
    gradient is held element by element (``check``) and by its
    norm-relative error, whole and per head (``check_norm``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    rng = np.random.default_rng(20)
    timer = None if quick else Timer(torch)
    cases = [(dt, shape, v) for dt in (torch.float32, torch.bfloat16) for shape in BWD_SHAPES
             for v in BWD_VARIANTS]
    cases.append((torch.bfloat16, TRAIN_SHAPE, ("train", True, 0)))
    row = None
    worst, worst_norm = {}, {}
    for dtype, (b, s, h, hkv, hd), (variant, causal, window) in cases:
        dn = str(dtype).split(".")[1]
        train = variant == "train"
        q, k, v, dout, seg = bwd_inputs(torch, np, rng, dtype, b, s, h, hkv, hd,
                                        TRAIN_SEGMENTS if train else None)
        kw = dict(causal=causal, window=window)
        case = f"B={b} S={s} H={h} Hkv={hkv} hd={hd} {variant}"
        out, lse = flash_attention_cuda(q, k, v, seg, return_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw)
        want_lse = ref.flash_attention_lse(q, k, segment_ids=seg, **kw)
        want = ref.flash_attention_bwd(q, k, v, out, want_lse, dout, segment_ids=seg, **kw)
        torch.cuda.synchronize()
        err = check("flash_attention lse", lse, want_lse, dn, case)
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            require(torch.equal(g, a), f"flash_attention_bwd {case} {dn}: {name} differs "
                                       "between two calls")
            err = max(err, check(f"flash_attention_bwd {name}", g, w, dn, case))
            worst_norm[dn] = max(worst_norm.get(dn, 0.0),
                                 check_norm(f"flash_attention_bwd {name}", g, w, dn, case))
        worst[dn] = max(worst.get(dn, 0.0), err)
        if timer is None:
            continue
        mask, flops, byts = bwd_flops_bytes(torch, seg, s, h, window, causal, q, k, got)
        iters = (20, 3) if train else (5, 1)
        qx, kx, vx = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask, enable_gqa=True)
        dx = dout.transpose(1, 2)
        rec = {"phase": "train_kernel", "name": "flash_attention_bwd", "dtype": dn,
               "case": case, "max_abs_err": err, "tol": TOL[dn],
               "norm_rel_err": {n: rms_rel(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                                   got, want)},
               "norm_tol": NORM_TOL[dn],
               "median_abs_want": {n: w.float().abs().median().item()
                                   for n, w in zip(("dq", "dk", "dv"), want)},
               "ms": timer(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw),
                           *iters),
               "plain_ms": timer(lambda: ref.flash_attention_bwd(
                   q, k, v, out, lse, dout, segment_ids=seg, **kw), *iters),
               "library_ms": timer(lambda: torch.autograd.grad(
                   sdpa, (qx, kx, vx), dx, retain_graph=True), *iters),
               "flops": flops, "bytes": byts, **bound(flops, byts, dn)}
        emit(rec)
        if train:
            row = rec
            emit(train_forward(torch, F, timer, q, k, v, seg, mask, kw, case, iters))
        del sdpa, mask, qx, kx, vx
    emit({"phase": "train_kernel", "name": "flash_attention_bwd",
          "cases": f"{len(cases)}: BWD_SHAPES x BWD_VARIANTS in f32 and bf16, and the train "
                   "shape; twice bitwise equal", "max_abs_err": worst, "tol": TOL,
          "max_norm_err_over_limit": worst_norm, "norm_tol": NORM_TOL})
    out = {"flash_attention_bwd_hd256": hd256_backward(torch, np, rng, timer),
           "linear_scan_bwd": scan_backward(torch, np, rng, timer)}
    if row:
        out["flash_attention_bwd"] = row
    return out


def make_trajectories(finished, rewards):
    """Trajectories of engine results, rewards given by rid."""
    from repro_torch.core.buffer import Trajectory
    return [Trajectory(rid=f.rid, prompt_id=f.prompt_id, prompt_tokens=list(f.prompt),
                       response_tokens=list(f.response), behav_logprobs=list(f.logprobs),
                       versions=list(f.versions), behavior_version=f.behavior_version,
                       reward=rewards[f.rid])
            for f in sorted(finished.values(), key=lambda f: f.rid)]


def group_rewards(rng, rids, group: int):
    """Seeded 0/1 rewards with both values in every group: with random
    weights the verifier would score every answer 0, the group
    advantages would be 0 and the policy gradient would vanish."""
    out = {}
    for g in range(0, len(rids), group):
        r = rng.integers(0, 2, size=group)
        r[0], r[1] = 1, 0
        out.update({rid: float(x) for rid, x in zip(rids[g:g + group], rng.permutation(r))})
    return out


def small_train_phase(torch, np):
    """One train_step of the reduced areal-qwen-1.5b (2 layers, d 256,
    hd 64) and one of the reduced recurrentgemma-9b (an RG-LRU block and a
    local-attention block, d 256, MQA at hd 64, window 32) in f32 on the
    card and on the CPU, from the same weights and the same trajectories:
    loss, diagnostics and gradient norms within 1e-4 relative (f32 on
    both sides; other libraries and summation orders through two layers),
    updated weights within 1e-2 · lr (Adam's first step is about lr ·
    sign(g); where |g| is near its eps the step follows g's rounding).
    The card's launches: flash forward attention layers x 2 x
    micro-batches (prox, then the loss), its backward attention layers x
    micro-batches; the scan RG-LRU layers x 2 x micro-batches, its
    gradient RG-LRU layers x micro-batches."""
    for arch in ("areal-qwen-1.5b", "recurrentgemma-9b"):
        small_train_step(torch, np, arch)


def small_train_step(torch, np, arch: str):
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.buffer import Trajectory
    from repro_torch.core.trainer import PPOTrainer
    from repro_torch.data import tokenizer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config(arch)), vocab_size=tokenizer.VOCAB_SIZE)
    rl = RLConfig(batch_size=8, answers_per_prompt=4, ppo_minibatches=2,
                  microbatch_token_budget=96, lr=1e-3, warmup_proportion=0.0)
    rng = np.random.default_rng(7)
    rewards = group_rewards(rng, list(range(8)), 4)
    lens = rng.integers(8, 40, size=8)
    trajs = [Trajectory(rid=i, prompt_id=i // 4, behavior_version=0,
                        prompt_tokens=rng.integers(3, cfg.vocab_size, 20).tolist(),
                        response_tokens=rng.integers(3, cfg.vocab_size, int(n)).tolist(),
                        behav_logprobs=(-4 * rng.random(int(n))).tolist(),
                        versions=[0] * int(n), reward=rewards[i])
             for i, n in enumerate(lens)]
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    res = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        trainer = PPOTrainer(m, rl)
        ops.reset_launches()
        met = trainer.train_step(trajs)
        res[name] = (met, [x["grad_norm"] for x in trainer.opt_metrics],
                     [p.detach().cpu() for p in m.parameters()], dict(ops.LAUNCHES))
    (mc, nc, pc, _), (mg, ng, pg, launches) = res["cpu"], res["cuda"]
    n_mb = mg.n_microbatches
    n_rec, n_attn = gpu.n_rec, gpu.n_attn
    require_launches(launches, {"flash_attention": n_attn * 2 * n_mb,
                                "flash_attention_bwd": n_attn * n_mb,
                                "linear_scan": n_rec * 2 * n_mb,
                                "linear_scan_bwd": n_rec * n_mb})
    tol = 1e-4
    pairs = [("loss", mc.loss, mg.loss)] + [(k, mc.diag[k], mg.diag[k]) for k in mc.diag] + \
        [(f"grad_norm[{i}]", a, b) for i, (a, b) in enumerate(zip(nc, ng))]
    err = 0.0
    for name, a, b in pairs:
        require(math.isfinite(b) and abs(a - b) <= tol * max(abs(a), 1e-3),
                f"small_train {name}: card {b} vs CPU {a}")
        err = max(err, abs(a - b) / max(abs(a), 1e-3))
    perr = max((a - b).abs().max().item() for a, b in zip(pc, pg))
    require(perr <= 1e-2 * rl.lr, f"small_train: updated weights differ by {perr}")
    require(mg.n_microbatches == mc.n_microbatches >= 2, "micro-batches differ")
    emit({"phase": "small_train", "config": cfg.name, "layers": list(gpu.kinds),
          "d_model": cfg.d_model, "head_dim": cfg.head_dim, "n_microbatches": n_mb,
          "loss": mg.loss, "grad_norms": ng, "max_rel_err": err, "tol": tol,
          "param_max_abs_err": perr, "param_tol": 1e-2 * rl.lr, "launches": launches})


def engine_probe(torch, engine):
    """The engine's logits of a fixed prompt, from its own model: one
    prefill, so one flash launch a layer (counted with the phase's)."""
    cache = engine.model.init_cache(1, 16, engine.dtype)
    toks = torch.arange(3, 15, device=engine.device)[None]
    return engine.model.prefill(toks, cache)[0]


def generate(engine, reqs, update=None):
    """Admit ``reqs`` and step until they finish; ``update`` = (step, fn)
    runs fn before that decode step.  Returns (finished by rid, decode
    steps, prefill calls)."""
    done, steps, prefills = {}, 0, 0
    if reqs:
        require(engine.admit(reqs) == len(reqs), "the engine did not take every request")
        prefills += 1
    while engine.n_active:
        if update is not None and steps == update[0]:
            update[1]()
            prefills += 1
        for f in engine.step():
            done[f.rid] = f
        steps += 1
        require(steps <= 2 * engine.max_gen_len, "requests did not finish")
    return done, steps, prefills


def train_phase(torch, np, profile: bool):
    """areal-qwen-1.5b at full width: a bf16 policy (m and v f32) behind
    the PPO trainer, and a copy of its initial weights behind the ring
    engine (bf16), which serves ``serve_paged``'s two prompts (471 and 323
    tokens) 16 times each (the reference's answers per prompt), 256 tokens
    per answer.  Algorithm 1 packs the 32 sequences of 727 and 579 tokens
    into micro-batches of 6144 (8 x 768) tokens, 6 to 10 segments in one
    row, two per PPO minibatch.  Rewards: seeded 0/1, both in each group.
    train_step on that batch; a second batch is
    admitted and decoded 64 steps; ``update_weights(trainer.params, 1)``
    interrupts it, and it finishes under version 1; a second train_step
    on it.  Every flash forward and backward of a train step is 28 x its
    calls; after the hand-off, the trainer's in-place updates never reach
    the engine's logits."""
    import dataclasses as _dc
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.core import batching
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.core.trainer import PPOTrainer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = get_model_config("areal-qwen-1.5b")
    L = cfg.n_layers
    t0 = time.perf_counter()
    policy = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    policy.init(torch.Generator(device="cuda").manual_seed(0))
    serving = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    serving.load_state_dict(policy.state_dict())
    group = 16
    rl = RLConfig(batch_size=2, answers_per_prompt=group, ppo_minibatches=2,
                  microbatch_token_budget=6144)
    trainer = PPOTrainer(policy, rl)
    n_req = 2 * group
    engine = RolloutEngine(serving, EngineConfig(n_slots=n_req, prompt_len=512, max_gen_len=256,
                                                 temperature=1.0, seed=0,
                                                 dtype=torch.bfloat16))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)                # serve_paged's prompts
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(256, 513, size=2)]
    batch_reqs = [[{"rid": off + g * group + j, "prompt_id": off + g, "answer": None,
                    "prompt": p} for g, p in enumerate(prompts) for j in range(group)]
                  for off in (0, n_req)]
    rrng = np.random.default_rng(3)
    torch.cuda.reset_peak_memory_stats()

    steps = []

    def timed_step(trajs, version):
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        met = trainer.train_step(trajs, current_version=version)
        ms = 1e3 * (time.perf_counter() - t)
        calls = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
        n_mb = met.n_microbatches
        require_launches(calls, {"flash_attention": L * 2 * n_mb,
                                 "flash_attention_bwd": L * n_mb, "decode_attention": 0})
        tm = trainer.timings
        norms = [m["grad_norm"] for m in trainer.opt_metrics]
        require(math.isfinite(met.loss) and all(math.isfinite(v) for v in met.diag.values()),
                f"train_step: loss {met.loss} or a diagnostic is not finite")
        require(all(math.isfinite(g) and g > 0 for g in norms), f"grad norms {norms}")
        segments = [len(g) for g in batching.dynamic_batching(
            [min(t.length, rl.microbatch_token_budget) for t in trajs],
            rl.microbatch_token_budget, rl.min_microbatches)]
        require(len(segments) == n_mb and min(segments) >= 2,
                f"micro-batches of {segments} sequences: the rows are not packed")
        steps.append({"ms": ms, "prepare_ms": 1e3 * tm["prepare"], "prox_ms": 1e3 * tm["prox"],
                      "segments_per_microbatch": segments,
                      "fwd_bwd_ms": [1e3 * x for x in tm["fwd_bwd"]],
                      "optimizer_ms": [1e3 * x for x in tm["optimizer"]],
                      "n_microbatches": n_mb, "n_tokens": met.n_tokens,
                      "trained_tokens_per_s": met.n_tokens / (ms / 1e3),
                      "loss": met.loss, "diag": met.diag, "grad_norms": norms,
                      "staleness_mean": met.staleness_mean, "launches": calls})
        return met

    ops.reset_launches()
    t = time.perf_counter()
    done1, steps1, prefills1 = generate(engine, batch_reqs[0])
    gen1_s = time.perf_counter() - t
    rewards = group_rewards(rrng, sorted(done1), group)
    before_w = [p.detach().clone() for p in policy.parameters()]
    timed_step(make_trajectories(done1, rewards), 1)
    # every matrix moves; a norm scale of ~1.0 may not: bf16's spacing there
    # (2^-7) is far above a step of lr = 2e-5, in the reference as here
    moved = [not torch.equal(a, b.detach()) for a, b in zip(before_w, policy.parameters())]
    require(all(m for m, p in zip(moved, before_w) if p.dim() >= 2),
            "train_step left a weight matrix unchanged")
    changed = f"{sum(moved)} of {len(moved)} tensors, every matrix"
    del before_w

    probe = {}

    def hand_off():
        require(engine.update_weights(trainer.params, 1), "update_weights was deferred")
        probe["logits"] = engine_probe(torch, engine)
    t = time.perf_counter()
    done2, steps2, prefills2 = generate(engine, batch_reqs[1], update=(64, hand_off))
    gen2_s = time.perf_counter() - t
    require(any(set(f.versions) == {0, 1} for f in done2.values()),
            "no trajectory of the second batch spans versions 0 and 1")
    rewards.update(group_rewards(rrng, sorted(done2), group))
    timed_step(make_trajectories(done2, rewards), 2)
    # the second step changed the trainer's weights in place: not the engine's
    require(torch.equal(engine_probe(torch, engine), probe["logits"]),
            "the trainer's in-place update reached the engine's weights")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the engine's prefills, then the two engine_probe prefills
    require_launches(launches, {"decode_attention": L * (steps1 + steps2),
                                "flash_attention": L * (prefills1 + prefills2 + 2)
                                + sum(s["launches"]["flash_attention"] for s in steps),
                                "flash_attention_bwd": sum(s["launches"]["flash_attention_bwd"]
                                                           for s in steps),
                                "paged_decode_attention": 0, "paged_prefill_attention": 0,
                                "fused_decode_tail": 0, "linear_scan": 0})
    rec = {"phase": "train", "model": cfg.name, "dtype": "bfloat16", "optimizer_state": "f32",
           "rl": {k: v for k, v in _dc.asdict(rl).items()
                  if k in ("batch_size", "answers_per_prompt", "ppo_minibatches",
                           "microbatch_token_budget", "lr", "clip_eps")},
           "prompt_lengths": [len(p) for p in prompts], "init_s": init_s,
           "generate_s": [gen1_s, gen2_s], "decode_steps": [steps1, steps2],
           "seq_lens": [sorted(len(f.prompt) + len(f.response) for f in d.values())
                        for d in (done1, done2)],
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done2.values()),
           "train_steps": steps, "params_changed_by_step_1": changed,
           "peak_memory_gb": peak_gb, "launches": launches,
           "hand_off": "engine logits unchanged by the trainer's later in-place update"}
    emit(rec)
    if profile:
        profile_train_phase(torch, trainer, make_trajectories(done2, rewards),
                            steps[-1]["ms"])
    return launches


# train_hybrid: recurrentgemma-9b at full width cut to 6 of its 38 layers,
# 2 x (rec, rec, local): 3.41 B parameters, whose bf16 weights and
# gradients and f32 m and v take ~41 GB (all 38 layers: ~125 GB)
HYBRID_TRAIN_LAYERS = 6
# tokens a micro-batch, cut from the train phase's 6144 (which ran out of
# the card's 80 GB here: 75 GB in use when a 5.9 GiB logits buffer was
# asked for): still longer than the window, one sequence of 2200-2400 a row
HYBRID_TRAIN_BUDGET = 4096
HYBRID_TRAIN_GROUP = 4            # answers a prompt; two prompts a batch


def run_engine(engine, reqs, update=None, limit: int = 2000):
    """Admit ``reqs`` and step until they finish (a chunked engine ingests
    one span a step); ``update(engine)`` runs before each step.  Returns
    the finished requests by rid."""
    done = {}
    require(engine.admit(reqs) == len(reqs), "the engine did not take every request")
    steps = 0
    while engine.n_active:
        if update is not None:
            update(engine)
        for f in engine.step():
            done[f.rid] = f
        steps += 1
        require(steps <= limit, "requests did not finish")
    return done


def train_hybrid_phase(torch, np):
    """The slice's path, the paper's loop on the RG-LRU hybrid:
    recurrentgemma-9b at full width (d 4096, MQA 16/1 at head_dim 256,
    lru 4096, d_ff 12288, vocab 256 000, window 2048), cut in depth to
    ``HYBRID_TRAIN_LAYERS`` = 2 x (rec, rec, local); a bf16 policy (f32 m
    and v) behind ``PPOTrainer`` and a bf16 copy behind the paged engine
    (blocks of 16, chunked prefill of 128, the fused decode tail).  Two
    GRPO groups of ``HYBRID_TRAIN_GROUP`` answers from prompts of
    2112-2303 tokens (past the window), 96 tokens each, packed by
    Algorithm 1 into micro-batches of ``HYBRID_TRAIN_BUDGET`` tokens (one
    sequence a row); a
    ``train_step``; a second batch whose decoding an
    ``update_weights(trainer.params, 1)`` interrupts (every history
    re-ingested under version 1); a second ``train_step``.  Launches over
    the phase: the fused tail and paged prefill 2 local layers x decode
    steps / ingest spans; the scan 4 RG-LRU layers x (spans + 2 x
    micro-batches + 2 probe prefills), its gradient 4 x micro-batches;
    flash forward 2 x (2 x micro-batches + 2 probes), its backward 2 x
    micro-batches."""
    import dataclasses as _dc
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.core.trainer import PPOTrainer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    full = get_model_config("recurrentgemma-9b")
    cfg = _dc.replace(full, n_layers=HYBRID_TRAIN_LAYERS)
    t0 = time.perf_counter()
    policy = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    policy.init(torch.Generator(device="cuda").manual_seed(0))
    serving = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    serving.load_state_dict(policy.state_dict())
    n_rec, n_attn = policy.n_rec, policy.n_attn
    require((n_rec, n_attn) == (4, 2), f"layer kinds {policy.kinds}")
    group = HYBRID_TRAIN_GROUP
    rl = RLConfig(batch_size=2, answers_per_prompt=group, ppo_minibatches=2,
                  microbatch_token_budget=HYBRID_TRAIN_BUDGET)
    trainer = PPOTrainer(policy, rl)
    n_req = 2 * group
    engine = RolloutEngine(serving, EngineConfig(
        n_slots=n_req, prompt_len=2304, max_gen_len=96, temperature=1.0, seed=0,
        dtype=torch.bfloat16, cache="paged", block_size=16, prefill_chunk=128,
        fused_decode="fused"))
    spans = count_ingests(engine)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(26)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(2112, 2304, size=2)]
    batch_reqs = [[{"rid": off + g * group + j, "prompt_id": off + g, "answer": None,
                    "prompt": p} for g, p in enumerate(prompts) for j in range(group)]
                  for off in (0, n_req)]
    rrng = np.random.default_rng(27)
    steps = []

    def timed_step(trajs, version):
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        met = trainer.train_step(trajs, current_version=version)
        ms = 1e3 * (time.perf_counter() - t)
        calls = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
        n_mb = met.n_microbatches
        require_launches(calls, {"flash_attention": n_attn * 2 * n_mb,
                                 "flash_attention_bwd": n_attn * n_mb,
                                 "linear_scan": n_rec * 2 * n_mb,
                                 "linear_scan_bwd": n_rec * n_mb,
                                 "fused_decode_tail": 0, "paged_prefill_attention": 0})
        tm = trainer.timings
        norms = [m["grad_norm"] for m in trainer.opt_metrics]
        require(math.isfinite(met.loss) and all(math.isfinite(v) for v in met.diag.values()),
                f"train_step: loss {met.loss} or a diagnostic is not finite")
        require(all(math.isfinite(g) and g > 0 for g in norms), f"grad norms {norms}")
        steps.append({"ms": ms, "prepare_ms": 1e3 * tm["prepare"], "prox_ms": 1e3 * tm["prox"],
                      "fwd_bwd_ms": [1e3 * x for x in tm["fwd_bwd"]],
                      "optimizer_ms": [1e3 * x for x in tm["optimizer"]],
                      "n_microbatches": n_mb, "n_tokens": met.n_tokens,
                      "trained_tokens_per_s": met.n_tokens / (ms / 1e3),
                      "loss": met.loss, "diag": met.diag, "grad_norms": norms,
                      "staleness_mean": met.staleness_mean, "launches": calls})
        return met

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    done1 = run_engine(engine, batch_reqs[0])
    gen1_s = time.perf_counter() - t
    rewards = group_rewards(rrng, sorted(done1), group)
    trajs1 = make_trajectories(done1, rewards)
    require(all(len(tr.prompt_tokens) > cfg.local_window for tr in trajs1),
            "a prompt does not reach past the window")
    timed_step(trajs1, 1)
    probe, start = {}, engine.decode_dispatches

    def hand_off(e):
        if e.decode_dispatches - start == 32 and not probe:
            require(e.update_weights(trainer.params, 1), "update_weights was deferred")
            probe["logits"] = engine_probe(torch, e)
            probe["dispatches"] = e.decode_dispatches
    t = time.perf_counter()
    done2 = run_engine(engine, batch_reqs[1], update=hand_off)
    gen2_s = time.perf_counter() - t
    require(probe and engine.stats()["interruptions"] >= 1, "no interrupting update")
    require(any(set(f.versions) == {0, 1} for f in done2.values()),
            "no trajectory of the second batch spans versions 0 and 1")
    rewards.update(group_rewards(rrng, sorted(done2), group))
    timed_step(make_trajectories(done2, rewards), 2)
    require(torch.equal(engine_probe(torch, engine), probe["logits"]),
            "the trainer's in-place update reached the engine's weights")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = engine.stats()
    mbs = sum(s["n_microbatches"] for s in steps)
    require_launches(launches, {
        "fused_decode_tail": n_attn * st["decode_dispatches"],
        "paged_prefill_attention": n_attn * spans["n"],
        "linear_scan": n_rec * (spans["n"] + 2 * mbs + 2),
        "linear_scan_bwd": n_rec * mbs,
        "flash_attention": n_attn * (2 * mbs + 2),
        "flash_attention_bwd": n_attn * mbs,
        "decode_attention": 0, "paged_decode_attention": 0})
    rec = {"phase": "train_hybrid", "model": cfg.name, "dtype": "bfloat16",
           "optimizer_state": "f32",
           "layers": {"used": cfg.n_layers, "of": full.n_layers, "kinds": list(policy.kinds),
                      "cut": "depth only: 2 x (rec, rec, local) of the 12 x + (rec, rec); "
                             "every width as published"},
           "params": sum(p.numel() for p in policy.parameters()),
           "params_full_depth": sum(p.numel() for p in build_model(
               full, device="meta").parameters()),
           "rl": {k: v for k, v in _dc.asdict(rl).items()
                  if k in ("batch_size", "answers_per_prompt", "ppo_minibatches",
                           "microbatch_token_budget", "lr", "clip_eps")},
           "engine": "paged, blocks of 16, chunked prefill of 128, fused decode tail",
           "prompt_lengths": [len(p) for p in prompts], "init_s": init_s,
           "generate_s": [gen1_s, gen2_s], "ingest_spans": spans["n"],
           "decode_dispatches": st["decode_dispatches"], "interruptions": st["interruptions"],
           "update_at_dispatch": probe["dispatches"] - start,
           "seq_lens": [sorted(len(f.prompt) + len(f.response) for f in d.values())
                        for d in (done1, done2)],
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done2.values()),
           "train_steps": steps, "memory_after_init_gb": init_gb, "peak_memory_gb": peak_gb,
           "launches": launches,
           "hand_off": "engine logits unchanged by the trainer's later in-place update"}
    emit(rec)
    return launches


def profile_train_phase(torch, trainer, trajs, step_ms: float):
    """Device time of one more train_step by kernel kind, from a
    torch.profiler trace, and the share of the unprofiled second step
    (``step_ms``) the card sat idle."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trajs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, busy, by_kind = device_time(torch, prof)
    rec = {"phase": "profile_train", "profiled_wall_ms": wall_ms, "kernels": len(kernels)}
    if kernels:
        rec.update(device_busy_ms=busy / 1e3, device_idle_share=1.0 - busy / 1e3 / step_ms,
                   device_ms_by_kind={k: v / 1e3 for k, v in by_kind.items() if v})
    else:
        rec["device_time"] = "not measured: the profiler recorded no CUDA kernels"
    emit(rec)


# examples/quickstart.py's arguments to run_training
QUICKSTART = dict(steps=12, eta=4, batch_size=32, answers_per_prompt=4, n_slots=16,
                  max_operand=9, lr=3e-4, seed=1)
LOOP_KERNELS = ("flash_attention", "decode_attention", "flash_attention_bwd")


class Call(NamedTuple):
    """One wrapped call: the object, its host wall and this thread's CPU
    seconds (``time.thread_time``: what the thread ran, without the time
    it waited for the interpreter lock or slept), the CUDA stream current
    on the calling thread, and what it moved (``before``/``after``)."""
    obj: object
    wall: float
    cpu: float
    stream: int
    before: object
    after: object


class CallCounter:
    """Every call of the engines' ``admit``, ``step``,
    ``_ingest_one_chunk`` and ``update_weights`` and of the trainer's
    ``train_step``, per object, with what each moved (decode dispatches,
    tokens, micro-batches and the trainer's section timings), its host
    wall and CPU seconds and its thread's current CUDA stream; and the
    time of each StepLog (``on_step``).  It wraps the classes' methods
    for the length of a ``with`` block, so ``run_training`` is called as
    a user calls it.  No synchronise: each engine step already waits for
    its sampled tokens and each ``train_step`` for its metrics, and the
    threaded runtime's two streams must not be made to wait for each
    other by the measurement.  With ``keep_every`` it also keeps a host
    copy of every ``keep_every``-th published version
    (``ParameterStore.publish``), to hold checkpoint spills against."""

    def __init__(self, torch, keep_every: int = 0):
        self.torch = torch
        self.calls = {"admit": [], "step": [], "ingest": [], "update_weights": [],
                      "train_step": []}
        self.step_logs = []
        self.first_call = None
        self.keep_every = keep_every
        self.published = {}

    def on_step(self, log) -> None:
        self.step_logs.append((log.version, time.perf_counter()))

    def _wrap(self, cls, name, key, record):
        orig = getattr(cls, name)
        current = self.torch.cuda.current_stream

        def wrapper(obj, *a, **kw):
            before = record(obj, None)
            stream = current().cuda_stream
            t, c = time.perf_counter(), time.thread_time()
            if self.first_call is None:
                self.first_call = t
            out = orig(obj, *a, **kw)
            self.calls[key].append(Call(obj, time.perf_counter() - t, time.thread_time() - c,
                                        stream, before, record(obj, out)))
            return out
        setattr(cls, name, wrapper)
        self._orig.append((cls, name, orig))

    def __enter__(self):
        from repro_torch.checkpoint import to_host
        from repro_torch.core.rollout import RolloutEngine
        from repro_torch.core.trainer import PPOTrainer
        from repro_torch.core.weights import ParameterStore
        self._orig = []
        self._wrap(RolloutEngine, "admit", "admit", lambda e, out: out)
        self._wrap(RolloutEngine, "step", "step",
                   lambda e, out: (e.decode_dispatches, e.tokens_generated))
        self._wrap(RolloutEngine, "_ingest_one_chunk", "ingest", lambda e, out: None)
        self._wrap(RolloutEngine, "update_weights", "update_weights",
                   lambda e, out: e.interruptions)
        self._wrap(PPOTrainer, "train_step", "train_step",
                   lambda t, out: None if out is None else (out.n_microbatches,
                                                            copy.deepcopy(t.timings)))
        publish = ParameterStore.publish

        def kept(store, version, model, meta=None):
            publish(store, version, model, meta)
            if self.keep_every and version % self.keep_every == 0:
                self.published[version] = to_host(store.get(version))
        ParameterStore.publish = kept
        self._orig.append((ParameterStore, "publish", publish))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._orig):
            setattr(cls, name, orig)
        return False

    def of(self, key, obj):
        return [c for c in self.calls[key] if c.obj is obj]

    def marks(self):
        """The first wrapped call's time, then each StepLog's."""
        return [self.first_call] + [t for _, t in self.step_logs]

    def want_launches(self, layers: int) -> dict:
        """Launches the counted calls make: per engine, a decode kernel a
        layer a decode dispatch (ring or paged) and a prefill kernel a
        layer a prefill (flash for each admission and each re-prefill of
        a monolithic engine, paged prefill for each span of a chunked
        paged one, none for a chunked ring one); per micro-batch, two
        flash forwards (prox and training) and one backward a layer."""
        want = {name: 0 for name in ("flash_attention", "flash_attention_bwd",
                                     "decode_attention", "paged_decode_attention",
                                     "paged_prefill_attention", "fused_decode_tail",
                                     "linear_scan")}
        engines = {id(c.obj): c.obj for key in ("admit", "step") for c in self.calls[key]}
        for eng in engines.values():
            paged = eng.cache_mode == "paged"
            decodes = sum(c.after[0] - c.before[0] for c in self.of("step", eng))
            want["paged_decode_attention" if paged else "decode_attention"] += layers * decodes
            if eng.prefill_chunk:
                # a ring-cache span runs the plain chunked attention: no kernel
                if paged:
                    want["paged_prefill_attention"] += layers * len(self.of("ingest", eng))
            else:
                admits = sum(1 for c in self.of("admit", eng) if c.after)
                want["flash_attention"] += layers * (admits + eng.interruptions)
        mbs = sum(c.after[0] for c in self.calls["train_step"] if c.after is not None)
        want["flash_attention"] += 2 * layers * mbs
        want["flash_attention_bwd"] += layers * mbs
        return want


def train_loop_run(torch, part: str, kw: dict, profile: bool = False, check=None):
    """``run_training`` on the card as a user calls it, its StepLogs one
    JSON line each, then a summary line; the loop's invariants checked
    and its kernel launches counted exactly.  ``check(ctl)`` adds a
    part's own checks, and returns fields for its summary line."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with CallCounter(torch) as calls:
        ops.reset_launches()
        t0 = time.perf_counter()
        ctl, trainer, reward = run_training("areal-qwen-1.5b", device="cuda",
                                            on_step=calls.on_step, log_every=1 << 30, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = trainer.model.cfg
    L = cfg.n_layers
    eng = ctl.engine
    steps = calls.of("step", eng)
    admits = calls.of("admit", eng)
    updates = calls.of("update_weights", eng)
    trains = calls.calls["train_step"]
    history = ctl.history
    eta = kw.get("eta", 4)
    versions = [h.version for h in history]
    require(versions == list(range(1, kw["steps"] + 1)), f"{part}: versions {versions}")
    require(all(h.staleness_max <= eta for h in history),
            f"{part}: staleness above {eta}: {[h.staleness_max for h in history]}")
    require(history[-1].interruptions >= 1, f"{part}: no weight update interrupted a request")
    require(all(math.isfinite(h.loss) for h in history),
            f"{part}: losses {[h.loss for h in history]}")
    require(eng.interruptions == history[-1].interruptions and len(trains) == len(history),
            f"{part}: the probe missed calls")
    # every decode step and prefill of every engine (the final eval's too) and
    # every micro-batch's prox forward, training forward and backward
    require_launches(launches, calls.want_launches(L))
    missing = [k for k in LOOP_KERNELS if not launches[k]]
    require(not missing, f"{part}: kernels never launched: {missing}")
    # from the loop's first admission: building the models is not a step's
    marks = calls.marks()
    for i, h in enumerate(history):
        sec, (mbs, tm) = trains[i].wall, trains[i].after
        emit({"phase": "train_loop", "part": part, "version": h.version, "clock": h.clock,
              "reward_mean": h.reward_mean, "accuracy": h.accuracy,
              "staleness_mean": h.staleness_mean, "staleness_max": h.staleness_max,
              "n_tokens": h.n_tokens, "gen_tokens_total": h.gen_tokens_total,
              "interruptions": h.interruptions, "loss": h.loss, "diag": h.diag,
              "step_wall_ms": 1e3 * (marks[i + 1] - marks[i]),
              "train_step_ms": 1e3 * sec, "n_microbatches": mbs,
              "prepare_ms": 1e3 * tm["prepare"], "prox_ms": 1e3 * tm["prox"],
              "fwd_bwd_ms": [1e3 * x for x in tm["fwd_bwd"]],
              "optimizer_ms": [1e3 * x for x in tm["optimizer"]]})
    step_s = sum(c.wall for c in steps)
    gen = sum(c.after[1] - c.before[1] for c in steps)
    rec = {"phase": "train_loop", "part": part, "model": cfg.name, "layers": L,
           "d_model": cfg.d_model, "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
           "dtype": str(trainer.model.dtype).replace("torch.", ""),
           "params": sum(p.numel() for p in trainer.model.parameters()),
           "args": kw, "wall_s": wall_s, "virtual_clock_s": ctl.clock,
           "steps": len(history), "engine_steps": len(steps), "engine_step_s": step_s,
           "engine_step_ms_mean": 1e3 * step_s / max(len(steps), 1),
           "generated_tokens": gen, "generated_tokens_per_s": gen / step_s,
           "admissions": len(admits), "admit_ms_mean": 1e3 * sum(c.wall for c in admits)
           / max(len(admits), 1),
           "update_weights_ms": [1e3 * c.wall for c in updates],
           "train_step_ms": [1e3 * c.wall for c in trains],
           "final_accuracy": reward.recent_accuracy,
           "staleness_hist": ctl.stal_stats.histogram(),
           "effective_throughput_tok_s": ctl.effective_throughput(),
           "peak_memory_gb": peak_gb, "launches": launches}
    ev = getattr(ctl, "final_eval", None)
    if ev is not None:
        rec["final_eval"] = {"n": ev.n, "n_correct": ev.n_correct, "mean_len": ev.mean_len,
                             "accuracy": ev.accuracy}
    if check is not None:
        rec.update(check(ctl))
    emit(rec)
    if profile:
        profile_loop_step(torch, ctl, 1e3 * (marks[-1] - marks[-2]), part)
    return launches


def profile_loop_step(torch, ctl, step_ms: float, part: str):
    """Device time of one more step of the loop (``ctl.run(1)``) by kernel
    kind, and the share of the last unprofiled step (``step_ms``) the card
    sat idle."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctl.run(1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, busy, by_kind = device_time(torch, prof)
    rec = {"phase": "profile_train_loop", "part": part, "profiled_wall_ms": wall_ms,
           "kernels": len(kernels)}
    if kernels:
        rec.update(device_busy_ms=busy / 1e3, device_idle_share=1.0 - busy / 1e3 / step_ms,
                   device_ms_by_kind={k: v / 1e3 for k, v in by_kind.items() if v})
    else:
        rec["device_time"] = "not measured: the profiler recorded no CUDA kernels"
    emit(rec)


def train_loop_phase(torch, profile: bool):
    """The virtual-clock training loop (``repro_torch.launch.train.
    run_training``) on the card: the quickstart twin (laptop scale, the
    final held-out eval included), 3 of its steps against the same run on
    the CPU, then areal-qwen-1.5b at full width for 3 steps (f32 weights,
    ring engine, 16 slots, prompts of 24 and 16 generated tokens,
    micro-batches of 256 tokens).  Returns the launches of the two
    parts that run as a user runs them."""
    laptop = train_loop_run(torch, "laptop", dict(QUICKSTART), profile)
    train_loop_cpu_parity(torch)
    multiturn = train_loop_multiturn(torch, profile)
    full = train_loop_run(torch, "full_width", dict(scale="pod", steps=3), profile)
    return {"laptop": laptop, "laptop_multiturn": multiturn, "full_width": full}


def train_loop_multiturn(torch, profile: bool):
    """``laptop_multiturn``: ``run_training(env="multiturn")`` at the
    quickstart's laptop scale for 3 steps, with 64 generated tokens a
    request (at 16 a first turn leaves room for the environment's reply
    only when it ends within 2 tokens).  The continuation turns chunked
    prefill on, on the ring cache: its spans run the plain chunked
    attention.  Requires continuations, and every trained multi-turn
    trajectory's environment tokens (logprob 0) masked out of the loss
    in the sequences the trainer packs (``PPOTrainer._prepare``)."""
    from repro_torch.core.trainer import PPOTrainer

    prepared = []
    prepare = PPOTrainer._prepare

    def recorded(trainer, batch):
        seqs = prepare(trainer, batch)
        prepared.append((list(batch), seqs))
        return seqs

    def check(ctl):
        eng = ctl.engine
        require(eng.continuation is not None and eng.cache_mode == "ring"
                and eng.prefill_chunk > 0, "the multi-turn loop is not on chunked ring ingest")
        require(eng.continuations > 0, "laptop_multiturn: no continuation")
        multi = masked = 0
        for batch, seqs in prepared:
            for t, seq in zip(batch, seqs):
                mask = (t.meta or {}).get("loss_mask")
                if mask is None:
                    continue
                multi += 1
                n_p = len(t.prompt_tokens)
                zeros = [k for k, m in enumerate(mask) if m == 0.0]
                require(zeros and all(t.behav_logprobs[k] == 0.0 for k in zeros),
                        f"rid {t.rid}: env tokens not marked")
                trained = seq["loss_mask"][n_p:]
                require(trained == [float(m) for m in mask][:len(trained)],
                        f"rid {t.rid}: the packed loss mask is not the env mask")
                masked += len(zeros)
        require(multi > 0, "laptop_multiturn: no multi-turn trajectory was trained")
        return {"continuations": eng.continuations,
                "continuation_tokens": eng.continuation_tokens,
                "multi_turn_trajectories_trained": multi, "env_tokens_masked": masked}

    PPOTrainer._prepare = recorded
    try:
        return train_loop_run(torch, "laptop_multiturn",
                              dict(QUICKSTART, steps=3, env="multiturn", max_gen_len=64),
                              profile, check=check)
    finally:
        PPOTrainer._prepare = prepare


def train_loop_cpu_parity(torch, steps: int = 3):
    """The quickstart's loop for ``steps`` steps on the card and on the CPU
    (the plain versions of the kernels), from one initialisation and one
    Gumbel noise: how far the card's run comes from the CPU's, StepLog by
    StepLog, and the final eval.  Reported, not required: Gumbel-max
    sampling turns a logit difference of f32 rounding into another token
    at a near-tie, and from there the runs part."""
    import dataclasses as _dc
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.data import tokenizer
    from repro_torch.launch.train import run_training
    from repro_torch.models.model import build_model

    seed = QUICKSTART["seed"]
    cfg = _dc.replace(reduced(get_model_config("areal-qwen-1.5b")),
                      vocab_size=tokenizer.VOCAB_SIZE)
    cfg = _dc.replace(cfg, name=cfg.name + "-math")
    tiny = torch.finfo(torch.float32).tiny

    def noise(step, shape):
        u = torch.rand(shape, generator=torch.Generator().manual_seed(1_000_003 * seed + step))
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    init = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        model.load_state_dict(init.state_dict())
        kw = {**QUICKSTART, "steps": steps}
        ctl, _, _ = run_training("areal-qwen-1.5b", device=dev, model=model, noise=noise,
                                 log_every=1 << 30, **kw)
        runs[dev] = ctl
    fields = ("n_tokens", "gen_tokens_total", "interruptions", "staleness_max",
              "reward_mean", "accuracy")
    per_step = [{"version": a.version,
                 "fields_equal": all(getattr(a, f) == getattr(b, f) for f in fields),
                 "clock_equal": a.clock == b.clock, "loss_abs_diff": abs(a.loss - b.loss)}
                for a, b in zip(runs["cpu"].history, runs["cuda"].history)]
    ea, eb = runs["cpu"].final_eval, runs["cuda"].final_eval
    emit({"phase": "train_loop", "part": "cpu_parity", "steps": steps, "per_step": per_step,
          "final_eval_equal": (ea.n_correct, ea.mean_len) == (eb.n_correct, eb.mean_len),
          "final_eval": {"cpu": [ea.n_correct, ea.mean_len],
                         "cuda": [eb.n_correct, eb.mean_len]}})


# ---- 11. the threaded runtime -------------------------------------------------

THREADED = dict(QUICKSTART, runtime="threaded", run_timeout=300)
THREADED_STEPS_FULL = 3
PROFILE_MIN_KERNELS = 1000
STREAMS_STEPS = 6


def weights_equal(torch, engine, trainer, atol: float = 0.0) -> float:
    """The largest absolute difference between the engine's weights and
    the trainer's; bitwise equality is required when ``atol`` is 0."""
    mine, theirs = engine.model.state_dict(), trainer.model.state_dict()
    require(list(mine) == list(theirs), "the engine's and trainer's state dicts differ")
    worst = 0.0
    for name, t in mine.items():
        if atol == 0.0:
            require(torch.equal(t, theirs[name]), f"engine weight {name} != trainer's")
        else:
            worst = max(worst, (t.double() - theirs[name].double()).abs().max().item())
    require(worst <= atol, f"engine weights off the trainer's by {worst} > {atol}")
    return worst


def call_times(calls, engine, trainer) -> dict:
    """Host wall and CPU milliseconds of the loop engine's steps and of
    the trainer's ``train_step``s.  Each call ends by waiting for its own
    stream (the sampled tokens, the step's metrics), so under two threads
    the wall also shows what the threads cost each other on the host.
    CPU is the calling thread's own time: a wall above it is time the
    thread did not run (waiting for the interpreter lock, or blocked in
    the CUDA runtime); a wait that spins on the card counts as CPU."""
    steps, trains = calls.of("step", engine), calls.of("train_step", trainer)

    def mean(xs):
        return 1e3 * sum(xs) / max(len(xs), 1)
    return {"engine_steps": len(steps),
            "engine_step_ms_mean": mean([c.wall for c in steps]),
            "engine_step_cpu_ms_mean": mean([c.cpu for c in steps]),
            "train_step_ms": [1e3 * c.wall for c in trains],
            "train_step_cpu_ms": [1e3 * c.cpu for c in trains]}


def step_walls(history, t0: float = 0.0):
    """Wall ms of each StepLog from the one before (the first from the
    run's start): the threaded runtime's StepLog clock is wall seconds."""
    clocks = [t0] + [h.clock for h in history]
    return [1e3 * (b - a) for a, b in zip(clocks, clocks[1:])]


def wall_summary(step_ms) -> dict:
    """A run's wall a step: over all its StepLogs, and steady (after the
    first, which also fills the pipeline and, in a fleet, starts its
    processes)."""
    return {"wall_per_step_ms": sum(step_ms) / len(step_ms),
            "steady_wall_per_step_ms": sum(step_ms[1:]) / max(len(step_ms) - 1, 1)}


def threaded_run(torch, part: str, kw: dict, *, serial_steps: int = 0, profile: bool = False,
                 keep_every: int = 0, check=None, walls=None):
    """``run_training(runtime="threaded")`` as a user calls it, its StepLogs
    and the runtime's overlap counters printed, the threaded invariants
    required (versions 1..n, staleness at most eta + 2, every trajectory
    consumed once, the engine's weights the trainer's, generation during
    training, launches = layers x calls); then, with ``serial_steps``,
    ``run_serial`` for that many steps on fresh objects built the same way
    (``run_training`` with 0 steps).  Returns the threaded run's launches;
    ``walls``, when given, gets ``wall_summary`` of each run under the
    part's name and its ``_serial`` twin."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training

    kw = dict(THREADED, **kw)
    steps, eta = kw["steps"], kw["eta"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with CallCounter(torch, keep_every) as calls:
        ops.reset_launches()
        t0 = time.perf_counter()
        ctl, trainer, reward = run_training("areal-qwen-1.5b", device="cuda",
                                            on_step=calls.on_step, log_every=1 << 30, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = trainer.model.cfg
    L = cfg.n_layers
    eng = ctl.engine
    history = ctl.history
    versions = [h.version for h in history]
    require(versions == list(range(1, steps + 1)), f"{part}: versions {versions}")
    require(max(h.staleness_max for h in history) <= eta + 2,
            f"{part}: staleness above eta + 2: {[h.staleness_max for h in history]}")
    require(ctl.buffer.total_consumed == steps * kw["batch_size"],
            f"{part}: consumed {ctl.buffer.total_consumed}, expected {steps * kw['batch_size']}")
    require(eng.version == trainer.version == steps,
            f"{part}: engine at {eng.version}, trainer at {trainer.version}")
    require(ctl.tokens_during_train > 0, f"{part}: no token was generated during a train_step")
    require(all(math.isfinite(h.loss) for h in history), f"{part}: losses not finite")
    # each loop's calls ran on its own stream, and the two are distinct
    rs, ts = (None if s is None else s.cuda_stream for s in (ctl.rollout_stream,
                                                             ctl.trainer_stream))
    on = {key: sorted({c.stream for c in calls.of(key, obj)})
          for key, obj in (("admit", eng), ("step", eng), ("train_step", trainer))}
    require(rs is not None and ts is not None and rs != ts and on["admit"] == [rs]
            and on["step"] == [rs] and on["train_step"] == [ts],
            f"{part}: calls ran on streams {on}, rollout {rs}, trainer {ts}")
    require_launches(launches, calls.want_launches(L))
    st = eng.stats()
    rec = {"phase": "threaded", "part": part, "model": cfg.name, "layers": L,
           "d_model": cfg.d_model, "dtype": str(trainer.model.dtype).replace("torch.", ""),
           "args": {k: v for k, v in kw.items()}, "wall_s": wall_s, "run_wall_s": ctl.clock,
           "step_wall_ms": step_walls(history),
           "wall_per_step_ms": 1e3 * ctl.clock / steps,
           "trainer_busy_s": ctl.trainer_busy_s,
           "trainer_busy_fraction": ctl.trainer_busy_s / ctl.clock,
           "tokens_during_train": ctl.tokens_during_train,
           "tokens_generated": st["tokens_generated"],
           "generated_tokens_per_s": st["tokens_generated"] / ctl.clock,
           **call_times(calls, eng, trainer),
           "staleness_max": [h.staleness_max for h in history],
           "interruptions": eng.interruptions,
           "publication": ctl.sched.publication_stats(),
           "stream_stats": eng.stream_stats(),
           "streams_sent": ctl.streams_sent,
           "peak_memory_gb": peak_gb, "launches": launches}
    if check is not None:
        rec.update(check(torch, ctl, trainer, calls) or {})
    else:
        weights_equal(torch, eng, trainer)
    if walls is not None:
        walls[part] = wall_summary(rec["step_wall_ms"])
    ev = getattr(ctl, "final_eval", None)
    if ev is not None:
        rec["final_eval"] = {"n": ev.n, "n_correct": ev.n_correct, "accuracy": ev.accuracy}
    emit(rec)
    if profile:
        profile_threaded_step(torch, ctl, part)
    svc = ctl.sched.reward_service
    if svc is not None:
        svc.close()
    ctl.store.close()
    # the counter holds the engines and the trainer: let them go
    del ctl, trainer, reward, eng, calls
    if serial_steps:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ctl, trainer, _ = run_training("areal-qwen-1.5b", device="cuda",
                                       log_every=1 << 30,
                                       **dict(kw, steps=0, final_eval=False))
        with CallCounter(torch) as calls:
            t0 = time.perf_counter()
            history = ctl.run_serial(serial_steps)
            torch.cuda.synchronize()
        require([h.version for h in history] == list(range(1, serial_steps + 1)),
                f"{part}: serial versions {[h.version for h in history]}")
        weights_equal(torch, ctl.engine, trainer)
        st = ctl.engine.stats()
        if walls is not None:
            walls[part + "_serial"] = wall_summary(step_walls(history))
        emit({"phase": "threaded", "part": part + "_serial", "steps": serial_steps,
              "wall_s": time.perf_counter() - t0, "run_wall_s": ctl.clock,
              "step_wall_ms": step_walls(history),
              "wall_per_step_ms": 1e3 * ctl.clock / serial_steps,
              "trainer_busy_fraction": ctl.trainer_busy_s / ctl.clock,
              "tokens_during_train": ctl.tokens_during_train,
              "generated_tokens_per_s": st["tokens_generated"] / ctl.clock,
              **call_times(calls, ctl.engine, trainer),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        ctl.store.close()
        del ctl, trainer, calls
    return launches


def profile_threaded_step(torch, ctl, part: str):
    """One more threaded step (``ctl.run(1)``) under torch.profiler: each
    CUDA stream's kernel time, and the device milliseconds during which
    kernels of the two busiest streams ran at once (the overlap on the
    card, beside the host's ``tokens_during_train``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    tokens = ctl.tokens_during_train
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctl.run(1, timeout=300)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    rec = {"phase": "profile_threaded", "part": part, "profiled_wall_ms": wall_ms,
           "kernels": len(kernels), "tokens_during_train": ctl.tokens_during_train - tokens}
    by_stream = {}
    for e in kernels:
        sid = getattr(e, "device_resource_id", None)
        by_stream.setdefault(sid, []).append((e.time_range.start, e.time_range.end))
    # the rollout and the trainer loops each queue thousands of kernels a
    # full-width step: both must show up, each on a stream of its own
    counts = sorted((len(v) for v in by_stream.values()), reverse=True)
    require(None not in by_stream and len(counts) >= 2 and counts[1] >= PROFILE_MIN_KERNELS,
            f"{part}: profiled kernels by stream {({str(k): len(v) for k, v in by_stream.items()})}"
            f": not two streams of at least {PROFILE_MIN_KERNELS} kernels")

    def union(spans):
        out = []
        for s, e in sorted(spans):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    busy = {sid: union(spans) for sid, spans in by_stream.items()}
    ms = {sid: sum(e - s for s, e in u) / 1e3 for sid, u in busy.items()}
    a, b = sorted(ms, key=ms.get, reverse=True)[:2]
    both, i, j = 0.0, 0, 0
    ua, ub = busy[a], busy[b]
    while i < len(ua) and j < len(ub):
        lo, hi = max(ua[i][0], ub[j][0]), min(ua[i][1], ub[j][1])
        both += max(0.0, hi - lo)
        if ua[i][1] < ub[j][1]:
            i += 1
        else:
            j += 1
    every = union([x for spans in by_stream.values() for x in spans])
    rec.update(stream_busy_ms={str(k): v for k, v in ms.items()},
               device_busy_ms=sum(e - s for s, e in every) / 1e3,
               overlap_ms=both / 1e3,
               kernels_by_stream={str(k): len(v) for k, v in by_stream.items()})
    emit(rec)


def threaded_phase(torch, profile: bool):
    """The threaded runtime (``run_training(runtime="threaded")``) on the
    card, the rollout and trainer threads each on its own CUDA stream:
    ``laptop`` (the quickstart's settings, 12 steps, ring cache, full
    publications; then ``run_serial`` on fresh objects), ``laptop_paged``
    (the same on the paged engine with chunked prefill of 8),
    ``streams`` (6 steps each under ``weight_stream="delta"`` and
    ``"delta-q"``), ``reward`` (``env="math"`` on 2 reward workers),
    ``ckpt`` (every 10th version spilled under ``build/``, each file read
    back) and ``full_width`` (areal-qwen-1.5b, f32, 3 threaded steps, then
    3 ``run_serial`` steps).  Returns each part's launches, and the walls a
    step of ``laptop`` and ``full_width`` and their serial twins."""
    import shutil
    from repro_torch.checkpoint import load

    walls = {}
    out = {"laptop": threaded_run(torch, "laptop", {}, serial_steps=QUICKSTART["steps"],
                                  walls=walls)}
    out["laptop_paged"] = threaded_run(torch, "laptop_paged",
                                       dict(cache="paged", prefill_chunk=8),
                                       serial_steps=QUICKSTART["steps"])

    def streamed(encoding):
        def check(torch, ctl, trainer, calls):
            st = ctl.engine.stream_stats()
            sent = ctl.streams_sent
            require(st["streams_completed"] == len(sent) == STREAMS_STEPS
                    and st["streams_torn"] == 0,
                    f"streams {encoding}: {st}, {len(sent)} sent")
            # a delta-q version decodes against the engine's last (itself
            # quantized) version, so the errors of the versions add up
            tol = sum(s["tolerance"] for s in sent) + 1e-6 if encoding == "delta-q" else 0.0
            err = weights_equal(torch, ctl.engine, trainer, atol=tol)
            return {"chunks_per_version": [s["n_chunks"] for s in sent],
                    "bytes_per_version": [s["nbytes"] for s in sent],
                    "tolerance_sum": tol, "max_abs_err": err}
        return check

    for enc in ("delta", "delta-q"):
        out[f"streams_{enc}"] = threaded_run(
            torch, f"streams_{enc}", dict(steps=STREAMS_STEPS, weight_stream=enc,
                                          final_eval=False), check=streamed(enc))

    def reward_check(torch, ctl, trainer, calls):
        svc = ctl.sched.reward_service
        weights_equal(torch, ctl.engine, trainer)
        st = svc.stats()
        require(st["n_scored"] >= ctl.buffer.total_consumed and st["n_errors"] == 0,
                f"reward service: {st}")
        return {"reward_service": st}
    out["reward"] = threaded_run(torch, "reward", dict(env="math", reward_workers=2),
                                 check=reward_check)

    ckpt_dir = ROOT / "build" / "threaded_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def ckpt_check(torch, ctl, trainer, calls):
        weights_equal(torch, ctl.engine, trainer)
        ctl.store.flush()
        want = QUICKSTART["steps"] // 10
        require(ctl.store.spills == want and sorted(calls.published) == [10 * (i + 1)
                                                                         for i in range(want)],
                f"ckpt: {ctl.store.spills} spills, kept {sorted(calls.published)}")
        like = trainer.model.state_dict()
        files = []
        for v, host in calls.published.items():
            path = ckpt_dir / f"v{v:06d}.npz"
            got, _, meta = load(str(path), like)
            require(meta.get("version") == v, f"ckpt: {path.name} meta {meta}")
            for name, t in got.items():
                require(torch.equal(t.cpu(), torch.from_numpy(host[name])),
                        f"ckpt: {path.name} {name} differs from the published weights")
            files.append(path.name)
        return {"ckpt_files": files, "spills": ctl.store.spills}
    out["ckpt"] = threaded_run(torch, "ckpt", dict(ckpt_dir=str(ckpt_dir)), keep_every=10,
                               check=ckpt_check)
    out["full_width"] = threaded_run(torch, "full_width",
                                     dict(scale="pod", steps=THREADED_STEPS_FULL),
                                     serial_steps=THREADED_STEPS_FULL, profile=profile,
                                     walls=walls)
    return out, walls


FLEET = dict(QUICKSTART, runtime="fleet", run_timeout=600)
FLEET_STEPS_FULL = 3


class FleetProbe:
    """What phase 12 reads around ``run_training(runtime="fleet")``, for
    the length of a ``with`` block: the ``FleetRuntime`` (``ctl``, as soon
    as it runs), the wall of each train round trip (the pump's
    ``_train_remote``: shipping the batch and state to the replica, its
    step, the reply), the rids each ``train_step`` consumed, and, sampled
    every half second, the largest device memory ``nvidia-smi
    --query-compute-apps`` lists (in a container every process may be
    listed under one pid with the card's whole use, so entries are not
    summed) and this (the supervisor's) process's resident set."""

    def __init__(self):
        self.ctl = None
        self.round_trips = []
        self.consumed = []
        self.smi_peak_mib = 0
        self.peak_rss_bytes = 0
        self._stop = None

    def _sample(self):
        from repro_torch.core.fleet import proc_status_bytes
        while not self._stop.wait(0.5):
            self.peak_rss_bytes = max(self.peak_rss_bytes, proc_status_bytes("VmRSS"))
            out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30)
            used = [int(mib) for _, _, mib in (line.partition(",") for line in
                                               out.stdout.strip().splitlines())
                    if mib.strip().isdigit()]
            self.smi_peak_mib = max([self.smi_peak_mib] + used)

    def __enter__(self):
        import threading
        from repro_torch.core.fleet import FleetRuntime
        from repro_torch.core.scheduler import AsyncScheduler

        self._orig = [(FleetRuntime, "run", FleetRuntime.run),
                      (FleetRuntime, "_train_remote", FleetRuntime._train_remote),
                      (AsyncScheduler, "record_consumed", AsyncScheduler.record_consumed)]
        run, remote, consumed = (o for _, _, o in self._orig)

        def run_(rt, *a, **kw):
            self.ctl = rt
            return run(rt, *a, **kw)

        def remote_(rt, batch):
            t0 = time.perf_counter()
            out = remote(rt, batch)
            self.round_trips.append(time.perf_counter() - t0)
            return out

        def consumed_(sched, batch):
            self.consumed.extend(t.rid for t in batch)
            return consumed(sched, batch)
        FleetRuntime.run, FleetRuntime._train_remote = run_, remote_
        AsyncScheduler.record_consumed = consumed_
        self._stop = threading.Event()
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._sampler.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._sampler.join(35.0)
        for cls, name, orig in self._orig:
            setattr(cls, name, orig)
        return False


def fleet_launches(L: int, role: str, st: dict) -> dict:
    """The launches a worker's counters account for: a rollout worker's
    flash forward a layer a prefill (each admission that took requests
    and each interrupting re-prefill) and decode a layer a decode step;
    a trainer replica's two flash forwards (prox and training) and one
    backward a layer a micro-batch."""
    want = {k: 0 for k in REPLACES}
    if role == "rollout":
        want["flash_attention"] = L * (st["admits"] + st["interruptions"])
        want["decode_attention"] = L * st["decode_dispatches"]
    else:
        want["flash_attention"] = 2 * L * st["microbatches"]
        want["flash_attention_bwd"] = L * st["microbatches"]
    return want


def host_memory() -> dict:
    """MemTotal and MemAvailable of the host, GB (``/proc/meminfo``)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in ("MemTotal", "MemAvailable"):
                info[key] = int(rest.split()[0]) * 1024 / 1e9
    return info


def fleet_run(torch, part: str, kw: dict, walls: dict, *, strike=None) -> dict:
    """``run_training(runtime="fleet")`` on the card as a user calls it:
    the supervisor here, the rollout workers and the trainer replica as
    processes of their own on the same card.  Requires versions 1..n,
    staleness at most eta + 2, every trajectory consumed once, finite
    losses, no respawn (unless ``strike`` kills a worker), each cleanly
    stopped worker's launches equal to layers x its calls, flash and
    decode launched in the rollout processes and flash forward and
    backward in the trainer's.  ``strike(probe)`` runs on a thread beside
    the run.  Returns (the part's record, the launches summed over the
    worker processes)."""
    import threading
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training

    kw = dict(FLEET, **kw)
    steps, eta, batch = kw["steps"], kw["eta"], kw["batch_size"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem_before = host_memory()
    struck = {}
    with FleetProbe() as probe:
        if strike is not None:
            threading.Thread(target=strike, args=(probe, struck), daemon=True).start()
        ops.reset_launches()
        t0 = time.perf_counter()
        ctl, trainer, reward = run_training("areal-qwen-1.5b", device="cuda",
                                            log_every=1 << 30, **kw)
        wall_s = time.perf_counter() - t0
        supervisor_launches = dict(ops.LAUNCHES)
    cfg = get_model_config("areal-qwen-1.5b")
    if kw.get("scale", "laptop") == "laptop":
        cfg = reduced(cfg)
    L = cfg.n_layers
    history = ctl.history
    versions = [h.version for h in history]
    require(versions == list(range(1, steps + 1)), f"fleet {part}: versions {versions}")
    require(max(h.staleness_max for h in history) <= eta + 2,
            f"fleet {part}: staleness above eta + 2: {[h.staleness_max for h in history]}")
    require(len(probe.consumed) == steps * batch == ctl.buffer.total_consumed
            and len(set(probe.consumed)) == len(probe.consumed),
            f"fleet {part}: consumed {len(probe.consumed)} ({len(set(probe.consumed))} "
            f"distinct), expected {steps * batch}")
    require(all(math.isfinite(h.loss) for h in history), f"fleet {part}: losses not finite")
    require(ctl.duplicates_dropped == 0, f"fleet {part}: {ctl.duplicates_dropped} duplicates")
    if strike is None:
        require(ctl.respawns == 0, f"fleet {part}: {ctl.respawns} respawns")
    procs, summed = [], {k: 0 for k in REPLACES}
    by_role = {role: {k: 0 for k in REPLACES} for role in ("rollout", "trainer")}
    for h in ctl.registry.workers():
        st = h.last_stats
        launches = {k: st.get(f"launches.{k}", 0) for k in REPLACES}
        for k, n in launches.items():
            summed[k] += n
        clean = h.state == "stopped" and not any(
            e["worker"] == h.worker_id for e in ctl.registry.events_of("worker-dead"))
        if clean:
            # a worker that stopped cleanly sent its counters from its main
            # loop: they are one consistent snapshot
            want = fleet_launches(L, h.role, st)
            require(launches == want, f"fleet {part}: {h.worker_id} launched {launches}, "
                                      f"its calls account for {want}")
        for k, n in launches.items():
            by_role[h.role][k] += n
        procs.append({
            "worker": h.worker_id, "role": h.role, "pid": st.get("pid"), "clean_stop": clean,
            "launches": {k: n for k, n in launches.items() if n},
            "threads": st.get("threads"), "max_gap_s": h.max_gap, "beats": h.beats,
            "peak_device_gb": st.get("max_memory_allocated", 0) / 1e9,
            "peak_rss_gb": st.get("peak_rss_bytes", 0) / 1e9,
            "bytes_to_worker": h.transport.bytes_sent,
            "bytes_from_worker": h.transport.bytes_received,
            **{k: st[k] for k in ("steps", "admits", "interruptions", "decode_dispatches",
                                  "tokens_generated", "microbatches", "step_s") if k in st}})
    # each role's kernels ran in that role's processes
    missing = [(role, k) for role, ks in (("rollout", ("flash_attention", "decode_attention")),
                                          ("trainer", ("flash_attention", "flash_attention_bwd")))
               for k in ks if not by_role[role][k]]
    require(not missing, f"fleet {part}: kernels never launched in their processes: {missing}")
    tokens = ctl.registry.total("tokens_generated")
    rec = {"phase": "fleet", "part": part, "model": cfg.name, "layers": L,
           "d_model": cfg.d_model, "args": kw, "wall_s": wall_s, "run_wall_s": ctl.clock,
           "step_wall_ms": step_walls(history), **wall_summary(step_walls(history)),
           "trainer_busy_s": ctl.trainer_busy_s,
           "trainer_busy_fraction": ctl.trainer_busy_s / ctl.clock,
           "tokens_during_train": ctl.tokens_during_train,
           "tokens_generated": tokens, "generated_tokens_per_s": tokens / ctl.clock,
           "round_trip_ms": [1e3 * x for x in probe.round_trips],
           "staleness_max": [h.staleness_max for h in history],
           "respawns": ctl.respawns, "requeued": ctl.requeued,
           "publication": ctl.sched.publication_stats(),
           "processes": procs, "supervisor_launches": supervisor_launches,
           "host_cores": os.cpu_count(), "host_memory_gb_before": mem_before,
           "smi_compute_apps_peak_mib": probe.smi_peak_mib,
           "supervisor_peak_rss_gb": probe.peak_rss_bytes / 1e9,
           "host_peak_rss_sum_gb": (probe.peak_rss_bytes
                                    + sum(p["peak_rss_gb"] for p in procs) * 1e9) / 1e9,
           "launches": summed}
    rec["heartbeat_timeout_s"] = ctl.heartbeat_timeout
    # a train round trip: the replica's copy of the shipped state into its
    # tensors, its train_step, its host copy of the reply, and the rest:
    # pickling, the socket both ways, unpickling
    trainer_st = [p for p in procs if p["role"] == "trainer" and p.get("step_s")]
    if trainer_st and len(trainer_st[0]["step_s"]) == len(probe.round_trips):
        rec["round_trip_split_ms"] = [
            {"round_trip": 1e3 * rt, "replica_load": 1e3 * a, "replica_train_step": 1e3 * b,
             "replica_host_copy": 1e3 * c, "shipping": 1e3 * (rt - a - b - c)}
            for rt, (a, b, c) in zip(probe.round_trips, trainer_st[0]["step_s"])]
    rec["bytes_per_step_to_trainer"] = sum(
        p["bytes_to_worker"] for p in procs if p["role"] == "trainer") / steps
    rec["bytes_per_step_from_trainer"] = sum(
        p["bytes_from_worker"] for p in procs if p["role"] == "trainer") / steps
    rec["bytes_per_version_to_each_rollout_worker"] = {
        p["worker"]: p["bytes_to_worker"] / steps for p in procs if p["role"] == "rollout"}
    ev = getattr(ctl, "final_eval", None)
    if ev is not None:
        rec["final_eval"] = {"n": ev.n, "n_correct": ev.n_correct, "accuracy": ev.accuracy}
    for name in ("laptop", "laptop_serial", "full_width", "full_width_serial"):
        if name.startswith("laptop") == (kw.get("scale", "laptop") == "laptop") and name in walls:
            rec[f"phase11_{name}"] = walls[name]
    if struck:
        rec.update(struck_record(ctl, struck))
    ctl.store.close()
    return rec, summed


def kill_in_flight(probe, struck):
    """``kill``'s strike: once a version is published, SIGKILL the first
    rollout worker that has beaten and holds requests in flight, and note
    when.  Its replacement gets the supervisor's full weights when it
    registers."""
    import signal
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        ctl = probe.ctl
        for h in ([] if ctl is None else ctl.registry.ready("rollout")):
            if ctl.version >= 1 and h.beats > 0 and ctl.sched.inflight_of(h.worker_id):
                struck.update(worker=h.worker_id, pid=h.proc.pid,
                              inflight=len(ctl.sched.inflight_of(h.worker_id)),
                              t=time.monotonic())
                os.kill(h.proc.pid, signal.SIGKILL)
                return
        time.sleep(0.01)


def struck_record(ctl, struck) -> dict:
    """``kill``'s checks: the victim died as crashed and was replaced, its
    requests were requeued, none twice; the seconds from the kill to the
    replacement's first message, and the flight recorder's dump."""
    events = ctl.registry.events
    dead = [e for e in events if e["kind"] == "worker-dead" and e["worker"] == struck["worker"]]
    require(dead and dead[0]["reason"] == "crashed", f"fleet kill: {struck['worker']}: {dead}")
    require(ctl.respawns >= 1 and ctl.requeued >= 1,
            f"fleet kill: respawns {ctl.respawns}, requeued {ctl.requeued}")
    requeued = [rid for e in events if e["kind"] == "requeue" for rid in e["rids"]]
    require(len(requeued) == len(set(requeued)), f"fleet kill: requeued twice: {requeued}")
    after = [e for e in events if e["kind"] == "spawn" and e["role"] == "rollout"
             and e["t"] > struck["t"]]
    require(after, "fleet kill: no replacement was spawned")
    first = [e["t"] for e in events if e["kind"] == "register" and e["worker"] ==
             after[0]["worker"]]
    dumps = [e["path"] for e in events if e["kind"] == "flightrec-dump"
             and e["worker"] == struck["worker"]]
    return {"killed": {k: v for k, v in struck.items() if k != "t"},
            "replacement": after[0]["worker"],
            "kill_to_replacement_first_message_s": (
                first[0] - struck["t"] if first else "not measured: the run ended before "
                "the replacement's first message"),
            "requeued_rids": requeued, "flightrec_dump": dumps}


# phase 12's parts: run_training's arguments beyond FLEET, and a strike
FLEET_PARTS = {
    "laptop": ({}, None),
    "laptop_1w": (dict(rollout_workers=1), None),
    "kill": (dict(rollout_workers=1), kill_in_flight),
    "full_width": (dict(scale="pod", steps=FLEET_STEPS_FULL, rollout_workers=1), None),
}


def fleet_phase(torch, walls: dict) -> dict:
    """The process fleet (``run_training(runtime="fleet")``) on the card:
    ``laptop`` (the quickstart's settings, 2 rollout workers and a trainer
    replica), ``laptop_1w`` (1 rollout worker: one engine of 16 slots and
    one trainer, as phase 11's ``laptop`` and its serial twin, whose walls
    it prints beside its own), ``kill`` (``laptop_1w`` with its rollout
    worker SIGKILLed while it holds requests: with two, the survivor ends
    the 12 steps before a new process is up) and ``full_width``
    (areal-qwen-1.5b, f32, 1 rollout worker, 3 steps, with the
    module's default heartbeat timeout).  Returns each part's launches,
    summed over the worker processes."""
    out = {}
    for part, (kw, strike) in FLEET_PARTS.items():
        rec, out[part] = fleet_run(torch, part, kw, walls, strike=strike)
        emit(rec)
    return out


KINDS = (("paged_decode_attention", ("paged_decode_kernel",)),
         ("fused_decode_tail", ("fused_decode_tail_",)),
         ("paged_prefill_attention", ("paged_prefill_",)),
         ("flash_attention", ("flash_fwd_",)),
         ("flash_attention_bwd", ("bwd_prep_", "bwd_dkdv_", "bwd_reduce_", "bwd_dq_",
                                  "bwd_kernel")),
         ("decode_attention", ("ring_decode_",)),
         ("linear_scan", ("linear_scan_kernel",)),
         ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")))


def device_time(torch, prof):
    """(kernels, busy us, us by kind) of a torch.profiler trace: the
    union of the kernels' intervals, and their time by ``KINDS``."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind = {k: 0.0 for k, _ in KINDS}
    by_kind["other"] = 0.0
    spans = []
    for e in kernels:
        spans.append((e.time_range.start, e.time_range.end))
        kind = next((k for k, keys in KINDS if any(s in e.name for s in keys)), "other")
        by_kind[kind] += e.time_range.end - e.time_range.start
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):               # union of kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    return kernels, busy, by_kind


def profile_phase(torch, name, engine, reqs, step_ms: float, steps: int = 8):
    """Device time of a few decode steps of phase ``name``'s engine by
    kernel kind, from a torch.profiler trace, and the share of an
    unprofiled decode step (``step_ms``, from that phase) that the card
    sat idle; the profiler slows the host, so its own wall time is
    reported apart.  A chunked engine ingests its new prompts first."""
    from torch.profiler import ProfilerActivity, profile

    engine.admit([dict(r, rid=100 + r["rid"]) for r in reqs])
    while engine.ingest_backlog_tokens():
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels, busy, by_kind = device_time(torch, prof)
    rec = {"phase": "profile", "of": name, "decode_steps": steps,
           "profiled_wall_ms_per_step": wall_us / steps / 1e3,
           "kernels_per_step": len(kernels) / steps}
    if kernels:
        rec.update(device_busy_ms_per_step=busy / steps / 1e3,
                   device_idle_share=1.0 - busy / steps / 1e3 / step_ms,
                   device_ms_per_step_by_kind={k: v / steps / 1e3 for k, v in by_kind.items()})
    else:
        rec["device_time"] = "not measured: the profiler recorded no CUDA kernels"
    emit(rec)


def profile_prefill_phase(torch, engine, reqs, prefill_ms: float):
    """Device time of one admission prefill of ``reqs`` into a fresh
    engine of ``engine``'s model and configuration, by kernel kind (the
    linear scan's share of a hybrid prefill), and the share of the
    unprofiled admission (``prefill_ms``) the card sat idle."""
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops
    from torch.profiler import ProfilerActivity, profile

    fresh = RolloutEngine(engine.model, engine.engine_config)
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fresh.admit(reqs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    scans = ops.LAUNCHES["linear_scan"] - before["linear_scan"]
    kernels, busy, by_kind = device_time(torch, prof)
    rec = {"phase": "profile_prefill", "of": "serve_hybrid", "prefill_rows": len(reqs),
           "profiled_wall_ms": wall_ms, "kernels": len(kernels), "linear_scan_launches": scans}
    if kernels:
        rec.update(device_busy_ms=busy / 1e3, device_idle_share=1.0 - busy / 1e3 / prefill_ms,
                   device_ms_by_kind={k: v / 1e3 for k, v in by_kind.items() if v},
                   linear_scan_share_of_busy=by_kind["linear_scan"] / busy)
    else:
        rec["device_time"] = "not measured: the profiler recorded no CUDA kernels"
    emit(rec)


# ---------------------------------------------------------------------------
# mixture of experts and the VLM prefix
# ---------------------------------------------------------------------------

# the attention shapes the MoE and VLM paths give the kernels, hd 128:
# olmoe-1b-7b (MHA 16/16: group 1), qwen3-moe-235b-a22b (64 over 4: group
# 16, H * hd 8192), internvl2-2b (16 over 8) with its 256-token prefix
MOE_FLASH = [("olmoe-1b-7b prefill, group 1", 8, 512, 16, 16),
             ("internvl2-2b prefix 256 + prompt 512, group 2", 4, 768, 16, 8),
             ("qwen3-moe-235b-a22b prefill, group 16", 8, 512, 64, 4)]
MOE_DECODE = [("olmoe-1b-7b ring decode, group 1", 8, 16, 16, 768),
              ("qwen3-moe-235b-a22b ring decode, group 16", 8, 64, 4, 576)]
# label, b, h, hkv, bs, entries, t range, d_model (the tail's wo)
MOE_PAGED = [("olmoe-1b-7b, group 1", 8, 16, 16, 16, 48, (512, 768), 2048),
             ("qwen3-moe-235b-a22b, group 16", 8, 64, 4, 16, 36, (512, 576), 4096)]
# label, c, h, hkv, bs, entries, the span's last position
MOE_SPANS = [("olmoe-1b-7b chunk of 128, group 1", 128, 16, 16, 16, 48, 383),
             ("qwen3-moe-235b-a22b chunk of 128, group 16", 128, 64, 4, 16, 36, 511)]
MOE_HD = 128


def moe_kernel_phase(torch, np, quick: bool):
    """Every attention kernel of the MoE and VLM paths at the shapes those
    paths give it (head_dim 128 at groups 1, 2 and 16; the fused tail at
    olmoe's ``wo`` 2048 x 2048 with 16 heads and at qwen3-moe's 8192 x
    4096 with 64 heads, the wrapper's ``MAX_HEADS`` and ``MAX_CONTEXT``),
    in bf16 and f32 against their plain versions, every decode call twice
    bitwise equal; timed in bf16 beside the bound, the plain version and
    SDPA (plus ``matmul(wo)`` for the tail, and paged decode plus
    ``matmul(wo)``, the unfused route).  Returns {kernel: [records]}."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_decode_tail as ft
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
    from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda

    rng = np.random.default_rng(27)
    timer = None if quick else Timer(torch)
    hd = MOE_HD
    out = {n: [] for n in ("flash_attention", "decode_attention", "paged_decode_attention",
                           "paged_prefill_attention", "fused_decode_tail")}
    cuda = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", dt)
    dev_i = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()

    def finish(name, rec, timed):
        if timed is not None:
            flops, byts, fns = timed
            rec.update(ms=timer(fns["kernel"]), plain_ms=timer(fns["plain"]),
                       library_ms=timer(fns["library"]), flops=flops, bytes=byts,
                       **bound(flops, byts, rec["dtype"]))
            if "unfused" in fns:
                rec["paged_decode_plus_matmul_ms"] = timer(fns["unfused"])
            out[name].append(rec)
        emit(rec)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        timed = timer is not None and dn == "bfloat16"
        for label, b, s, h, hkv in MOE_FLASH:
            q, k, v, seg = flash_inputs(torch, np, rng, dtype, b, s, h, hkv, hd)
            case = f"{label}: B={b} S={s} H={h} Hkv={hkv} hd={hd}"
            got = flash_attention_cuda(q, k, v, seg, causal=True)
            want = ref.flash_attention(q, k, v, segment_ids=seg, causal=True)
            torch.cuda.synchronize()
            rec = {"phase": "moe_kernel", "name": "flash_attention", "dtype": dn, "case": case,
                   "max_abs_err": check("flash_attention", got, want, dn, case), "tol": TOL[dn]}
            t = None
            if timed:
                mask = flash_mask(torch, seg, s, 0)
                flops = 4.0 * hd * h * mask.sum().item()
                qx, kx, vx = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                t = (flops, nbytes(q, k, v, seg, got), {
                    "kernel": lambda: flash_attention_cuda(q, k, v, seg, causal=True),
                    "plain": lambda: ref.flash_attention(q, k, v, segment_ids=seg),
                    "library": lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)})
            finish("flash_attention", rec, t)
        for label, b, h, hkv, w in MOE_DECODE:
            q, kc, vc, pos, tt = decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, w)
            case = f"{label}: B={b} W={w} H={h} Hkv={hkv} hd={hd}"
            got = decode_attention_cuda(q, kc, vc, pos, tt)
            again = decode_attention_cuda(q, kc, vc, pos, tt)
            want = ref.decode_attention(q, kc, vc, pos, tt)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"decode_attention {case}: two calls differ")
            rec = {"phase": "moe_kernel", "name": "decode_attention", "dtype": dn, "case": case,
                   "max_abs_err": check("decode_attention", got, want, dn, case),
                   "tol": TOL[dn]}
            t = None
            if timed:
                valid = decode_mask(pos, tt, 0)
                n_valid = valid.sum().item()
                mask, qx = valid[:, None, None, :], q[:, :, None, :]
                kx, vx = kc.transpose(1, 2), vc.transpose(1, 2)
                t = (4.0 * hd * h * n_valid,
                     2 * n_valid * hkv * hd * kc.element_size() + nbytes(pos, tt, q, got), {
                         "kernel": lambda: decode_attention_cuda(q, kc, vc, pos, tt),
                         "plain": lambda: ref.decode_attention(q, kc, vc, pos, tt),
                         "library": lambda: F.scaled_dot_product_attention(
                             qx, kx, vx, attn_mask=mask, enable_gqa=True)})
            finish("decode_attention", rec, t)
        for label, b, h, hkv, bs, entries, (t_lo, t_hi), dm in MOE_PAGED:
            kp, vp, tab, tpos = window_pool(np, rng, b, hkv, hd, bs, entries, t_lo, t_hi)
            q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
            wo = cuda(rng.standard_normal((h * hd, dm), dtype=np.float32) * (h * hd) ** -0.5,
                      dtype)
            kp, vp, tab, tpos = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(tpos)
            case = (f"{label}: B={b} H={h} Hkv={hkv} hd={hd} bs={bs} E={entries} "
                    f"t in [{t_lo}, {t_hi})")
            flops, kv_bytes, vis, kg = span_attention_cost(torch, kp, tab, tpos[:, None], h, hd,
                                                           0)
            _, vg, _ = ref.gather_pool(kp, vp, tab)
            qx, kx, vx = q[:, :, None, :], kg.transpose(1, 2), vg.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(qx, kx, vx, attn_mask=vis,
                                                          enable_gqa=True)
            if h == hkv:          # paged decode on the unfused route: olmoe's shape
                got = paged_decode_attention_cuda(q, kp, vp, tab, tpos)
                again = paged_decode_attention_cuda(q, kp, vp, tab, tpos)
                want = ref.paged_decode_attention(q, kp, vp, tab, tpos)
                torch.cuda.synchronize()
                require(torch.equal(got, again),
                        f"paged_decode_attention {case}: two calls differ")
                rec = {"phase": "moe_kernel", "name": "paged_decode_attention", "dtype": dn,
                       "case": case, "tol": TOL[dn],
                       "max_abs_err": check("paged_decode_attention", got, want, dn, case)}
                t = None
                if timed:
                    byts = kv_bytes + nbytes(q, tab, tpos, q)
                    t = (flops, byts, {
                        "kernel": lambda: paged_decode_attention_cuda(q, kp, vp, tab, tpos),
                        "plain": lambda: ref.paged_decode_attention(q, kp, vp, tab, tpos),
                        "library": sdpa})
                finish("paged_decode_attention", rec, t)
            case_t = f"{case} D={dm}"
            got = ft.fused_decode_tail_cuda(q, kp, vp, wo, tab, tpos)
            again = ft.fused_decode_tail_cuda(q, kp, vp, wo, tab, tpos)
            want = ref.fused_decode_tail(q, kp, vp, wo, tab, tpos)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"fused_decode_tail {case_t}: two calls differ")
            rec = {"phase": "moe_kernel", "name": "fused_decode_tail", "dtype": dn,
                   "case": case_t, "tol": TOL[dn], "tol_of": "the output's largest magnitude",
                   "max_abs_err": check_scaled("fused_decode_tail", got, want, dn, case_t)}
            t = None
            if timed:
                byts = kv_bytes + nbytes(q, tab, tpos, wo) + b * dm * q.element_size()
                t = (flops + 2.0 * b * h * hd * dm, byts, {
                    "kernel": lambda: ft.fused_decode_tail_cuda(q, kp, vp, wo, tab, tpos),
                    "plain": lambda: ref.fused_decode_tail(q, kp, vp, wo, tab, tpos),
                    "library": lambda: torch.matmul(sdpa().reshape(b, h * hd), wo),
                    "unfused": lambda: torch.matmul(paged_decode_attention_cuda(
                        q, kp, vp, tab, tpos).reshape(b, h * hd), wo)})
                rec["library"] = "scaled_dot_product_attention (bool mask) + matmul(wo)"
            finish("fused_decode_tail", rec, t)
        for label, c, h, hkv, bs, entries, last in MOE_SPANS:
            kp, vp, tab, tpos = window_pool(np, rng, 1, hkv, hd, bs, entries, last, last + 1)
            qpos = (tpos[:, None] - np.arange(c)[::-1][None, :]).astype(np.int32)
            q = cuda(rng.standard_normal((1, c, h, hd), dtype=np.float32), dtype)
            kp, vp, tab, qp = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(qpos)
            case = (f"{label}: B=1 C={c} H={h} Hkv={hkv} hd={hd} bs={bs} E={entries} "
                    f"q_pos [{last - c + 1}, {last}]")
            got = paged_prefill_attention_cuda(q, kp, vp, tab, qp)
            want = ref.paged_prefill_attention(q, kp, vp, tab, qp)
            torch.cuda.synchronize()
            rec = {"phase": "moe_kernel", "name": "paged_prefill_attention", "dtype": dn,
                   "case": case, "tol": TOL[dn],
                   "max_abs_err": check("paged_prefill_attention", got, want, dn, case)}
            t = None
            if timed:
                flops, kv_bytes, vis, kg = span_attention_cost(torch, kp, tab, qp, h, hd, 0)
                _, vg, _ = ref.gather_pool(kp, vp, tab)
                qx, kx, vx = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
                t = (flops, kv_bytes + nbytes(q, qp, tab, q), {
                    "kernel": lambda: paged_prefill_attention_cuda(q, kp, vp, tab, qp),
                    "plain": lambda: ref.paged_prefill_attention(q, kp, vp, tab, qp),
                    "library": lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=vis, enable_gqa=True)})
            finish("paged_prefill_attention", rec, t)
    return out


def small_moe_phase(torch, np):
    """The reduced olmoe-1b-7b (4 experts, top 2) in f32 at the default
    capacity factor, where assignments are dropped: the ring engine, the
    paged engine (blocks of 4, chunked prefill of 3, the fused tail) and
    the paged engine with ``spec_decode=2`` (verify spans over every
    slot), each across an interrupting update, greedy, on the card and
    on the CPU from the same weights.  The trajectories must be equal token for
    token: a dispatch that behaved differently on the card (the order of
    ties, the sort's stability, atomics) would change which assignments
    are dropped."""
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.data import tokenizer
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config("olmoe-1b-7b")),
                              vocab_size=tokenizer.VOCAB_SIZE)
    rng = np.random.default_rng(31)
    reqs = []
    for g in range(3):
        p = rng.integers(3, cfg.vocab_size, size=int(rng.integers(5, 24))).tolist()
        reqs += [{"rid": 3 * g + j, "prompt_id": g, "answer": None, "prompt": p}
                 for j in range(3)]
    base = dict(n_slots=4, prompt_len=24, max_gen_len=12, temperature=0.0, seed=0)
    setups = {"ring": {}, "paged": dict(cache="paged", block_size=4, prefill_chunk=3,
                                        fused_decode="fused"),
              "paged_spec": dict(cache="paged", block_size=4, spec_decode=2)}
    cpu0 = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    cpu1 = build_model(cfg, device="cpu")
    with torch.no_grad():
        for a, b in zip(cpu1.parameters(), cpu0.parameters()):
            a.copy_(b * 1.01)
    drops = []
    apply = moe.moe_apply

    def probe(*a, **k):
        y, aux = apply(*a, **k)
        drops.append(aux["drop"])
        return y, aux
    moe.moe_apply = probe
    rec = {"phase": "small_moe", "config": cfg.name, "experts": cfg.n_experts,
           "top_k": cfg.experts_per_token, "capacity_factor": cfg.moe_capacity_factor}
    try:
        for name, extra in setups.items():
            runs = {}
            for dev in ("cpu", "cuda"):
                m0 = copy.deepcopy(cpu0).to(dev)
                m1 = copy.deepcopy(cpu1).to(dev)
                engine = RolloutEngine(m0, EngineConfig(**base, **extra), device=dev)
                drops.clear()
                ops.reset_launches()
                done, pending, steps = {}, list(reqs), 0
                while len(done) < len(reqs):
                    pending = pending[engine.admit(pending):]
                    if steps == 4:
                        engine.update_weights(m1, 1)
                    for f in engine.step():
                        done[f.rid] = f
                    steps += 1
                    require(steps < 500, f"small_moe {name}: requests did not finish")
                runs[dev] = (done, dict(ops.LAUNCHES), max(float(x) for x in drops),
                             engine.stats())
            (dc, _, dropc, stc), (dg, launches, dropg, stg) = runs["cpu"], runs["cuda"]
            require(stg["interruptions"] == 1, f"small_moe {name}: no interrupting update")
            require(dropg > 0 and dropc > 0, f"small_moe {name}: no assignment dropped")
            require(sorted(dc) == sorted(dg), f"small_moe {name}: finished rids differ")
            for rid, f in dc.items():
                require(dg[rid].response == f.response and dg[rid].versions == f.versions,
                        f"small_moe {name}: rid {rid} differs between the card and the CPU")
            want_k = {"ring": ("flash_attention", "decode_attention"),
                      "paged": ("paged_prefill_attention", "fused_decode_tail"),
                      "paged_spec": ("flash_attention", "paged_prefill_attention",
                                     "paged_decode_attention")}[name]
            require(all(launches[k] > 0 for k in want_k),
                    f"small_moe {name}: kernels not launched {launches}")
            rec[name] = {"trajectories_equal": len(dc), "tokens": stg["tokens_generated"],
                         "max_drop_share_seen": dropg, "launches": launches}
    finally:
        moe.moe_apply = apply
    emit(rec)


def build_moe_models(torch, arch: str, n_layers: int = 0, perturbed: bool = True):
    """``arch`` at full width in bf16 (cut to ``n_layers`` when given),
    random weights from seed 0, and the perturbed policy of version 1."""
    import dataclasses
    from repro_torch.configs import get_model_config
    from repro_torch.models.model import build_model

    full = get_model_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers) if n_layers else full
    t0 = time.perf_counter()
    m0 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    m0.init(torch.Generator(device="cuda").manual_seed(0))
    out = {"cfg": cfg, "full": full, "m0": m0, "params": sum(p.numel() for p in m0.parameters())}
    if perturbed:
        m1 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
        with torch.no_grad():
            for p1, p0 in zip(m1.parameters(), m0.parameters()):
                p1.copy_(p0 * 1.01)
        out["m1"] = m1
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    return out


def drop_probe(torch, np, model, n_slots: int, prompt_len: int):
    """The MoE's dropped share, layer by layer, of one admission prefill
    (the engine's block: n_slots rows of prompt_len, right-padded) and of
    the decode step after it, outside any timed run (the serving methods
    return no aux)."""
    from repro_torch.models import moe

    seen = []
    apply = moe.moe_apply

    def probe(*a, **k):
        y, aux = apply(*a, **k)
        seen.append(aux["drop"])
        return y, aux
    rng = np.random.default_rng(32)
    lens = rng.integers(prompt_len // 2, prompt_len + 1, size=n_slots)
    toks = torch.from_numpy(rng.integers(3, model.cfg.vocab_size, size=(n_slots, prompt_len)))
    moe.moe_apply = probe
    try:
        with torch.no_grad():
            cache = model.init_cache(n_slots, prompt_len + 1)
            logits, cache = model.prefill(toks.cuda(), cache,
                                          length=torch.from_numpy(lens).cuda().to(torch.int32))
            pre = [float(x) for x in seen]
            seen.clear()
            model.decode_step(torch.argmax(logits, dim=-1), cache)
            dec = [float(x) for x in seen]
    finally:
        moe.moe_apply = apply
    return {"prefill_drop_share_mean": sum(pre) / len(pre), "prefill_drop_share_by_layer": pre,
            "decode_drop_share_mean": sum(dec) / len(dec), "decode_drop_share_by_layer": dec,
            "probe": f"{n_slots} rows of {prompt_len}, lengths {[int(x) for x in lens]}"}


def expert_floor(cfg, slots: int):
    """The least time of a decode step's expert products: the reference's
    dense (G, E, C, d) buffer runs every expert whatever the routing, so a
    step reads every layer's expert weights once (bf16) at the card's
    memory rate."""
    per_layer = cfg.n_experts * cfg.d_model * cfg.d_ff * (3 if cfg.act in ("swiglu", "geglu")
                                                          else 2)
    byts = 2.0 * cfg.n_layers * per_layer
    return {"expert_params_per_layer": per_layer, "expert_bytes_per_step": byts,
            "expert_floor_ms": 1e3 * byts / PEAK_BYTES,
            "reckoning": f"{cfg.n_layers} layers x {per_layer} expert weights x 2 bytes / "
                         f"{PEAK_BYTES:.3g} B/s, for {slots} slots"}


def serve_moe_phase(torch, np, profile: bool = False):
    """olmoe-1b-7b at full width and depth (16 layers, 64 experts top 8,
    MHA 16/16 at hd 128, QK-norm; about 6.92 B parameters, 13.8 GB in
    bf16) with ``serve``'s traffic on the ring engine, then ``serve_paged``'s
    on the paged engine (blocks of 16, prefix sharing, chunked prefill of
    128, the fused tail); the drop probe and the expert floor of a decode
    step; then part ``qwen3_cut``: qwen3-moe-235b-a22b at its published
    widths cut to 2 of 94 layers on the paged engine with the fused tail,
    8 prompts of 512, 64 tokens each.  ``profile``: trace 8 more decode
    steps of the ring engine.  Returns {part: launches}."""
    models = build_moe_models(torch, "olmoe-1b-7b")
    cfg = models["cfg"]
    launches = {}
    launches["ring"], eng, reqs, ring_ms = serve_phase(torch, np, models, name="serve_moe")
    if profile:
        profile_phase(torch, "serve_moe", eng, reqs, ring_ms)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches["paged"], eng, _, paged_ms = serve_paged_phase(torch, np, models, fused=True,
                                                            name="serve_moe_paged")
    del eng
    probe = drop_probe(torch, np, models["m0"], 8, 512)
    floor = expert_floor(cfg, 8)
    emit({"phase": "serve_moe", "part": "probe", "model": cfg.name, "params": models["params"],
          **probe, **floor, "ring_decode_step_ms_mean": ring_ms,
          "paged_decode_step_ms_mean": paged_ms,
          "ring_step_over_floor": ring_ms / floor["expert_floor_ms"]})
    del models
    gc.collect()
    torch.cuda.empty_cache()
    launches["qwen3_cut"] = qwen3_cut_part(torch, np)
    return launches


QWEN3_CUT_LAYERS = 2


def qwen3_cut_part(torch, np):
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    models = build_moe_models(torch, "qwen3-moe-235b-a22b", QWEN3_CUT_LAYERS, perturbed=False)
    cfg, full = models["cfg"], models["full"]
    n_slots, prompt_len, gen = 8, 512, 64
    engine = RolloutEngine(models["m0"], EngineConfig(
        n_slots=n_slots, prompt_len=prompt_len, max_gen_len=gen, cache="paged", block_size=16,
        prefill_chunk=128, fused_decode="fused", temperature=1.0, seed=0,
        dtype=torch.bfloat16))
    spans = count_ingests(engine)
    rng = np.random.default_rng(33)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=prompt_len).tolist()}
            for i in range(n_slots)]
    warm = reqs[0]
    run_engine(engine, [dict(warm, rid=100)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spans["n"] = 0
    ops.reset_launches()
    dispatches0 = engine.decode_dispatches
    t0 = time.perf_counter()
    done = run_engine(engine, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps = engine.decode_dispatches - dispatches0
    require(len(done) == n_slots, f"qwen3_cut finished {len(done)} of {n_slots}")
    require(all(len(f.response) == gen and all(math.isfinite(x) for x in f.logprobs)
                for f in done.values()), "qwen3_cut: a response is short or not finite")
    L = cfg.n_layers
    require_launches(launches, {"paged_prefill_attention": L * spans["n"],
                                "fused_decode_tail": L * steps, "flash_attention": 0,
                                "decode_attention": 0, "paged_decode_attention": 0})
    emit({"phase": "serve_moe", "part": "qwen3_cut", "model": cfg.name,
          "layers": {"used": L, "of": full.n_layers,
                     "cut": "depth only, every width as published (d 4096, 64 heads over 4 "
                            "at hd 128, 128 experts top 8, d_ff 1536, vocab 151936)"},
          "params": models["params"], "init_s": models["init_s"],
          "engine": "paged, blocks of 16, chunked prefill of 128, fused decode tail",
          "prompts": f"{n_slots} of {prompt_len}", "max_gen_len": gen, "wall_s": wall,
          "ingest_spans": spans["n"], "decode_steps": steps,
          "generated_tokens_per_s": n_slots * gen / wall,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
          "drop": drop_probe(torch, np, models["m0"], n_slots, prompt_len)})
    del engine, models
    gc.collect()
    torch.cuda.empty_cache()
    return launches


VLM_DECODE_STEPS = 32
# bf16 through 24 layers: the decode path's logits against the full
# forward's, rms of the difference over rms of the logits, and the largest
# difference over the largest logit
VLM_TOL = {"rms_rel": 5e-2, "max_rel": 1e-1}


def serve_vlm_phase(torch, np):
    """internvl2-2b at full width and depth (24 layers, GQA 16/8 at hd
    128, d_ff 8192, vocab 92553; about 1.9 B parameters) in bf16.  Part
    ``engine``: the ring engine, as the reference's, which feeds no
    prefix: 8 prompts of 512, 128 tokens, an interrupting update.  Part
    ``prefix``: 4 rows of 256 projected prefix embeddings (prefix_dim
    1024, normal x 0.1 from a seeded generator) and a 512-token prompt
    through ``LM.prefill(prefix_embeds=)``, then ``VLM_DECODE_STEPS``
    decode steps, each step's logits against ``LM.forward`` over the same
    prefix and tokens within ``VLM_TOL``.  Returns {part: launches}."""
    from repro_torch.kernels import ops

    models = build_moe_models(torch, "internvl2-2b")
    cfg, m0 = models["cfg"], models["m0"]
    launches = {}
    launches["engine"], eng, _, _ = serve_phase(torch, np, models, name="serve_vlm",
                                                max_gen_len=128, interrupt_at=64,
                                                min_prompt=512)
    del eng
    b, p, s, n = 4, cfg.n_prefix_tokens, 512, VLM_DECODE_STEPS
    g = torch.Generator(device="cuda").manual_seed(0)
    pre = (torch.randn((b, p, cfg.prefix_dim), generator=g, device="cuda") * 0.1
           ).to(torch.bfloat16)
    toks = torch.randint(3, cfg.vocab_size, (b, s + n), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        cache = m0.init_cache(b, p + s + n)
        logits, cache = m0.prefill(toks[:, :s], cache, prefix_embeds=pre)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        steps = [logits]
        step_ms = []
        for i in range(n):
            t0 = time.perf_counter()
            logits, cache = m0.decode_step(toks[:, s + i], cache)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            steps.append(logits)
        t0 = time.perf_counter()
        full, _ = m0.forward(toks, prefix_embeds=pre)
        torch.cuda.synchronize()
        forward_ms = 1e3 * (time.perf_counter() - t0)
    part_launches = dict(ops.LAUNCHES)
    L = cfg.n_layers
    require_launches(part_launches, {"flash_attention": 2 * L, "decode_attention": L * n,
                                     "paged_prefill_attention": 0, "fused_decode_tail": 0})
    require(int(cache["t"][0]) == p + s + n, f"positions {cache['t'].tolist()}")
    errs = []
    for i, x in enumerate(steps):
        want = full[:, p + s - 1 + i].float()
        d = x.float() - want
        rms = (d.square().mean().sqrt() / want.square().mean().sqrt()).item()
        mx = d.abs().max().item() / want.abs().max().item()
        require(math.isfinite(rms) and rms <= VLM_TOL["rms_rel"] and mx <= VLM_TOL["max_rel"],
                f"serve_vlm prefix: step {i} logits off the forward's by rms {rms}, max {mx}")
        errs.append((rms, mx, (x.argmax(-1) == want.argmax(-1)).float().mean().item()))
    launches["prefix"] = part_launches
    emit({"phase": "serve_vlm", "part": "prefix", "model": cfg.name, "params": models["params"],
          "rows": b, "prefix_tokens": p, "prefix_dim": cfg.prefix_dim, "prompt": s,
          "decode_steps": n, "prefill_ms": prefill_ms, "forward_ms": forward_ms,
          "decode_step_ms_mean": sum(step_ms) / n, "tol": VLM_TOL,
          "rms_rel_max": max(e[0] for e in errs), "max_rel_max": max(e[1] for e in errs),
          "argmax_agreement": sum(e[2] for e in errs) / len(errs),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": part_launches})
    del models, m0, cache, full
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# 8 layers peaked at 65.4 GB (19.6 GB free); one more layer adds about
# 7.4 GB, so 9 leaves more than 6 GB free and 10 would not
MOE_TRAIN_LAYERS = 9
MOE_TRAIN_BUDGET = 6144
MOE_TRAIN_GROUP = 8


def train_moe_phase(torch, np):
    """The paper's loop on olmoe-1b-7b at full width cut to
    ``MOE_TRAIN_LAYERS`` of 16 layers (the whole model's step needs about
    97 GB: 12 bytes a parameter for bf16 weights and gradients and f32 m
    and v, plus the engine's bf16 copy); the paged engine (chunked
    prefill of 128, the fused tail) generates 2 GRPO groups of
    ``MOE_TRAIN_GROUP`` from prompts of 480-512 tokens, 128 tokens each,
    at the default capacity factor 1.25; Algorithm 1 packs them into
    micro-batches of ``MOE_TRAIN_BUDGET`` tokens; a ``train_step``, a
    second batch that ``update_weights(trainer.params, 1)`` interrupts,
    a second ``train_step``.  The router's lb, z and drop come from the
    trainer's ``router``.  Returns the phase's launches."""
    import dataclasses as _dc
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.core.trainer import PPOTrainer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    full = get_model_config("olmoe-1b-7b")
    cfg = _dc.replace(full, n_layers=MOE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    policy = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    policy.init(torch.Generator(device="cuda").manual_seed(0))
    serving = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    serving.load_state_dict(policy.state_dict())
    L = cfg.n_layers
    group = MOE_TRAIN_GROUP
    rl = RLConfig(batch_size=2, answers_per_prompt=group, ppo_minibatches=2,
                  microbatch_token_budget=MOE_TRAIN_BUDGET)
    trainer = PPOTrainer(policy, rl)
    n_req = 2 * group
    engine = RolloutEngine(serving, EngineConfig(
        n_slots=n_req, prompt_len=512, max_gen_len=128, temperature=1.0, seed=0,
        dtype=torch.bfloat16, cache="paged", block_size=16, prefill_chunk=128,
        fused_decode="fused"))
    spans = count_ingests(engine)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(34)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(480, 513, size=2)]
    batch_reqs = [[{"rid": off + g * group + j, "prompt_id": off + g, "answer": None,
                    "prompt": p} for g, p in enumerate(prompts) for j in range(group)]
                  for off in (0, n_req)]
    rrng = np.random.default_rng(35)
    steps = []

    def timed_step(trajs, version):
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        met = trainer.train_step(trajs, current_version=version)
        ms = 1e3 * (time.perf_counter() - t)
        calls = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
        n_mb = met.n_microbatches
        require_launches(calls, {"flash_attention": L * 2 * n_mb,
                                 "flash_attention_bwd": L * n_mb,
                                 "fused_decode_tail": 0, "paged_prefill_attention": 0})
        tm = trainer.timings
        norms = [m["grad_norm"] for m in trainer.opt_metrics]
        router = dict(trainer.router)
        require(math.isfinite(met.loss) and all(math.isfinite(v) for v in met.diag.values()),
                f"train_step: loss {met.loss} or a diagnostic is not finite")
        require(all(math.isfinite(g) and g > 0 for g in norms), f"grad norms {norms}")
        require(set(router) == {"lb", "z", "drop"} and all(map(math.isfinite, router.values())),
                f"router losses {router}")
        steps.append({"ms": ms, "prepare_ms": 1e3 * tm["prepare"], "prox_ms": 1e3 * tm["prox"],
                      "fwd_bwd_ms": [1e3 * x for x in tm["fwd_bwd"]],
                      "optimizer_ms": [1e3 * x for x in tm["optimizer"]],
                      "n_microbatches": n_mb, "n_tokens": met.n_tokens,
                      "trained_tokens_per_s": met.n_tokens / (ms / 1e3),
                      "loss": met.loss, "router": router, "diag": met.diag,
                      "grad_norms": norms, "staleness_mean": met.staleness_mean,
                      "launches": calls})
        return met

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    done1 = run_engine(engine, batch_reqs[0])
    gen1_s = time.perf_counter() - t
    rewards = group_rewards(rrng, sorted(done1), group)
    timed_step(make_trajectories(done1, rewards), 1)
    probe, start = {}, engine.decode_dispatches

    def hand_off(e):
        if e.decode_dispatches - start == 32 and not probe:
            require(e.update_weights(trainer.params, 1), "update_weights was deferred")
            probe["logits"] = engine_probe(torch, e)
            probe["dispatches"] = e.decode_dispatches
    t = time.perf_counter()
    done2 = run_engine(engine, batch_reqs[1], update=hand_off)
    gen2_s = time.perf_counter() - t
    require(probe and engine.stats()["interruptions"] >= 1, "no interrupting update")
    require(any(set(f.versions) == {0, 1} for f in done2.values()),
            "no trajectory of the second batch spans versions 0 and 1")
    rewards.update(group_rewards(rrng, sorted(done2), group))
    timed_step(make_trajectories(done2, rewards), 2)
    require(torch.equal(engine_probe(torch, engine), probe["logits"]),
            "the trainer's in-place update reached the engine's weights")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = engine.stats()
    mbs = sum(s["n_microbatches"] for s in steps)
    require_launches(launches, {
        "fused_decode_tail": L * st["decode_dispatches"],
        "paged_prefill_attention": L * spans["n"],
        "flash_attention": L * (2 * mbs + 2), "flash_attention_bwd": L * mbs,
        "decode_attention": 0, "paged_decode_attention": 0})
    rec = {"phase": "train_moe", "model": cfg.name, "dtype": "bfloat16",
           "optimizer_state": "f32",
           "layers": {"used": L, "of": full.n_layers,
                      "cut": f"depth only: {L} of 16 layers, every width as published; "
                             "the full depth needs ~97 GB for a step"},
           "params": sum(p.numel() for p in policy.parameters()),
           "params_full_depth": sum(p.numel() for p in build_model(
               full, device="meta").parameters()),
           "capacity_factor": cfg.moe_capacity_factor,
           "rl": {k: v for k, v in _dc.asdict(rl).items()
                  if k in ("batch_size", "answers_per_prompt", "ppo_minibatches",
                           "microbatch_token_budget", "lr", "clip_eps")},
           "engine": "paged, blocks of 16, chunked prefill of 128, fused decode tail",
           "prompt_lengths": [len(p) for p in prompts], "init_s": init_s,
           "generate_s": [gen1_s, gen2_s], "ingest_spans": spans["n"],
           "decode_dispatches": st["decode_dispatches"], "interruptions": st["interruptions"],
           "update_at_dispatch": probe["dispatches"] - start,
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done2.values()),
           "train_steps": steps, "memory_after_init_gb": init_gb, "peak_memory_gb": peak_gb,
           "free_at_peak_gb": torch.cuda.get_device_properties(0).total_memory / 1e9 - peak_gb,
           "launches": launches,
           "hand_off": "engine logits unchanged by the trainer's later in-place update"}
    emit(rec)
    del trainer, policy, serving, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the enc-dec family (whisper-medium) and xLSTM (xlstm-1.3b)
# ---------------------------------------------------------------------------

# whisper-medium's attention: 8 rows of 1500 frames, MHA 16/16 at head_dim
# 64; decoder prompts of 3-8 tokens right-padded to ENCDEC_PROMPT, then
# ENCDEC_DECODE_STEPS greedy steps, so its self-attention ring is
# ENCDEC_PROMPT + ENCDEC_DECODE_STEPS wide
ENCDEC_ROWS, ENCDEC_FRAMES, ENCDEC_HEADS, ENCDEC_HD = 8, 1500, 16, 64
ENCDEC_PROMPT, ENCDEC_DECODE_STEPS, ENCDEC_GRAD_TOKENS = 8, 128, 128


def encdec_kernel_phase(torch, np, quick: bool):
    """The attention kernels at the shapes whisper-medium gives them, in
    bf16 and f32 against their plain versions: the flash forward
    non-causal over B 8 x S 1500 (not a multiple of the 64-key tile: the
    kernel itself masks the last tile's padded keys, which no causal
    diagonal hides here) at 16/16 heads of 64, with its log-sum-exp; the
    backward at the same shape (elementwise and by norm, whole and per
    head); ring decode at group 1, hd 64 over W 1500 with every row
    visible (the cross attention) and over the self-attention ring's
    width.  Decode calls twice, bitwise equal.  Timed in bf16 beside the
    bound, the plain version and SDPA.  Returns {kernel: [records]}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    rng = np.random.default_rng(40)
    timer = None if quick else Timer(torch)
    b, s, h, hd = ENCDEC_ROWS, ENCDEC_FRAMES, ENCDEC_HEADS, ENCDEC_HD
    out = {"flash_attention": [], "flash_attention_bwd": [], "decode_attention": []}
    randn = lambda shape, dt: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                               ).to("cuda", dt)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        timed = timer is not None and dn == "bfloat16"
        q, k, v, dout = (randn((b, s, h, hd), dtype) for _ in range(4))
        case = f"encoder: B={b} S={s} H={h} Hkv={h} hd={hd} non-causal"
        o, lse = flash_attention_cuda(q, k, v, None, causal=False, return_lse=True)
        want_lse = ref.flash_attention_lse(q, k, causal=False)
        torch.cuda.synchronize()
        rec = {"phase": "encdec_kernel", "name": "flash_attention", "dtype": dn, "case": case,
               "tol": TOL[dn],
               "max_abs_err": max(check("flash_attention", o, ref.flash_attention(
                   q, k, v, causal=False), dn, case),
                   check("flash_attention lse", lse, want_lse, dn, case))}
        if timed:
            flops, byts = 4.0 * hd * h * b * s * s, nbytes(q, k, v, o)
            qx, kx, vx = (x.transpose(1, 2) for x in (q, k, v))
            rec.update(ms=timer(lambda: flash_attention_cuda(q, k, v, None, causal=False)),
                       plain_ms=timer(lambda: ref.flash_attention(q, k, v, causal=False)),
                       library_ms=timer(lambda: F.scaled_dot_product_attention(qx, kx, vx)),
                       flops=flops, bytes=byts, **bound(flops, byts, dn))
            out["flash_attention"].append(rec)
        emit(rec)
        grads = flash_attention_bwd_cuda(q, k, v, o, lse, dout, None, causal=False)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, dout, None, causal=False)
        want = ref.flash_attention_bwd(q, k, v, o, want_lse, dout, causal=False)
        torch.cuda.synchronize()
        err, norm = 0.0, 0.0
        for name, g, a, w in zip(("dq", "dk", "dv"), grads, again, want):
            require(torch.equal(g, a), f"flash_attention_bwd {case} {dn}: {name} differs "
                                       "between two calls")
            err = max(err, check(f"flash_attention_bwd {name}", g, w, dn, case))
            norm = max(norm, check_norm(f"flash_attention_bwd {name}", g, w, dn, case))
        rec = {"phase": "encdec_kernel", "name": "flash_attention_bwd", "dtype": dn,
               "case": case, "max_abs_err": err, "tol": TOL[dn],
               "max_norm_err_over_limit": norm, "norm_tol": NORM_TOL[dn]}
        del want
        if timed:
            flops = 10.0 * hd * h * b * s * s
            byts = 3 * nbytes(q) + 2 * nbytes(k) + 4 * b * h * s + nbytes(*grads)
            qx, kx, vx = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qx, kx, vx)
            dx = dout.transpose(1, 2)
            rec.update(
                ms=timer(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, dout, None,
                                                          causal=False), 10, 2),
                plain_ms=timer(lambda: ref.flash_attention_bwd(q, k, v, o, lse, dout,
                                                               causal=False), 3, 1),
                library_ms=timer(lambda: torch.autograd.grad(sdpa, (qx, kx, vx), dx,
                                                             retain_graph=True), 10, 2),
                flops=flops, bytes=byts, **bound(flops, byts, dn))
            out["flash_attention_bwd"].append(rec)
            del sdpa, qx, kx, vx
        emit(rec)
        del q, k, v, dout, o, lse, grads, again
        for label, w in (("cross", s), ("self", ENCDEC_PROMPT + ENCDEC_DECODE_STEPS)):
            q = randn((b, h, hd), dtype)
            kc, vc = randn((b, w, h, hd), dtype), randn((b, w, h, hd), dtype)
            if label == "cross":
                # decode_step's cross call: every frame visible, t = F
                pos = torch.arange(w, dtype=torch.int32, device="cuda").repeat(b, 1)
                tt = torch.full((b,), w, dtype=torch.int32, device="cuda")
            else:
                pos_np, t_np = ring_state(np, rng, b, w, w)
                pos, tt = torch.from_numpy(pos_np).cuda(), torch.from_numpy(t_np).cuda()
            case = f"{label}: B={b} W={w} H={h} Hkv={h} hd={hd}"
            got = decode_attention_cuda(q, kc, vc, pos, tt)
            again = decode_attention_cuda(q, kc, vc, pos, tt)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"decode_attention {case}: two calls differ")
            rec = {"phase": "encdec_kernel", "name": "decode_attention", "dtype": dn,
                   "case": case, "tol": TOL[dn],
                   "max_abs_err": check("decode_attention", got,
                                        ref.decode_attention(q, kc, vc, pos, tt), dn, case)}
            if timed:
                valid = decode_mask(pos, tt, 0)
                n_valid = valid.sum().item()
                mask, qx = valid[:, None, None, :], q[:, :, None, :]
                kx, vx = kc.transpose(1, 2), vc.transpose(1, 2)
                flops = 4.0 * hd * h * n_valid
                byts = 2 * n_valid * h * hd * kc.element_size() + nbytes(pos, tt, q, got)
                rec.update(ms=timer(lambda: decode_attention_cuda(q, kc, vc, pos, tt)),
                           plain_ms=timer(lambda: ref.decode_attention(q, kc, vc, pos, tt)),
                           library_ms=timer(lambda: F.scaled_dot_product_attention(
                               qx, kx, vx, attn_mask=mask)),
                           flops=flops, bytes=byts, **bound(flops, byts, dn))
                out["decode_attention"].append(rec)
            emit(rec)
    torch.cuda.empty_cache()
    return out


def small_encdec_phase(torch, np):
    """The reduced whisper (2 encoder and 2 decoder layers, d 256, hd 64)
    in f32 on the card and on the CPU from the same weights: ``forward``
    over 8 frames and 12 tokens, then ``prefill`` of 5 tokens (the cross
    cache, sized 16 by ``init_cache``, becomes 8 frames wide) and 8
    greedy ``decode_step``s.  Logits within 1e-4 of the largest (f32 on
    both sides, other libraries), greedy tokens equal; the card's
    launches: flash attention for the encoder's layers and the decoder's
    self-attention, decode attention twice a decoder layer a step (self
    and cross)."""
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = reduced(get_model_config("whisper-medium"))
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(41)
    b, s, pre, steps = 2, 12, 5, 8
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, s)))
    frames = torch.from_numpy((rng.standard_normal((b, cfg.n_prefix_tokens, cfg.prefix_dim))
                               * 0.1).astype(np.float32))
    runs = {}
    for dev, m in (("cpu", cpu), ("cuda", gpu)):
        ops.reset_launches()
        fr = frames.to(dev)
        with torch.no_grad():
            full, _ = m(toks.to(dev), prefix_embeds=fr)
        cache = m.init_cache(b, pre + steps)
        logits, cache = m.prefill(toks[:, :pre].to(dev), cache, prefix_embeds=fr)
        require(cache["cross"]["k"].shape[2] == cfg.n_prefix_tokens,
                f"small_encdec: a cross cache {cache['cross']['k'].shape[2]} frames wide")
        out, greedy = [full.cpu(), logits.cpu()], []
        for _ in range(steps):
            tok = logits.argmax(-1)
            greedy.append(tok.cpu())
            logits, cache = m.decode_step(tok, cache)
            out.append(logits.cpu())
        runs[dev] = (out, torch.stack(greedy, 1), dict(ops.LAUNCHES))
    (oc, greedy_cpu, _), (og, greedy_gpu, launches) = runs["cpu"], runs["cuda"]
    err = 0.0
    for a, c in zip(oc, og):
        e = (a - c).abs().max().item()
        require(e <= 1e-4 * max(1.0, a.abs().max().item()), f"small_encdec: card vs CPU {e}")
        err = max(err, e)
    require(torch.equal(greedy_cpu, greedy_gpu),
            "small_encdec: greedy tokens differ between card and CPU")
    le, ld = cfg.encoder_layers, cfg.n_layers
    require_launches(launches, {"flash_attention": 2 * (le + ld),
                                "decode_attention": 2 * ld * steps,
                                "flash_attention_bwd": 0})
    emit({"phase": "small_encdec", "config": cfg.name, "frames": cfg.n_prefix_tokens,
          "encoder_seq_len": cfg.encoder_seq_len, "max_abs_err": err, "tol": "1e-4 x max |logit|",
          "greedy_tokens_equal": int(greedy_gpu.numel()), "launches": launches})


XLSTM_SMALL_SETUPS = {
    "ring": {}, "ring_chunked": dict(prefill_chunk=3),
    "paged": dict(cache="paged"), "paged_chunked": dict(cache="paged", prefill_chunk=3),
    "paged_fused": dict(cache="paged", fused_decode="fused"),
    "paged_chunked_fused": dict(cache="paged", prefill_chunk=3, fused_decode="fused"),
    "ring_spec": dict(spec_decode=2),
    "paged_spec_chunked": dict(cache="paged", spec_decode=3, prefill_chunk=3)}


def small_xlstm_phase(torch, np):
    """The reduced xlstm-1.3b at 4 layers (2 x (mLSTM, sLSTM), d 256, the
    mLSTM's head_dim 128) in f32 through every engine configuration that
    the reference runs on it (``XLSTM_SMALL_SETUPS``: ring and paged,
    monolithic and chunked, the paged engine's fused-tail flag,
    speculative decoding), greedy, across an interrupting update, on the
    card and on the CPU from the same weights: trajectories equal token
    for token.  The xLSTM blocks have no kernel: no launch is counted."""
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.data import tokenizer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config("xlstm-1.3b")), n_layers=4,
                              vocab_size=tokenizer.VOCAB_SIZE)
    rng = np.random.default_rng(42)
    reqs = []
    for g in range(3):
        p = rng.integers(3, cfg.vocab_size, size=int(rng.integers(5, 20))).tolist()
        reqs += [{"rid": 2 * g + j, "prompt_id": g, "answer": None, "prompt": p}
                 for j in range(2)]
    base = dict(n_slots=4, prompt_len=20, max_gen_len=10, temperature=0.0, seed=0,
                block_size=4)
    cpu0 = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    cpu1 = build_model(cfg, device="cpu")
    with torch.no_grad():
        for a, b in zip(cpu1.parameters(), cpu0.parameters()):
            a.copy_(b * 1.01)
    rec = {"phase": "small_xlstm", "config": cfg.name, "layers": list(cpu0.kinds)}
    for name, extra in XLSTM_SMALL_SETUPS.items():
        runs = {}
        for dev in ("cpu", "cuda"):
            engine = RolloutEngine(copy.deepcopy(cpu0).to(dev), EngineConfig(**base, **extra),
                                   device=dev)
            m1 = copy.deepcopy(cpu1).to(dev)
            ops.reset_launches()
            done, pending, steps = {}, list(reqs), 0
            while len(done) < len(reqs):
                pending = pending[engine.admit(pending):]
                if engine.decode_dispatches >= 3 and engine.version == 0:
                    engine.update_weights(m1, 1)
                for f in engine.step():
                    done[f.rid] = f
                steps += 1
                require(steps < 500, f"small_xlstm {name}: requests did not finish")
            runs[dev] = (done, dict(ops.LAUNCHES), engine.stats())
        (dc, _, stc), (dg, launches, stg) = runs["cpu"], runs["cuda"]
        require(stg["interruptions"] == stc["interruptions"] == 1,
                f"small_xlstm {name}: no interrupting update")
        require(sorted(dc) == sorted(dg), f"small_xlstm {name}: finished rids differ")
        for rid, f in dc.items():
            require(dg[rid].response == f.response and dg[rid].versions == f.versions,
                    f"small_xlstm {name}: rid {rid} differs between the card and the CPU")
        require(not any(launches.values()), f"small_xlstm {name}: launches {launches}")
        rec[name] = {"trajectories_equal": len(dc), "tokens": stg["tokens_generated"],
                     "spec_rounds": stg.get("spec_rounds", 0)}
    emit(rec)


# bf16 through 24 + 24 layers: decode_step's logits against forward's, as
# serve_vlm holds its prefix path
ENCDEC_TOL = VLM_TOL


def serve_encdec_phase(torch, np):
    """whisper-medium whole (24 encoder + 24 decoder layers, d 1024, MHA
    16/16 at hd 64, vocab 51865; 0.813 B parameters) in bf16, random
    weights from seed 0: 8 rows of 1500 frames (normal x 0.1 from the
    seed) and decoder prompts of 3-8 tokens, right-padded; ``encode``
    timed alone, then ``prefill`` and ``ENCDEC_DECODE_STEPS`` greedy
    ``decode_step``s; each step's logits against ``forward`` over the
    same frames and tokens within ``ENCDEC_TOL``, with the greedy
    argmax's agreement.  Launches: flash attention 24 + 24 a prefill,
    decode attention 48 a step (self and cross).  Part ``grad``: one
    forward and backward of the reference test's loss mean(logits^2) at
    ``ENCDEC_GRAD_TOKENS`` tokens a row over the same frames: finite
    gradients, the flash backward once a layer (the encoder's non-causal
    and the decoder's causal self-attention; the cross attention is the
    plain route).  Returns {part: launches}."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = get_model_config("whisper-medium")
    t0 = time.perf_counter()
    m = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    m.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b, p, n = ENCDEC_ROWS, ENCDEC_PROMPT, ENCDEC_DECODE_STEPS
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = (torch.randn((b, ENCDEC_FRAMES, cfg.prefix_dim), generator=g, device="cuda")
              * 0.1).to(torch.bfloat16)
    rng = np.random.default_rng(43)
    length = torch.from_numpy(rng.integers(3, p + 1, size=b).astype(np.int32)).cuda()
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, p))).cuda()
    toks = torch.where(torch.arange(p, device="cuda")[None] < length[:, None], toks, 0)
    with torch.no_grad():                 # lazy set-up, paid once
        warm = m.init_cache(b, p + n)
        lg, warm = m.prefill(toks, warm, prefix_embeds=frames, length=length)
        m.decode_step(lg.argmax(-1), warm)
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m.encode(frames)
        torch.cuda.synchronize()
        encode_ms = 1e3 * (time.perf_counter() - t0)
        ops.reset_launches()
        t0 = time.perf_counter()
        cache = m.init_cache(b, p + n)
        logits, cache = m.prefill(toks, cache, prefix_embeds=frames, length=length)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        steps, gen, step_ms = [logits], [], []
        for _ in range(n):
            tok = logits.argmax(-1)
            gen.append(tok)
            t0 = time.perf_counter()
            logits, cache = m.decode_step(tok, cache)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            steps.append(logits)
        launches = dict(ops.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cross_gb = sum(nbytes(x) for x in cache["cross"].values()) / 1e9
        # the same tokens through forward: row i's prompt, then its n tokens
        gen = torch.stack(gen, 1)
        seq = torch.zeros((b, p + n), dtype=toks.dtype, device="cuda")
        rows = torch.arange(b, device="cuda")[:, None]
        seq[:, :p] = toks
        seq[rows, length.long()[:, None] + torch.arange(n, device="cuda")] = gen
        t0 = time.perf_counter()
        full, _ = m(seq, prefix_embeds=frames)
        torch.cuda.synchronize()
        forward_ms = 1e3 * (time.perf_counter() - t0)
    L, le = cfg.n_layers, cfg.encoder_layers
    require_launches(launches, {"flash_attention": le + L, "decode_attention": 2 * L * n,
                                "paged_decode_attention": 0, "flash_attention_bwd": 0})
    require(cache["cross"]["k"].shape[2] == ENCDEC_FRAMES, "the cross cache's width")
    errs = []
    for i, x in enumerate(steps):
        want = full[rows[:, 0], length.long() - 1 + i].float()
        d = x.float() - want
        rms = (d.square().mean().sqrt() / want.square().mean().sqrt()).item()
        mx = d.abs().max().item() / want.abs().max().item()
        require(math.isfinite(rms) and rms <= ENCDEC_TOL["rms_rel"]
                and mx <= ENCDEC_TOL["max_rel"],
                f"serve_encdec: step {i} logits off the forward's by rms {rms}, max {mx}")
        errs.append((rms, mx, (x.argmax(-1) == want.argmax(-1)).float().mean().item()))
    decode_s = sum(step_ms) / 1e3
    emit({"phase": "serve_encdec", "model": cfg.name,
          "params": sum(x.numel() for x in m.parameters()), "dtype": "bfloat16",
          "init_s": init_s, "rows": b, "frames": ENCDEC_FRAMES,
          "prompt_lengths": length.tolist(), "decode_steps": n, "encode_ms": encode_ms,
          "prefill_ms": prefill_ms, "forward_ms": forward_ms,
          "decode_step_ms_mean": sum(step_ms) / n,
          "decode_step_ms_median": sorted(step_ms)[n // 2],
          "generated_tokens_per_s": b * n / decode_s, "cross_cache_gb": cross_gb,
          "peak_memory_gb": peak_gb, "tol": ENCDEC_TOL,
          "rms_rel_max": max(e[0] for e in errs), "max_rel_max": max(e[1] for e in errs),
          "argmax_agreement": sum(e[2] for e in errs) / len(errs), "launches": launches})
    del cache, full, steps
    gc.collect()
    torch.cuda.empty_cache()
    out = {"serve": launches}
    # part grad: mean(logits^2) at full width
    gtoks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, ENCDEC_GRAD_TOKENS))
                             ).cuda()
    for x in m.parameters():
        x.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, _ = m(gtoks, prefix_embeds=frames)
    loss = (logits.float() ** 2).mean()
    torch.cuda.synchronize()
    fwd_ms = 1e3 * (time.perf_counter() - t0)
    loss.backward()
    torch.cuda.synchronize()
    total_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    norms = [x.grad.float().norm().item() for x in m.parameters()]
    require(math.isfinite(loss.item()) and all(math.isfinite(v) for v in norms),
            "serve_encdec grad: a loss or gradient is not finite")
    require(sum(v > 0 for v in norms) == len(norms), "serve_encdec grad: a zero gradient")
    require_launches(launches, {"flash_attention": le + L, "flash_attention_bwd": le + L,
                                "decode_attention": 0})
    emit({"phase": "serve_encdec", "part": "grad", "model": cfg.name,
          "rows": b, "tokens": ENCDEC_GRAD_TOKENS, "frames": ENCDEC_FRAMES,
          "loss": loss.item(), "forward_ms": fwd_ms, "forward_backward_ms": total_ms,
          "grad_norm": math.sqrt(sum(v * v for v in norms)),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches})
    out["grad"] = launches
    del m, logits, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


# xlstm-1.3b's serving traffic: serve's 8 slots, prompts of 512 and 256
# tokens with an interrupting update on the ring engine, monolithic and
# chunked; the other configurations that the reference runs on an xLSTM
# at 32 tokens, the update after 16 (the cut: the phase's time; a
# chunked engine's spans, each through 6 sLSTM loops, dominate it)
XLSTM_SERVE = {
    "ring": (dict(rng="request"), 256, 96),
    "ring_chunked": (dict(prefill_chunk=128), 256, 96),
    "paged": (dict(cache="paged", block_size=16), 32, 16),
    "paged_chunked_fused": (dict(cache="paged", block_size=16, prefill_chunk=128,
                                 fused_decode="fused"), 32, 16),
    "ring_spec": (dict(spec_decode=3, temperature=0.0), 32, 16)}


def serve_xlstm_phase(torch, np, profile: bool = False):
    """xlstm-1.3b whole (48 layers: 42 mLSTM at the mLSTM's head_dim 1024,
    6 sLSTM; d 2048; 3.65 B parameters, the mLSTM's q/k/v dense as the
    reference's init makes them) in bf16, random weights from seed 0,
    and the perturbed policy of version 1: 8 prompts of 512 tokens on
    each engine of ``XLSTM_SERVE`` with an interrupting ``update_weights``
    (admission, re-prefill and decode step ms, tokens/s, peak memory, the
    recurrent state's bytes), and the ring's chunked twin's agreement
    with it (both draw per request); part ``forms``: ``xlstm_forms`` of
    the whole model in bf16, then of the same weights widened to f32.
    ``profile``: trace 4 decode steps of the ring engines and time the
    block kinds (``xlstm_block_times``, part ``block_times``).  No kernel:
    the xLSTM blocks are plain PyTorch, as the reference keeps them
    plain jnp.  Returns {part: launches}."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    models = build_moe_models(torch, "xlstm-1.3b")
    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    n_slots, prompt_len = 8, 512
    rng = np.random.default_rng(44)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=prompt_len).tolist()}
            for i in range(n_slots)]
    t0 = time.perf_counter()
    warm = RolloutEngine(m0, EngineConfig(n_slots=n_slots, prompt_len=prompt_len,
                                          max_gen_len=4, dtype=torch.bfloat16))
    warm.admit(reqs)
    warm.step()
    del warm
    gc.collect()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    out, done_by = {}, {}
    for part, (extra, gen, at) in XLSTM_SERVE.items():
        kw = dict(n_slots=n_slots, prompt_len=prompt_len, max_gen_len=gen, temperature=1.0,
                  seed=0, dtype=torch.bfloat16)
        kw.update(extra)
        engine = RolloutEngine(copy.deepcopy(m0), EngineConfig(**kw))
        state_gb = sum(nbytes(x) for name, x in engine.cache.items() if name != "t") / 1e9
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        marks = {}

        def interrupt(e):
            if e.decode_dispatches >= at and "reprefill_ms" not in marks:
                t = time.perf_counter()
                require(e.update_weights(m1, 1), "update_weights was deferred")
                torch.cuda.synchronize()
                marks["reprefill_ms"] = 1e3 * (time.perf_counter() - t)
        done, step_ms, round_ms, admit_ms = drive_timed(torch, engine, reqs, interrupt)
        launches = dict(ops.LAUNCHES)
        st = engine.stats()
        require(not any(launches.values()), f"serve_xlstm {part}: launches {launches}")
        check_finished(cfg, done, n_slots)
        require(st["interruptions"] == 1, f"serve_xlstm {part}: no interrupting update")
        rec = {"phase": "serve_xlstm", "part": part, "model": cfg.name,
               "params": models["params"], "dtype": "bfloat16",
               "engine": {k: v for k, v in kw.items() if k != "dtype"},
               "init_s": models["init_s"], "warmup_s": warmup_s,
               "admission_ms": admit_ms, "reprefill_ms": marks.get("reprefill_ms"),
               "steps": len(step_ms),
               "decode_step_ms_mean": sum(step_ms) / len(step_ms),
               "decode_step_ms_median": sorted(step_ms)[len(step_ms) // 2],
               "generated_tokens_per_s": st["tokens_generated"] / (sum(step_ms) / 1e3),
               "recurrent_state_gb": state_gb,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "stats": {k: st[k] for k in ("tokens_generated", "interruptions",
                                            "prefill_tokens", "reprefill_tokens",
                                            "spec_rounds", "accepted_tokens") if k in st},
               "launches": launches}
        if round_ms:
            rec["spec_round_ms_mean"] = sum(round_ms) / len(round_ms)
        if part == "ring_chunked":
            rec["agreement_with_ring"] = agreement(done, done_by["ring"])
        emit(rec)
        if profile and part in ("ring", "ring_chunked"):
            profile_phase(torch, f"serve_xlstm {part}", engine, reqs, rec["decode_step_ms_median"],
                          steps=4)
        done_by[part] = done
        out[part] = launches
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del m1, models
    gc.collect()
    torch.cuda.empty_cache()
    if profile:
        emit({"phase": "serve_xlstm", "part": "block_times", "model": cfg.name,
              **xlstm_block_times(torch, m0)})
    forms = {"bfloat16": xlstm_forms(torch, m0)}
    forms["float32"] = xlstm_forms(torch, m0.float())     # the same weights, widened
    emit({"phase": "serve_xlstm", "part": "forms", "model": cfg.name, **forms})
    del m0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xlstm_block_times(torch, model, rows: int = 8, prompt: int = 512, span: int = 128,
                      train_row: int = 2048):
    """Where an xLSTM's time goes, block kind by block kind: host-clock ms
    with a synchronise around every block (so the sum exceeds an
    unsynchronised step) of a decode step of ``rows`` slots (mean of 3,
    after ``prompt`` tokens), of one chunked span of ``span`` tokens of
    one row, and of the training forward over one packed row of
    ``train_row`` tokens (no gradient)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(3, model.cfg.vocab_size, (rows, prompt + span), generator=g,
                         device="cuda")
    ms = {}

    def timed(fn, part, kind):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            key = f"{part}:{kind}"
            ms[key] = ms.get(key, 0.0) + 1e3 * (time.perf_counter() - t)
            return out
        return run
    one = lambda v: torch.full((1,), v, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        cache = model.init_cache(rows, prompt + span + 8)
        model.prefill(toks[:, :prompt], cache)
        model.decode_step(toks[:, prompt], cache)                 # warm
        for blk, kind in zip(model.blocks, model.kinds):
            for part in ("decode", "prefill_chunk", "forward"):
                setattr(blk, part, timed(getattr(blk, part), part, kind))
        try:
            for i in range(3):
                model.decode_step(toks[:, prompt + 1 + i], cache)
            start = int(cache["t"][0])
            model.prefill_chunk(toks[:1, prompt:prompt + span], cache, one(0), one(start),
                                one(span))
            row = torch.randint(3, model.cfg.vocab_size, (1, train_row), generator=g,
                                device="cuda")
            seg = (torch.arange(train_row, device="cuda") // 700).to(torch.int32)[None]
            model.hidden_states(row, segment_ids=seg)
        finally:
            for blk in model.blocks:
                for part in ("decode", "prefill_chunk", "forward"):
                    delattr(blk, part)
    counts = {k: model.kinds.count(k) for k in set(model.kinds)}
    out = {"decode_step_ms_by_kind": {k: ms[f"decode:{k}"] / 3 for k in counts},
           "span_ms_by_kind": {k: ms[f"prefill_chunk:{k}"] for k in counts},
           "train_forward_ms_by_kind": {k: ms[f"forward:{k}"] for k in counts},
           "layers": counts, "rows": rows, "span": span, "train_row": train_row}
    for part in ("decode_step", "span", "train_forward"):
        out[f"{part}_ms_per_layer"] = {k: v / counts[k]
                                       for k, v in out[f"{part}_ms_by_kind"].items()}
    return out


def xlstm_forms(torch, model, rows: int = 8, prompt: int = 512, span: int = 128):
    """The prefill logits of ``rows`` prompts of ``prompt`` tokens by the
    mLSTM's parallel form (``LM.prefill``) against its chunkwise form
    carried across spans of ``span`` (``LM.prefill_chunk``), the two that
    the monolithic and the chunked engines run: rms difference over rms,
    and the share of rows whose argmax agrees."""
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(3, model.cfg.vocab_size, (rows, prompt), generator=g, device="cuda")
    full = lambda v: torch.full((rows,), v, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        a, _ = model.prefill(toks, model.init_cache(rows, prompt))
        cache = model.init_cache(rows, prompt)
        slots = torch.arange(rows, dtype=torch.int32, device="cuda")
        for s0 in range(0, prompt, span):
            b, cache = model.prefill_chunk(toks[:, s0:s0 + span], cache, slots, full(s0),
                                           full(span))
    d = b.float() - a.float()
    return {"rms_rel": (d.square().mean().sqrt() / a.float().square().mean().sqrt()).item(),
            "argmax_agreement": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
            "rows": rows, "prompt": prompt, "span": span}


# xlstm-1.3b at full width cut to one pattern unit (7 mLSTM + 1 sLSTM, so
# both kinds and the sLSTM's segment resets are trained); micro-batches
# of 2048 tokens: the sLSTM's loop is sequential over each row
XLSTM_TRAIN_LAYERS = 8
XLSTM_TRAIN_BUDGET = 2048
XLSTM_TRAIN_GROUP = 4


def train_xlstm_phase(torch, np):
    """The paper's loop on xlstm-1.3b at full width cut to
    ``XLSTM_TRAIN_LAYERS`` of 48 layers (one unit of the 7:1 pattern):
    the ring engine generates 2 GRPO groups of ``XLSTM_TRAIN_GROUP`` from
    prompts of 384-512 tokens, 128 tokens each; Algorithm 1 packs them
    into micro-batches of ``XLSTM_TRAIN_BUDGET`` tokens (rows past
    ``MLSTM_CHUNK_THRESHOLD``: the chunkwise mLSTM, the sLSTM reset at
    each segment); one ``train_step`` fed by the engine, with its
    sections, trained tokens/s and peak memory.  Returns the phase's
    launches (none: the xLSTM has no kernel)."""
    import dataclasses as _dc
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.core.trainer import PPOTrainer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    full = get_model_config("xlstm-1.3b")
    cfg = _dc.replace(full, n_layers=XLSTM_TRAIN_LAYERS)
    t0 = time.perf_counter()
    policy = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    policy.init(torch.Generator(device="cuda").manual_seed(0))
    serving = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    serving.load_state_dict(policy.state_dict())
    group = XLSTM_TRAIN_GROUP
    rl = RLConfig(batch_size=2, answers_per_prompt=group, ppo_minibatches=2,
                  microbatch_token_budget=XLSTM_TRAIN_BUDGET)
    trainer = PPOTrainer(policy, rl)
    engine = RolloutEngine(serving, EngineConfig(
        n_slots=2 * group, prompt_len=512, max_gen_len=128, temperature=1.0, seed=0,
        dtype=torch.bfloat16))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(45)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(384, 513, size=2)]
    reqs = [{"rid": g * group + j, "prompt_id": g, "answer": None, "prompt": p}
            for g, p in enumerate(prompts) for j in range(group)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    done = run_engine(engine, reqs)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    rewards = group_rewards(np.random.default_rng(46), sorted(done), group)
    t = time.perf_counter()
    met = trainer.train_step(make_trajectories(done, rewards), current_version=1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    launches = dict(ops.LAUNCHES)
    tm = trainer.timings
    norms = [x["grad_norm"] for x in trainer.opt_metrics]
    require(not any(launches.values()), f"train_xlstm: launches {launches}")
    require(math.isfinite(met.loss) and all(math.isfinite(v) for v in met.diag.values()),
            f"train_xlstm: loss {met.loss} or a diagnostic is not finite")
    require(all(math.isfinite(g) and g > 0 for g in norms), f"grad norms {norms}")
    require(met.n_microbatches >= 2, f"{met.n_microbatches} micro-batches")
    rec = {"phase": "train_xlstm", "model": cfg.name, "dtype": "bfloat16",
           "optimizer_state": "f32",
           "layers": {"used": cfg.n_layers, "of": full.n_layers, "kinds": list(policy.kinds),
                      "cut": f"depth only: {cfg.n_layers} of 48 layers (one 7:1 unit), "
                             f"micro-batches of {XLSTM_TRAIN_BUDGET} tokens; every width "
                             "as published"},
           "params": sum(x.numel() for x in policy.parameters()),
           "params_full_depth": sum(x.numel() for x in build_model(
               full, device="meta").parameters()),
           "init_s": init_s, "generate_s": gen_s,
           "prompt_lengths": [len(p) for p in prompts],
           "step_ms": ms, "prepare_ms": 1e3 * tm["prepare"], "prox_ms": 1e3 * tm["prox"],
           "fwd_bwd_ms": [1e3 * x for x in tm["fwd_bwd"]],
           "optimizer_ms": [1e3 * x for x in tm["optimizer"]],
           "n_microbatches": met.n_microbatches, "n_tokens": met.n_tokens,
           "trained_tokens_per_s": met.n_tokens / (ms / 1e3), "loss": met.loss,
           "grad_norms": norms, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    emit(rec)
    del trainer, policy, serving, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# 20. the production step functions, each beside the dry run's prediction
# ---------------------------------------------------------------------------

# train_4k is 256 rows of 4096 on 256 or 512 devices; one card takes 8 rows
# (m and v in f32 beside the weights leave it about 50 GB), in 8 micro-batches
STEPS_TRAIN = (8, 4096, 8)          # rows, tokens a row, accum_steps
STEPS_PROX_ROWS = 2                 # the prox step's f32 logits: 2.5 GB a row
STEPS_PREFILL = (2, 32768)          # prefill_32k: 32 rows cut to 2
STEPS_SLOTS, STEPS_LEN = 16, 32768  # decode_32k: 128 slots cut to 16
STEPS_BLOCK, STEPS_CHUNK = 16, 128
STEPS_HOLD = (2, 2048)              # f32 rows of the accum_steps / vocab-parallel holds
STEPS_PEAK_RATIO = (0.8, 1.25)      # predicted / measured peak, train and prefill
# the hybrid's train rows: 2 of 4096 in 2 micro-batches would take 80.5 GB
# (the dry run's prediction; the card ran out there), 2 of 2048 68.7 GB
HYBRID_STEPS = dict(layers=6, prefill=(2, 4096), slots=16, train=(2, 2048, 2))


def steps_batch(torch, np, rng, vocab: int, rows: int, seq: int, dtype, device="cuda"):
    """A train batch with ``train_batch_specs``' keys: two packed
    sequences a row (the second ending in a padded tail of segment -1),
    the same loss mask in every row (so the mean over the rows is the mean
    of the rows' means, as ``accum_steps`` > 1 takes it), advantages of
    +-1, behaviour logprobs in [-4, 0]; prox_logprob as behav."""
    cut, tail = seq // 3, seq - seq // 16
    seg = np.zeros((rows, seq), np.int32)
    seg[:, cut:] = 1
    seg[:, tail:] = -1
    pos = np.concatenate([np.arange(cut), np.arange(seq - cut)]).astype(np.int32)
    mask = np.zeros((rows, seq), np.float32)
    mask[:, cut // 2:cut] = 1
    mask[:, cut + (tail - cut) // 2:tail] = 1
    behav = -4 * rng.random((rows, seq), dtype=np.float32)
    arrays = {"tokens": rng.integers(3, vocab, (rows, seq)).astype(np.int32),
              "positions": np.broadcast_to(pos, (rows, seq)).copy(), "segment_ids": seg,
              "advantages": np.where(rng.random((rows, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
              * np.ones((1, seq), np.float32),
              "behav_logprob": behav, "prox_logprob": behav.copy(), "loss_mask": mask}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def tensor_bytes(torch, *trees) -> int:
    """Bytes of every tensor in ``trees`` (dicts and lists nest)."""
    n = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, dict):
            n += tensor_bytes(torch, *t.values())
        elif isinstance(t, (list, tuple)):
            n += tensor_bytes(torch, *t)
    return n


def train_prediction(rows: int, seq: int, accum: int, vocab_parallel: bool) -> dict:
    """The dry run's record of ``steps_phase``'s areal-qwen-1.5b train
    step (about 11 s of tracing on the host; ``steps_phase`` runs the two
    in worker processes while the card works)."""
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    cfg = get_model_config("areal-qwen-1.5b")
    shape = ShapeConfig("train_4k_cut", seq_len=seq, global_batch=rows, kind="train")
    return dryrun.build_dryrun(cfg.name, shape.name, cfg=cfg, shape=shape, accum_steps=accum,
                               vocab_parallel=vocab_parallel)


def predicted(rec: dict, key: str = "") -> dict:
    """The dry run's one-card figures of a record (or of its ``chunk``)."""
    from repro_torch.launch import roofline
    one = rec["chunk"] if key == "chunk" else rec["meshes"]["1x1"]
    args = one["argument_bytes"] if key == "chunk" else one["memory"]["argument_bytes"]
    temp = one["temp_bytes"] if key == "chunk" else one["memory"]["temp_bytes"]
    t_ops, t_bytes = one["flops"] / roofline.PEAK_FLOPS, one["bytes"] / roofline.HBM_BW
    return {"argument_bytes": args, "peak_bytes": args + temp, "flops": one["flops"],
            "bytes": one["bytes"], "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "kernels": {k: v["calls"] for k, v in one["kernels"].items()}}


def measured_call(torch, fn, *args, iters: int = 1):
    """(fn's last result, device ms a call by CUDA events, the most bytes
    allocated during the calls, the bytes allocated before them, the
    launches a call)."""
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        out = fn(*args)
    e1.record()
    torch.cuda.synchronize()
    launches = {k: v // iters for k, v in ops.LAUNCHES.items() if v}
    return out, e0.elapsed_time(e1) / iters, torch.cuda.max_memory_allocated(), base, launches


def step_line(torch, name, pred, inputs_bytes, ms, peak, base, launches, model_flops, **extra):
    rec = {"phase": "steps", "step": name, "predicted": pred,
           "card": {"inputs_bytes": inputs_bytes, "allocated_before_bytes": base,
                    "peak_bytes": peak, "ms": ms,
                    "mfu": model_flops / (ms / 1e3) / 989e12, "launches": launches},
           "model_flops": model_flops, "peak_ratio": pred["peak_bytes"] / peak,
           "bound_over_ms": pred["bound_ms"] / ms, **extra}
    require(pred["argument_bytes"] == inputs_bytes,
            f"steps {name}: predicted argument bytes {pred['argument_bytes']} != the inputs' "
            f"{inputs_bytes}")
    emit(rec)
    return rec


def require_step_launches(name, got, want) -> None:
    require(got == want, f"steps {name}: launches {got}, want {want}")


def fill_ring(torch, cache, t_now: int):
    """Every slot's ring holds positions 0 .. W-1 with random K/V, and
    decodes at t_now: each step attends the whole ring (the dry run counts
    every key as visible)."""
    w = cache["k"].shape[2]
    g = torch.Generator(device="cuda").manual_seed(5)
    for name in ("k", "v"):
        cache[name].normal_(generator=g)
    cache["pos"].copy_(torch.arange(w, dtype=torch.int32, device="cuda").expand_as(cache["pos"]))
    cache["t"].fill_(t_now)


def fill_pool(torch, cache, slots: int, length: int, bs: int, t_now: int):
    """Every slot's table names its own run of blocks over ``length``
    positions, the pool holds random K/V and the slots decode at t_now."""
    e = -(-length // bs)
    tables = torch.arange(slots * e, dtype=torch.int32, device="cuda").reshape(slots, e)
    g = torch.Generator(device="cuda").manual_seed(6)
    for name in ("k_pool", "v_pool"):
        cache[name].normal_(generator=g)
    cache["t"].fill_(t_now)
    return tables


def hold_steps(torch, np, cfg, lr: float) -> dict:
    """accum_steps 2 against 1, and vocab_parallel_loss against the plain
    loss, on the same ``STEPS_HOLD`` rows in f32 from one init: loss and
    grad_norm within 1e-5 relative, the updated parameters within 2 lr."""
    from repro_torch import optim
    from repro_torch.configs.base import RLConfig
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model

    model = build_model(cfg, device="cuda", dtype=torch.float32)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    params = list(model.parameters())
    init = [p.detach().clone() for p in params]
    batch = steps_batch(torch, np, np.random.default_rng(11), cfg.vocab_size, *STEPS_HOLD,
                        torch.float32)
    batch["prox_logprob"] = steps.make_prox_logprob_step(model)(batch)
    rl = RLConfig(lr=lr)

    def run(**kw):
        with torch.no_grad():
            for p, p0 in zip(params, init):
                p.copy_(p0)
        opt = optim.init_state(params)
        met = steps.make_train_step(model, rl, **kw)(opt, batch)
        return {k: float(met[k]) for k in ("loss", "grad_norm")}

    base = run(accum_steps=1)
    after = [p.detach().clone() for p in params]
    out = {"rows": list(STEPS_HOLD), "dtype": "float32", "lr": lr, "base": base}
    for name, kw in (("accum_2", dict(accum_steps=2)),
                     ("vocab_parallel", dict(vocab_parallel_loss=True))):
        met = run(**kw)
        rel = {k: abs(met[k] - base[k]) / abs(base[k]) for k in base}
        diff = max((p.detach() - a).abs().max().item() for p, a in zip(params, after))
        out[name] = {"metrics": met, "rel": rel, "param_max_abs_diff": diff,
                     "param_diff_over_lr": diff / lr}
        require(all(v <= 1e-5 for v in rel.values()), f"steps hold {name}: {rel}")
        require(diff <= 2 * lr, f"steps hold {name}: parameters differ by {diff}")
    del model, params, init, after
    return out


def steps_phase(torch, np) -> dict:
    """The production step functions of ``launch/steps.py`` on the card:
    areal-qwen-1.5b at full width, bf16 weights from seed 0 and f32 m and
    v, each step at a shape cut to one card (``STEPS_*``), each beside the
    dry run's prediction for exactly that shape on the one-card mesh
    (argument bytes, peak, FLOPs, bound) and the card's figures (the
    inputs' bytes, the peak allocated over the call, device ms by CUDA
    events, model FLOPs / ms / 989e12 as ``mfu``) and each kernel's
    launches.  Requires the predicted argument bytes to equal the inputs'
    bytes and, for train and prefill, predicted / measured peak within
    ``STEPS_PEAK_RATIO``; holds accum_steps 2 against 1 and the
    vocab-parallel loss against the plain one in f32; then part
    ``hybrid``: recurrentgemma-9b cut to 6 layers, prefill, serve and
    train steps (the linear scan and its gradient).  The two train
    predictions are traced in worker processes while the card works."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    t_phase = time.perf_counter()
    rows, seq, accum = STEPS_TRAIN
    with ProcessPoolExecutor(max_workers=2, mp_context=mp.get_context("spawn")) as pool:
        train_recs = {vp: pool.submit(train_prediction, rows, seq, accum, vp)
                      for vp in (False, True)}
        return steps_phase_body(torch, np, train_recs, t_phase)


def steps_phase_body(torch, np, train_recs, t_phase) -> dict:
    """``steps_phase`` with the train predictions in flight."""
    from repro_torch import optim
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RLConfig, ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.model import build_model

    cfg = get_model_config("areal-qwen-1.5b")
    L = cfg.n_layers
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "steps", "card": nvidia_smi(), "total_memory": props.total_memory,
          "roofline_memory": 80e9})
    lines = {}
    rows, seq, accum = STEPS_TRAIN
    cuts = {"train": f"train_4k: {rows} of 256 rows of {seq}, accum_steps {accum}",
            "prox": f"{STEPS_PROX_ROWS} rows of {seq}: its f32 logits take 2.5 GB a row",
            "prefill": f"prefill_32k: {STEPS_PREFILL[0]} of 32 rows of {STEPS_PREFILL[1]}",
            "serve": f"decode_32k: {STEPS_SLOTS} of 128 slots, each cache {STEPS_LEN} "
                     "positions, all of them visible",
            "chunk": f"one span of {STEPS_CHUNK} at the end of a {STEPS_LEN}-position slot"}
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    params = list(model.parameters())
    rng = np.random.default_rng(10)

    # train, without and with the vocab-parallel loss
    batch = steps_batch(torch, np, rng, cfg.vocab_size, rows, seq, torch.bfloat16)
    opt = optim.init_state(params)
    for vp in (False, True):
        rec = train_recs[vp].result()
        pred = predicted(rec)
        step = steps.make_train_step(model, RLConfig(), vocab_parallel_loss=vp,
                                     accum_steps=accum)
        if not vp:
            step(opt, batch)                                  # warm-up
        met, ms, peak, base, launches = measured_call(torch, step, opt, batch)
        name = "train_vp" if vp else "train"
        require_step_launches(name, launches, {"flash_attention": L * accum,
                                               "flash_attention_bwd": L * accum})
        vals = {k: float(v) for k, v in met.items()}
        require(all(math.isfinite(v) for v in vals.values()), f"steps {name}: {vals}")
        lines[name] = step_line(torch, name, pred, tensor_bytes(torch, params, opt["m"],
                                                                opt["v"], batch),
                                ms, peak, base, launches, rec["model_flops"], cut=cuts["train"],
                                metrics=vals)
    del opt, step, met
    # prox
    pbatch = {k: v[:STEPS_PROX_ROWS] for k, v in batch.items()}
    del batch
    pshape = ShapeConfig("train_4k_prox", seq_len=seq, global_batch=STEPS_PROX_ROWS,
                         kind="train")
    prec = dryrun.prox_dryrun(cfg, pshape)
    lp, ms, peak, base, launches = measured_call(torch, steps.make_prox_logprob_step(model),
                                                 pbatch)
    require_step_launches("prox", launches, {"flash_attention": L})
    require(bool(torch.isfinite(lp).all()), "steps prox: logprobs not finite")
    lines["prox"] = step_line(torch, "prox", predicted(prec), tensor_bytes(torch, params, pbatch),
                              ms, peak, base, launches, prec["model_flops"], cut=cuts["prox"])
    del pbatch, lp
    # prefill
    b, s = STEPS_PREFILL
    shape = ShapeConfig("prefill_32k_cut", seq_len=s, global_batch=b, kind="prefill")
    rec = dryrun.build_dryrun(cfg.name, shape.name, cfg=cfg, shape=shape)
    pre = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32))
           .cuda(), "length": torch.tensor([s, s - 4097], dtype=torch.int32, device="cuda")}
    prefill = steps.make_prefill_step(model, s, torch.bfloat16)
    (logits, cache), ms, peak, base, launches = measured_call(torch, prefill, pre)
    require_step_launches("prefill", launches, {"flash_attention": L})
    require(tuple(logits.shape) == (b, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
            "steps prefill: logits")
    require(cache["t"].tolist() == pre["length"].tolist(), "steps prefill: cache positions")
    lines["prefill"] = step_line(torch, "prefill", predicted(rec), tensor_bytes(torch, params, pre),
                                 ms, peak, base, launches, rec["model_flops"],
                                 cut=cuts["prefill"])
    del logits, cache, pre, prefill
    # serve: ring, paged, fused; then one chunk on the paged cache
    for name in ("serve", "serve_paged", "serve_fused"):
        lines.update(serve_steps(torch, np, rng, model, name, cuts))
    for name in ("train", "prefill"):
        r = lines[name]["peak_ratio"]
        require(STEPS_PEAK_RATIO[0] <= r <= STEPS_PEAK_RATIO[1],
                f"steps {name}: predicted / measured peak {r}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    hold = hold_steps(torch, np, cfg, RLConfig().lr)
    emit({"phase": "steps", "part": "hold", **hold})
    gc.collect()
    torch.cuda.empty_cache()
    lines["hybrid"] = steps_hybrid(torch, np)
    wall = time.perf_counter() - t_phase
    emit({"phase": "steps", "wall_s": wall})
    return lines


def serve_steps(torch, np, rng, model, name: str, cuts: dict) -> dict:
    """One decode step kind of ``steps_phase`` (``serve``: the ring cache;
    ``serve_paged``; ``serve_fused``, then the chunk span on its pool),
    its caches freed when it returns."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, steps

    cfg = model.cfg
    L = cfg.n_layers
    params = list(model.parameters())
    shape = ShapeConfig("decode_32k_cut", seq_len=STEPS_LEN, global_batch=STEPS_SLOTS,
                        kind="decode")
    token = torch.from_numpy(rng.integers(3, cfg.vocab_size, STEPS_SLOTS).astype(np.int32)).cuda()
    paged, fused = name != "serve", name == "serve_fused"
    rec = dryrun.build_dryrun(cfg.name, shape.name, cfg=cfg, shape=shape, block_size=STEPS_BLOCK,
                              paged_cache=paged, fused_decode=fused,
                              prefill_chunk=STEPS_CHUNK if fused else 0)
    if paged:
        n_blocks = STEPS_SLOTS * (-(-STEPS_LEN // STEPS_BLOCK))
        cache = model.init_paged_cache(STEPS_SLOTS, n_blocks, STEPS_BLOCK, torch.bfloat16)
        tables = fill_pool(torch, cache, STEPS_SLOTS, STEPS_LEN, STEPS_BLOCK, STEPS_LEN - 1)
        fn = steps.make_fused_serve_step(model) if fused else steps.make_paged_serve_step(model)
        args = (token, cache, tables)
        want = {"fused_decode_tail" if fused else "paged_decode_attention": L}
    else:
        cache = model.init_cache(STEPS_SLOTS, STEPS_LEN, torch.bfloat16)
        fill_ring(torch, cache, STEPS_LEN - 1)
        fn, args, want = steps.make_serve_step(model), (token, cache), {"decode_attention": L}
    inputs = tensor_bytes(torch, params, args)

    def decode(*a):
        cache["t"].fill_(STEPS_LEN - 1)           # every call the last position
        return fn(*a)[0]
    decode(*args)                                 # warm-up
    logits, ms, peak, base, launches = measured_call(torch, decode, *args, iters=8)
    require_step_launches(name, launches, want)
    require(bool(torch.isfinite(logits).all()), f"steps {name}: logits not finite")
    out = {name: step_line(torch, name, predicted(rec), inputs, ms, peak, base, launches,
                           rec["model_flops"], cut=cuts["serve"])}
    if fused:
        start = STEPS_LEN - STEPS_CHUNK
        c_tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, STEPS_CHUNK))
                                 .astype(np.int32)).cuda()
        pos = torch.arange(start, STEPS_LEN, device="cuda")
        dest = tables[0, pos // STEPS_BLOCK][None].to(torch.int32)
        c_args = (c_tok, cache, tables[:1].contiguous(), dest,
                  torch.zeros(1, dtype=torch.int32, device="cuda"),
                  torch.tensor([start], dtype=torch.int32, device="cuda"),
                  torch.tensor([STEPS_CHUNK], dtype=torch.int32, device="cuda"))
        chunk = steps.make_paged_prefill_chunk_step(model)
        chunk_logits = lambda *a: chunk(*a)[0]
        chunk_logits(*c_args)                     # warm-up
        logits, ms, peak, base, launches = measured_call(torch, chunk_logits, *c_args)
        require_step_launches("chunk", launches, {"paged_prefill_attention": L})
        require(bool(torch.isfinite(logits).all()), "steps chunk: logits not finite")
        out["chunk"] = step_line(torch, "chunk", predicted(rec, "chunk"),
                                 tensor_bytes(torch, params, c_args), ms, peak, base, launches,
                                 2.0 * cfg.param_count() * STEPS_CHUNK, cut=cuts["chunk"])
    return out


def steps_hybrid(torch, np) -> dict:
    """recurrentgemma-9b at full width cut to 6 layers (4 RG-LRU, 2 local
    attention): ``prefill_step``, ``serve_step`` and ``train_step`` on the
    card, each beside its prediction, so that the linear scan and its
    gradient run behind the step functions."""
    import dataclasses as _dc
    from repro_torch import optim
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RLConfig, ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.model import build_model

    cfg = _dc.replace(get_model_config("recurrentgemma-9b"), n_layers=HYBRID_STEPS["layers"])
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    params = list(model.parameters())
    n_rec, n_attn = model.n_rec, model.n_attn
    rng = np.random.default_rng(12)
    out = {}
    cut = "depth: 6 of 38 layers, as train_hybrid; "
    b, s = HYBRID_STEPS["prefill"]
    shape = ShapeConfig("prefill_hybrid", seq_len=s, global_batch=b, kind="prefill")
    rec = dryrun.build_dryrun(cfg.name, shape.name, cfg=cfg, shape=shape)
    pre = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32))
           .cuda(), "length": torch.full((b,), s, dtype=torch.int32, device="cuda")}
    fn = steps.make_prefill_step(model, s, torch.bfloat16)
    fn(pre)
    logits, ms, peak, base, launches = measured_call(torch, lambda b: fn(b)[0], pre)
    require_step_launches("hybrid prefill", launches, {"linear_scan": n_rec,
                                                       "flash_attention": n_attn})
    require(bool(torch.isfinite(logits).all()), "steps hybrid prefill: logits")
    out["prefill"] = step_line(torch, "hybrid_prefill", predicted(rec),
                               tensor_bytes(torch, params, pre), ms, peak, base, launches,
                               rec["model_flops"], cut=cut + f"{b} rows of {s}")
    del logits
    slots = HYBRID_STEPS["slots"]
    shape = ShapeConfig("decode_hybrid", seq_len=s, global_batch=slots, kind="decode")
    rec = dryrun.build_dryrun(cfg.name, shape.name, cfg=cfg, shape=shape)
    cache = model.init_cache(slots, s, torch.bfloat16)
    fill_ring(torch, cache, s - 1)
    token = torch.from_numpy(rng.integers(3, cfg.vocab_size, slots).astype(np.int32)).cuda()
    fn = steps.make_serve_step(model)

    def decode(tok, c):
        c["t"].fill_(s - 1)
        return fn(tok, c)[0]
    decode(token, cache)
    logits, ms, peak, base, launches = measured_call(torch, decode, token, cache, iters=8)
    require_step_launches("hybrid serve", launches, {"decode_attention": n_attn})
    require(bool(torch.isfinite(logits).all()), "steps hybrid serve: logits")
    out["serve"] = step_line(torch, "hybrid_serve", predicted(rec),
                             tensor_bytes(torch, params, token, cache), ms, peak, base, launches,
                             rec["model_flops"], cut=cut + f"{slots} slots, window ring full")
    del cache, logits
    rows, seq, accum = HYBRID_STEPS["train"]
    shape = ShapeConfig("train_hybrid", seq_len=seq, global_batch=rows, kind="train")
    rec = dryrun.build_dryrun(cfg.name, shape.name, cfg=cfg, shape=shape, accum_steps=accum)
    batch = steps_batch(torch, np, rng, cfg.vocab_size, rows, seq, torch.bfloat16)
    opt = optim.init_state(params)
    step = steps.make_train_step(model, RLConfig(), accum_steps=accum)
    met, ms, peak, base, launches = measured_call(torch, step, opt, batch)
    require_step_launches("hybrid train", launches, {
        "linear_scan": n_rec * accum, "linear_scan_bwd": n_rec * accum,
        "flash_attention": n_attn * accum, "flash_attention_bwd": n_attn * accum})
    vals = {k: float(v) for k, v in met.items()}
    require(all(math.isfinite(v) for v in vals.values()), f"steps hybrid train: {vals}")
    out["train"] = step_line(torch, "hybrid_train", predicted(rec),
                             tensor_bytes(torch, params, opt["m"], opt["v"], batch), ms, peak,
                             base, launches, rec["model_flops"],
                             cut=cut + f"{rows} rows of {seq}, accum_steps {accum}",
                             metrics=vals)
    del model, params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="environment, build and kernel checks only")
    ap.add_argument("--profile", action="store_true",
                    help="after the serving paths, trace a few decode steps with torch.profiler")
    args = ap.parse_args()
    t_main = time.perf_counter()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch is missing; run it from a checkout of "
              "the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    # 1. environment
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})

    # 2. build, every source at once
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": {n: r["seconds"] for n, r in report.items()},
          "ptxas": {n: [ln.strip() for ln in r["log"].splitlines()
                        if any(k in ln for k in ("registers", "spill", "Function properties",
                                                 "Performance Loss", "wgmma", "serializ"))]
                    for n, r in report.items()}})

    # 3. kernels against their plain versions, timed
    timed = kernel_phase(torch, np, args.quick)
    timed.update(paged_kernel_phase(torch, np, args.quick))
    timed.update(hybrid_kernel_phase(torch, np, args.quick))
    wide = hd256_kernel_phase(torch, np, args.quick)
    timed.update(train_kernel_phase(torch, np, args.quick))
    moe_shapes = moe_kernel_phase(torch, np, args.quick)
    encdec_shapes = encdec_kernel_phase(torch, np, args.quick)
    # 4. small models, card against CPU
    small_phase(torch, np)
    small_gateway_phase(torch, np)
    small_hybrid_phase(torch, np)
    small_spec_phase(torch, np)
    small_train_phase(torch, np)
    small_moe_phase(torch, np)
    small_encdec_phase(torch, np)
    small_xlstm_phase(torch, np)
    if not args.quick:
        # 5-7. the serving paths at full width: ring, paged with chunked
        # prefill and the fused tail, paged monolithic and unfused
        models = build_models(torch)
        ring, engine, reqs, step_ms = serve_phase(torch, np, models)
        paged, paged_engine, paged_reqs, paged_ms = serve_paged_phase(torch, np, models,
                                                                       fused=True)
        unfused, unfused_engine, _, unfused_ms = serve_paged_phase(torch, np, models,
                                                                   fused=False)
        # 7b. the serving gateway, on the same dense model
        gateway = serve_gateway_phase(torch, np, models)
        # 7c. self-speculative decoding, ring and paged
        spec, _ = serve_spec_phase(torch, np, models)
        if args.profile:
            profile_phase(torch, "serve", engine, reqs, step_ms)
            profile_phase(torch, "serve_paged", paged_engine, paged_reqs, paged_ms)
            profile_phase(torch, "serve_paged_unfused", unfused_engine, paged_reqs, unfused_ms)
        # 8. the RG-LRU hybrid at full width, after the dense models are freed
        del models, engine, paged_engine, unfused_engine
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_models = build_hybrid_models(torch)
        hybrid, hybrid_engine, hybrid_reqs, hybrid_ms, hybrid_prefill_ms = serve_hybrid_phase(
            torch, np, hybrid_models)
        if args.profile:
            profile_phase(torch, "serve_hybrid", hybrid_engine, hybrid_reqs, hybrid_ms)
            profile_prefill_phase(torch, hybrid_engine, hybrid_reqs, hybrid_prefill_ms)
        # 8b. the hybrid on the paged cache and in chunked prefill, past its window
        hybrid_paged, _ = serve_hybrid_paged_phase(torch, np, hybrid_models)
        # 8c. the hybrid's RL loop at full width, 6 layers, after its models are freed
        del hybrid_models, hybrid_engine
        gc.collect()
        torch.cuda.empty_cache()
        train_hybrid = train_hybrid_phase(torch, np)
        # 9. the trainer at full width
        gc.collect()
        torch.cuda.empty_cache()
        train = train_phase(torch, np, args.profile)
        # 10. the virtual-clock training loop, after the trainer's models are freed
        gc.collect()
        torch.cuda.empty_cache()
        loop = train_loop_phase(torch, args.profile)
        # 11. the threaded runtime, the rollout and trainer threads on two streams
        threaded, threaded_walls = threaded_phase(torch, args.profile)
        # 12. the process fleet: rollout workers and a trainer replica as processes
        fleet = fleet_phase(torch, threaded_walls)
        # 14-16. mixture of experts served and trained at full width, and
        # the VLM prefix
        gc.collect()
        torch.cuda.empty_cache()
        moe_launches = {"serve_moe": serve_moe_phase(torch, np, args.profile)}
        moe_launches["serve_vlm"] = serve_vlm_phase(torch, np)
        moe_launches["train_moe"] = {"loop": train_moe_phase(torch, np)}
        for phase, parts in moe_launches.items():
            for part, counts in parts.items():
                require(any(counts.values()), f"{phase} {part} launched no kernel")
        # 17-19. the enc-dec family and xLSTM at full width (xLSTM's blocks
        # have no kernel: their phases require that none is launched)
        gc.collect()
        torch.cuda.empty_cache()
        encdec = serve_encdec_phase(torch, np)
        for part, counts in encdec.items():
            require(any(counts.values()), f"serve_encdec {part} launched no kernel")
        serve_xlstm_phase(torch, np, args.profile)
        train_xlstm_phase(torch, np)
        # 20. the production step functions beside the dry run's predictions
        gc.collect()
        torch.cuda.empty_cache()
        step_lines = steps_phase(torch, np)
        step_launches = {name: r["card"]["launches"] for name, r in step_lines.items()
                         if name != "hybrid"}
        step_launches.update({f"hybrid_{name}": r["card"]["launches"]
                              for name, r in step_lines["hybrid"].items()})
        launches = {"flash_attention": ring["flash_attention"],
                    "decode_attention": ring["decode_attention"],
                    "paged_prefill_attention": paged["paged_prefill_attention"],
                    "fused_decode_tail": paged["fused_decode_tail"],
                    "paged_decode_attention": unfused["paged_decode_attention"],
                    "linear_scan": hybrid["linear_scan"],
                    "flash_attention_bwd": train["flash_attention_bwd"],
                    "linear_scan_bwd": train_hybrid["linear_scan_bwd"]}
        missing = [n for n in ("fused_decode_tail", "flash_attention_bwd", "linear_scan_bwd",
                               "linear_scan", "paged_prefill_attention", "flash_attention")
                   if not train_hybrid[n]]
        if missing:
            raise AssertionError(f"kernels never launched on train_hybrid: {missing}")
        missing = [n for n, c in launches.items() if not c]
        if missing:
            raise AssertionError(f"kernels never launched on their paths: {missing}")
        rows = []
        for name in REPLACES:
            r = timed[name]
            rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                         "replaces": REPLACES[name], "launches": launches[name],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
            if "library" in r:
                rows[-1]["library"] = r["library"]
            if name in LOOP_KERNELS:
                rows[-1]["launches_train_loop"] = {part: c[name] for part, c in loop.items()}
            if any(c[name] for c in threaded.values()):
                rows[-1]["launches_threaded"] = {part: c[name] for part, c in threaded.items()}
            if any(c[name] for c in fleet.values()):
                rows[-1]["launches_fleet"] = {part: c[name] for part, c in fleet.items()}
            if any(c[name] for c in gateway.values()):
                rows[-1]["launches_serve_gateway"] = {part: c[name]
                                                      for part, c in gateway.items()}
            for phase, counts in (("serve_spec", spec), ("serve_hybrid_paged", hybrid_paged)):
                if any(c[name] for c in counts.values()):
                    rows[-1][f"launches_{phase}"] = {part: c[name] for part, c in counts.items()}
            if train_hybrid[name]:
                rows[-1]["launches_train_hybrid"] = train_hybrid[name]
            rows[-1]["launches_steps"] = {step: c[name] for step, c in step_launches.items()
                                          if c.get(name)}
            require(rows[-1]["launches_steps"], f"{name} never launched behind a step function")
            for phase, parts in (*moe_launches.items(), ("serve_encdec", encdec)):
                if any(c[name] for c in parts.values()):
                    rows[-1][f"launches_{phase}"] = {part: c[name] for part, c in parts.items()}
            if encdec_shapes.get(name):
                rows[-1]["encdec_shapes"] = [{f: rec[f] for f in (
                    "case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")} for rec in encdec_shapes[name]]
            if moe_shapes.get(name):
                rows[-1]["moe_shapes"] = [{f: rec[f] for f in (
                    "case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "paged_decode_plus_matmul_ms") if f in rec}
                    for rec in moe_shapes[name]]
            # the hybrid's widths (head_dim 256, group 16, window 2048) and
            # speculative decoding's verify spans
            for key, rec in (("hd256", wide.get(name) or timed.get(f"{name}_hd256")),
                             ("verify_hd128", wide.get("verify_hd128")
                              if name == "paged_prefill_attention" else None),
                             ("verify_hd256", wide.get("verify_hd256")
                              if name == "paged_prefill_attention" else None)):
                if rec is not None:
                    rows[-1][key] = {f: rec[f] for f in (
                        "case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "paged_decode_plus_matmul_ms") if f in rec}
        emit({"phase": "wall", "seconds": time.perf_counter() - t_main})
        emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

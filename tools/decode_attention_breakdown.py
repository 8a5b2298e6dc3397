#!/usr/bin/env python3
"""Time the ring decode attention kernel's split plans on one NVIDIA H100.

    python3 tools/decode_attention_breakdown.py

Times ``repro_torch``'s decode_attention kernel in bf16 at the ring
serving paths' shapes (B=8 slots, W=768, ring caches as ``chip_smoke.py``
makes them; H=12 Hkv=2 hd=128 for areal-qwen-1.5b, H=16 Hkv=1 hd=256 for
recurrentgemma-9b's local layers) with ``chip_smoke.py``'s timer (CUDA
events, L2 flushed), under forced split plans from one split (no merge,
B x Hkv blocks) to the most the resident grid takes: more splits put
more blocks on the card and more records in each merge, so the sweep
shows where the two balance.  Beside them the wrapper's own plan, SDPA
on the same inputs, and the timer's floor: one launch of a kernel that
adds 1 to one element.  Prints one JSON object.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_breakdown.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da

    build.build(["decode_attention"])
    timer = cs.Timer(torch)
    rng = np.random.default_rng(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    one = torch.zeros(1, device="cuda")
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi(),
              "floor_ms": timer(lambda: one.add_(1)), "shapes": []}
    b, w = 8, 768
    for h, hkv, hd in ((12, 2, 128), (16, 1, 256)):
        q, kc, vc, pos, t = cs.decode_inputs(torch, np, rng, torch.bfloat16, b, h, hkv, hd, w)
        valid = cs.decode_mask(pos, t, 0)
        qx, kx, vx = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        mask = valid[:, None, None, :]
        cap = da._capacity(1, hd, q.device)
        most = min(-(-w // da.TILE), cap // (b * hkv))
        plan = da.split_plan(b, hkv, w, n_sm, cap)
        ms = {}
        for n_split in sorted({1, 2, 4, 8, 12, 16, plan, 24, 33, most}):
            if n_split <= most:
                ms[n_split] = timer(lambda: da.decode_attention_split(q, kc, vc, pos, t, n_split))
        result["shapes"].append({
            "case": f"B={b} W={w} H={h} Hkv={hkv} hd={hd}", "plan": plan,
            "blocks_at_plan": b * hkv * plan, "resident_blocks": cap, "ms_by_n_split": ms,
            "ms": timer(lambda: da.decode_attention_cuda(q, kc, vc, pos, t)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                qx, kx, vx, attn_mask=mask, enable_gqa=True))})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

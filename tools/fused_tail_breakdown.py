#!/usr/bin/env python3
"""Apportion the fused decode tail's device time on one NVIDIA H100.

    python3 tools/fused_tail_breakdown.py

Times ``repro_torch``'s fused_decode_tail kernel in bf16 at the paged
serving path's shapes (8 slots in groups of 4 sharing their prompt
blocks, t in [256, 768), pool (384, 16, 2, 128), wo 1536 x 1536), with
``chip_smoke.py``'s timer (CUDA events, L2 flushed), under variants:

  * the split plan of the wrapper, and splits of 12 and 64 positions:
    phase 2 merges every split once per D tile, so its cost shows as a
    slope in the number of splits;
  * t = 0 in every slot, which leaves phase 1 one key per slot;
  * wo cut to 64 columns, one D tile per slot;
  * half the resident grid, so each block takes twice the items;

and beside them the unfused path it stands against: paged decode
attention, the ``wo`` matmul, and both.  Prints one JSON object.
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
        print("fused_tail_breakdown.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_decode_tail as ft
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda

    build.build(["fused_decode_tail", "paged_decode_attention"])
    timer = cs.Timer(torch)
    rng = np.random.default_rng(1)
    b, h, hkv, hd, bs, entries, dm = 8, 12, 2, 128, 16, 48, 1536
    dt = torch.bfloat16
    kp, vp, tab, t = cs.engine_pool(np, rng, b, hkv, hd, bs, entries, 256, 768)
    card = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", dt)
    ints = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    q = card(rng.standard_normal((b, h, hd), dtype=np.float32))
    kp, vp, tab, t = card(kp), card(vp), ints(tab), ints(t)
    wo = card(rng.standard_normal((h * hd, dm), dtype=np.float32) * (h * hd) ** -0.5)
    wo64 = wo[:, :64].contiguous()
    t0 = torch.zeros_like(t)
    grid = ft._resident_grid(1, h, hkv, hd, q.device)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, n_split = ft.split_rows(b, entries * bs, n_sm)
    scale = hd ** -0.5

    def fused(tt=t, r=rows, g=grid, w=wo):
        return ft._launch(q, kp, vp, w, tab, tt, 0, scale, r, g)

    want = fused()
    for r in (12, 64):      # other split plans compute the same function
        torch.testing.assert_close(fused(r=r), want, atol=2e-2, rtol=2e-2)
    pd = lambda tt=t: paged_decode_attention_cuda(q, kp, vp, tab, tt)
    variants = {
        f"fused rows={rows} (the wrapper's plan, {n_split} splits)": fused,
        "fused rows=12": lambda: fused(r=12),
        "fused rows=64": lambda: fused(r=64),
        "fused t=0": lambda: fused(tt=t0),
        "fused rows=64 t=0": lambda: fused(tt=t0, r=64),
        "fused D=64": lambda: fused(w=wo64),
        "fused D=64 t=0": lambda: fused(tt=t0, w=wo64),
        f"fused grid={grid // 2}": lambda: fused(g=grid // 2),
        "paged_decode_attention": pd,
        "paged_decode_attention t=0": lambda: pd(t0),
        "matmul wo": lambda: torch.matmul(q.reshape(b, h * hd), wo),
        "paged_decode_attention + matmul wo":
            lambda: torch.matmul(pd().reshape(b, h * hd), wo),
    }
    ms = {name: timer(fn, iters=50) for name, fn in variants.items()}
    print(json.dumps({"tool": "fused_tail_breakdown", "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi(), "resident_grid": grid, "ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

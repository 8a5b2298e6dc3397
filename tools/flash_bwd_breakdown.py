#!/usr/bin/env python3
"""Time the bf16 flash-attention backward launch by launch on one NVIDIA H100.

    python3 tools/flash_bwd_breakdown.py [--baseline FILE.cu]

At the ``train`` phase's packed row (``chip_smoke.TRAIN_SHAPE``: B=1
S=6144 H=12 Hkv=2 hd=128, causal, ``TRAIN_SEGMENTS``: 8 segments of 727,
then 328 rows of -1 padding) and at B=1 S=768 (one sequence of 727, then
padding), with ``chip_smoke.py``'s timer (CUDA events, L2 flushed before
each launch), times:

- ``ms``: one whole call of ``flash_attention_bwd_cuda`` (prep, the main
  launch, the group sums);
- each launch alone, through ``flash_attention_bwd_parts``: ``prep`` (D,
  lse log2 e and the tiles' segment ranges), ``main`` (the dK/dV and dQ
  blocks in one launch), ``main_dkdv`` and ``main_dq`` (the main launch
  with only one kind of block), ``reduce`` (the group sums of the f32
  dK/dV partials);
- with ``--baseline``, another source of the kernel (the same C entry
  point; for example the parent commit's ``csrc/flash_attention_bwd.cu``,
  from ``git show <commit>:src/repro_torch/csrc/flash_attention_bwd.cu``)
  built as a scratch variant, in turns with the current kernel (baseline,
  current, current, baseline);
- SDPA's backward with the same bool mask (the library's yardstick);

beside the bound (10·hd flops a visible (query, key) pair over the bf16
tensor-core peak, or the bytes over HBM bandwidth) and the rate in
TFLOP/s at that count.  The gradients of the parts, run in order, are
checked against the plain backward and against the whole call, bitwise.
Also reports ptxas's registers and spills of the kernels and, from
``cuobjdump -sass``, each kernel's wgmma (HGMMA) instructions and its
atomic instructions with their opcodes (``ATOMS.MIN.S32`` is an integer
minimum on shared memory; a floating-point one names its type, such as
``RED.E.ADD.F32``).  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sass_counts(lib_path: Path) -> dict:
    """HGMMA (wgmma) and atomic instructions of each backward kernel
    function in the library's SASS, or why they were not counted."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"not_counted": str(e)}
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"hgmma": 0, "atomics": 0, "atomic_ops": []}
        elif fn is not None:
            counts[fn]["hgmma"] += bool(re.search(r"\bHGMMA\b", line))
            op = re.search(r"\b(?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*\b", line)
            if op:
                counts[fn]["atomics"] += 1
                if op.group(0) not in counts[fn]["atomic_ops"]:
                    counts[fn]["atomic_ops"].append(op.group(0))
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="a flash_attention_bwd.cu to time in turns with the current one")
    args = ap.parse_args()
    import ctypes

    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_bwd_breakdown.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import (_prepare, flash_attention_bwd_cuda,
                                                          flash_attention_bwd_parts)

    report = build.build(["flash_attention_bwd", "flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    baseline = None
    if args.baseline is not None:
        lib = build.load_variant("flash_attention_bwd_baseline", args.baseline.read_text())
        baseline = lib.flash_attention_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        baseline.argtypes = [p] * 14 + [i] * 6 + [ctypes.c_float, i, i, p]
        baseline.restype = ctypes.c_int

    timer = cs.Timer(torch)
    rng = np.random.default_rng(20)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi(),
              "ptxas": [ln.strip() for ln in report["flash_attention_bwd"]["log"].splitlines()
                        if any(k in ln for k in ("registers", "spill", "Function properties",
                                                 "wgmma", "serializ", "Performance Loss"))],
              "sass": sass_counts(build.library_path("flash_attention_bwd")),
              "baseline": str(args.baseline) if args.baseline else None, "cases": []}
    b, s, h, hkv, hd = cs.TRAIN_SHAPE
    for case, shape, lens in (("train: packed row", (b, s, h, hkv, hd), cs.TRAIN_SEGMENTS),
                              ("one sequence", (1, 768, h, hkv, hd), [727])):
        q, k, v, dout, seg = cs.bwd_inputs(torch, np, rng, torch.bfloat16, *shape, lens)
        out, lse = flash_attention_cuda(q, k, v, seg, return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg)
        grads, parts = flash_attention_bwd_parts(q, k, v, out, lse, dout, seg)
        for name in ("prep", "main", "reduce"):
            parts[name]()
        want = ref.flash_attention_bwd(q, k, v, out, lse, dout, segment_ids=seg)
        torch.cuda.synchronize()
        label = f"B={shape[0]} S={shape[1]} H={h} Hkv={hkv} hd={hd} {case}"
        err = 0.0
        for name, g, a, w in zip(("dq", "dk", "dv"), got, grads, want):
            cs.require(torch.equal(g, a), f"{label}: {name} of the parts differs from the call")
            err = max(err, cs.check(f"flash_attention_bwd {name}", g, w, "bfloat16", label))
            cs.check_norm(f"flash_attention_bwd {name}", g, w, "bfloat16", label)
        del want
        mask, flops, byts = cs.bwd_flops_bytes(torch, seg, shape[1], h, 0, True, q, k, got)
        call = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg)   # noqa: E731
        row = {"case": label, "max_abs_err": err, "flops": flops, "bytes": byts,
               **cs.bound(flops, byts, "bfloat16")}
        if baseline is not None:
            keep = []

            def base_call():
                grads_b, (cargs, tensors) = _prepare(q, k, v, out, lse, dout, seg, True, 0, None)
                keep[:] = [tensors]   # the scratch lives until the next call
                e = baseline(*cargs, torch.cuda.current_stream().cuda_stream)
                if e:
                    raise RuntimeError(f"baseline launch failed with CUDA error {e}")
                return grads_b
            bgrads = base_call()
            torch.cuda.synchronize()
            row["baseline_max_abs_diff"] = max(
                (x.float() - y.float()).abs().max().item() for x, y in zip(bgrads, got))
            t = [timer(base_call), timer(call), timer(call), timer(base_call)]
            row.update(baseline_ms=[t[0], t[3]], ms=[t[1], t[2]])
            del bgrads, keep
        else:
            row["ms"] = [timer(call)]
        row["parts_ms"] = {name: timer(fn) for name, fn in parts.items()}
        qx, kx, vx = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask, enable_gqa=True)
        dx = dout.transpose(1, 2)
        row["library_ms"] = timer(lambda: torch.autograd.grad(sdpa, (qx, kx, vx), dx,
                                                              retain_graph=True))
        row["tflops"] = flops / (min(row["ms"]) * 1e-3) / 1e12
        result["cases"].append(row)
        del sdpa, mask, qx, kx, vx, grads, parts, got
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

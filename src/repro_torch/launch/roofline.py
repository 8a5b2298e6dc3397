"""Roofline over the dry run's records (``launch/dryrun.py``), the
counterpart of ``repro/launch/roofline.py`` with the H100's constants
(NVIDIA H100 SXM data sheet, dense):

  compute    = FLOPs_per_device / peak            (989e12 bf16 FLOP/s)
  memory     = bytes_per_device / bw              (3.35e12 B/s HBM3)
  collective = sum over mesh axes of the axis's collective bytes / its link

FLOPs, bytes and collectives are those of rank 0's program, from the
aten ops, kernels and collectives it dispatches (``launch/op_analysis.py``;
the production meshes' under a fake process group).  The links follow
``launch/mesh.py``'s layout on HGX H100 nodes of 8 cards: the "model"
axis stays inside a node, on NVLink (450e9 B/s each way a card); the
"data" and "pod" axes cross nodes, on InfiniBand (a ConnectX-7 of 400
Gb/s a card, 50 GB/s each way).  A record without the collectives by
axis takes NVLink for all of them.  A mesh whose step is not traced
prints only its argument bytes and whether they fit.  These are
analytic figures, not device times.

MODEL_FLOPS is the analytic 6*N_active*D (train) / 2*N_active*D
(prefill) / 2*N_active*B (decode); MODEL_FLOPS / (FLOPs * devices) shows
how much of the counted compute is useful (attention, the PPO loss and
the optimizer push it below 1).  The xLSTM's reads high:
``param_count`` counts xlstm-1.3b as 1.96 B parameters where its init
holds 3.65 B.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9           # NVLink, each way a card: the "model" axis, inside a node
IB_BW = 400e9 / 8         # InfiniBand, 400 Gb/s a card: the data axes, across nodes
AXIS_LINK = {"model": LINK_BW, "data": IB_BW, "pod": IB_BW}
HBM_PER_CARD = 80e9


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    variant: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    useful_ratio: float
    temp_gb: float
    arg_gb: float
    fits: bool
    status: str
    reason: str = ""
    traced: bool = False
    rec: Dict = None

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def _variant(rec: Dict) -> str:
    return "+".join(filter(None, [
        "vp" if rec.get("vocab_parallel") else "",
        rec["remat_policy"] if rec.get("remat_policy") not in (None, "none") else "",
        "" if rec.get("fsdp", True) else "nofsdp",
        "paged" if rec.get("paged_cache") else "",
        "fused" if rec.get("fused_decode") else "",
        rec.get("extra", "")]))


def rows_from_record(rec: Dict) -> List[RooflineRow]:
    """One row a mesh of the record (one row for a skipped or failed one)."""
    variant = _variant(rec)
    if rec.get("status") != "ok":
        return [RooflineRow(rec["arch"], rec["shape"], "-", variant, 0, 0, 0, "-", 0, 0, 0,
                            False, rec.get("status", "?"),
                            rec.get("reason", rec.get("error", ""))[:120], False, rec)]
    return [row_from_record(rec, name) for name in rec["meshes"]]


def row_from_record(rec: Dict, mesh: str = "1x1") -> RooflineRow:
    m = rec["meshes"][mesh]
    mem = m["memory"]
    args = mem["argument_bytes"]
    base = dict(arch=rec["arch"], shape=rec["shape"], mesh=mesh, variant=_variant(rec),
                arg_gb=args / 1e9, status="ok", rec=rec)
    if m["program"] != "traced":
        return RooflineRow(compute_s=0.0, memory_s=0.0, collective_s=0.0, dominant="-",
                           useful_ratio=0.0, temp_gb=0.0, fits=args <= HBM_PER_CARD,
                           reason=m.get("reason", "not traced"), **base)
    by_axis = m.get("collectives_by_axis") or {"model": m["collectives"]}
    x = sum(v / AXIS_LINK.get(axis, LINK_BW) for axis, c in by_axis.items()
            for k, v in c.items() if not k.endswith("_count"))
    c, b = m["flops"] / PEAK_FLOPS, m["bytes"] / HBM_BW
    dom = max((c, "compute"), (b, "memory"), (x, "collective"))[1]
    useful = rec["model_flops"] / max(m["flops"] * m["n_devices"], 1e-9)
    return RooflineRow(compute_s=c, memory_s=b, collective_s=x, dominant=dom,
                       useful_ratio=useful, temp_gb=mem["temp_bytes"] / 1e9,
                       fits=args + mem["temp_bytes"] <= HBM_PER_CARD, traced=True, **base)


def load_rows(dirpath: str) -> List[RooflineRow]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            rows.extend(rows_from_record(json.load(f)))
    return rows


def bottleneck_hint(r: RooflineRow) -> str:
    if r.status != "ok" or not r.traced:
        return r.reason
    if r.dominant == "compute":
        if r.useful_ratio < 0.5:
            return ("most counted FLOPs are not the model's (useful ratio %.2f): "
                    "attention, the loss and the optimizer" % r.useful_ratio)
        return ("compute-bound at useful ratio %.2f: near roofline; try a larger batch "
                "a card" % r.useful_ratio)
    if r.dominant == "memory":
        return "HBM-bound: fuse or shrink intermediates, shard the largest resident tensor"
    return "collective-bound: reshard to cut the largest collective, overlap with compute"


def _terms(r: RooflineRow) -> str:
    if not r.traced:
        return "| - | - | - | - | - | - "
    return (f"| {r.compute_s:.3e} | {r.memory_s:.3e} | {r.collective_s:.3e} "
            f"| {r.dominant} | {r.useful_ratio:.2f} | {r.temp_gb:.2f} ")


def to_markdown(rows: List[RooflineRow]) -> str:
    out = ["| arch | shape | mesh | variant | compute s | memory s | collective s "
           "| bottleneck | useful | temp GB | args GB | fits | status |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        fits = ("Y" if r.fits else "N") + ("" if r.traced or r.status != "ok" else " (args)")
        out.append(f"| {r.arch} | {r.shape} | {r.mesh} | {r.variant or 'base'} {_terms(r)}"
                   f"| {r.arg_gb:.2f} | {fits} | {r.status} {r.reason} |")
    return "\n".join(out)


def summary(rows: List[RooflineRow], mesh: str) -> str:
    """A markdown table of the traced rows on ``mesh``: GFLOP a device,
    temporary GB and whether arguments and temporaries fit a card,
    collective GB over "model" and over the data axes, and the compute /
    memory / collective ms."""
    out = ["| arch | shape | variant | GFLOP a device | temp GB, fits | collective GB model / "
           "data | compute / memory / collective ms |", "|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.mesh != mesh or not r.traced:
            continue
        m = r.rec["meshes"][mesh]
        gb = {"model": 0.0, "data": 0.0}
        for axis, c in (m.get("collectives_by_axis") or {}).items():
            gb["model" if axis == "model" else "data"] += sum(
                v for k, v in c.items() if not k.endswith("_count")) / 1e9
        out.append(f"| {r.arch} | {r.shape} | {r.variant or 'base'} | {m['flops'] / 1e9:.4g} "
                   f"| {r.temp_gb:.3g} {'Y' if r.fits else 'N'} | {gb['model']:.3g} / "
                   f"{gb['data']:.3g} | {r.compute_s * 1e3:.4g} / {r.memory_s * 1e3:.4g} / "
                   f"{r.collective_s * 1e3:.4g} |")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# decode throughput against the roofline
# ---------------------------------------------------------------------------

def decode_roofline_tokens_per_s(bytes_per_token: float) -> float:
    """Single-stream decode is memory-bound: every generated token re-reads
    the weights and the request's decode state, so the card's ceiling is
    HBM_BW / bytes_per_token."""
    return HBM_BW / max(float(bytes_per_token), 1.0)


def decode_gap_rows(bench: Dict) -> List[Dict]:
    """Measured against roofline decode throughput per architecture family,
    from a ``families`` section: each entry's measured ``tokens_per_s``
    and analytic ``bytes_per_token`` split into ``param_bytes`` and
    ``state_bytes``.  The gap is clamped to (0, 1]."""
    rows = []
    for fam, f in sorted(bench.get("families", {}).items()):
        ceil = decode_roofline_tokens_per_s(f["bytes_per_token"])
        rows.append({
            "family": fam,
            "measured_tok_s": f["tokens_per_s"],
            "roofline_tok_s": ceil,
            "measured_over_roofline": min(1.0, f["tokens_per_s"] / ceil),
            "dominant_bytes": ("weights" if f["param_bytes"] >= f["state_bytes"] else "state"),
        })
    return rows


def decode_gap_report(bench: Dict) -> str:
    out = ["| family | measured tok/s | roofline tok/s | gap | dominant |",
           "|---|---|---|---|---|"]
    for r in decode_gap_rows(bench):
        out.append(f"| {r['family']} | {r['measured_tok_s']:.1f} "
                   f"| {r['roofline_tok_s']:.3e} "
                   f"| {r['measured_over_roofline']:.2e} "
                   f"| {r['dominant_bytes']} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--summary", default="", metavar="MESH",
                    help="one compact markdown row a traced record on MESH (e.g. 32x8)")
    ap.add_argument("--decode-bench", default="",
                    help="a JSON file with a 'families' section: print the per-family "
                         "decode tokens/s against the roofline instead")
    args = ap.parse_args(argv)
    if args.decode_bench:
        with open(args.decode_bench) as f:
            print(decode_gap_report(json.load(f)))
        return
    rows = load_rows(args.dir)
    if args.summary:
        print(summary(rows, args.summary))
        return
    if args.markdown:
        print(to_markdown(rows))
        return
    for r in rows:
        head = f"{r.arch:22s} {r.shape:12s} {r.mesh:7s} {r.variant or 'base':12s}"
        if r.traced:
            print(f"{head} C={r.compute_s:.2e} M={r.memory_s:.2e} X={r.collective_s:.2e} "
                  f"dom={r.dominant:10s} useful={r.useful_ratio:5.2f} temp={r.temp_gb:7.2f}GB "
                  f"args={r.arg_gb:7.2f}GB fits={'Y' if r.fits else 'N'}")
            print(f"    -> {bottleneck_hint(r)}")
        else:
            print(f"{head} args={r.arg_gb:7.2f}GB fits={'Y' if r.fits else 'N'} (args) "
                  f"{r.status} {r.reason}")


if __name__ == "__main__":
    main()

"""Tiny cells for the CPU tests: the harness's drivers, the port's plain
PyTorch paths and the reference at a size a test run holds."""
from __future__ import annotations

import json
from pathlib import Path

from hbench import harness

HB = Path(__file__).resolve().parent.parent


def config(name: str, **over):
    cfg = json.loads((HB / "configs" / name).read_text())
    cfg.update(over)
    return cfg


DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=500)
MOE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
           vocab_size=500, n_experts=8, experts_per_token=2)

ROLLOUT = {"kind": "rollout",
           "engine": {"n_slots": 8, "prompt_len": 32, "max_gen_len": 40, "cache": "paged",
                      "block_size": 4, "prefill_chunk": 16, "temperature": 1.0,
                      "fused_decode": None},
           "group_size": 4, "prompt_len": {"dist": "uniform", "lo": 8, "hi": 32, "levels": 4},
           "progress": {"dist": "uniform", "lo": 0, "hi": 40}, "check_requests": 2}

TRAIN = {"kind": "train",
         "rl": {"batch_size": 2, "answers_per_prompt": 4, "ppo_minibatches": 2,
                "microbatch_token_budget": 96, "decoupled_objective": True, "max_staleness": 8},
         "prompt_len": {"dist": "uniform", "lo": 8, "hi": 32},
         "answer_len": {"dist": "loguniform", "lo": 8, "hi": 64},
         "behav_logprob_std": 0.5, "check_steps": 2}

LOOSE = {"gap": 1e9, "lp_err": 1e9, "loss": 1e9, "grad": 1e9, "change": 1e9}


def cell(kind: str, moe: bool = False, seed: int = 7, seconds: float = 0.5, trace: bool = False,
         limits=None, dtype: str = "bfloat16", control: bool = False) -> harness.Cell:
    if moe:
        cfg = config("olmoe-1b-7b-8l.json", **MOE, dtype=dtype)
    else:
        cfg = config("areal-qwen-1.5b.json", **DENSE, dtype=dtype)
    traffic = ROLLOUT if kind == "rollout" else TRAIN
    keys = ("gap", "lp_err") if kind == "rollout" else ("loss", "grad", "change")
    lim = dict(limits) if limits else {k: LOOSE[k] for k in keys}
    return harness.Cell(name=f"tiny-{kind}", cfg=cfg, traffic=json.loads(json.dumps(traffic)),
                        seed=seed, seconds=seconds, trace=trace, limits=lim, device="cpu",
                        control=control)

"""The comparison that decides ``correct``, on the CPU at a tiny size:
the port against the reference where both compute in float32, the
control (fp8) reading well above the port in bfloat16, and each fault a
cell can have turning ``correct`` false under the cells' own limits."""
import json
from pathlib import Path

import pytest

from hbench import harness
from hbench.tests import tiny

HB = Path(__file__).resolve().parents[1]


def limits(cell):
    return json.loads((HB / "limits" / f"{cell}.json").read_text())


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_train_matches_reference_in_f32(moe):
    run = harness.run_cell(tiny.cell("train", moe=moe, dtype="float32"))
    r = run["readings"]
    assert r["loss"] < 1e-4 and r["grad"] < 1e-3 and r["change"] < 0.05, r
    assert run["failed"] == 0 and run["attempted"] >= 1


def test_rollout_matches_reference_in_f32():
    run = harness.run_cell(tiny.cell("rollout", dtype="float32"))
    r = run["readings"]
    assert run["extra"]["served_tokens"] > 20
    assert r["gap"] < 1e-3 and r["lp_err"] < 1e-3, r


@pytest.mark.parametrize("kind", ["rollout", "train"])
def test_control_reads_above_the_port(kind):
    run = harness.run_cell(tiny.cell(kind, control=True))
    prog, ctl = run["readings"], run["extra"]["control"]
    assert max(ctl[k] / max(prog[k], 1e-6) for k in prog) > 3.0, (prog, ctl)


def test_fault_token_altered(monkeypatch):
    from repro_torch.core.rollout import RolloutEngine
    sample = RolloutEngine._sample

    def altered(self, *a, **k):
        tok, lp = sample(self, *a, **k)
        return (tok + 1) % self.cfg.vocab_size, lp

    monkeypatch.setattr(RolloutEngine, "_sample", altered)
    run = harness.run_cell(tiny.cell("rollout", limits=limits("qwen15b-rollout-long")))
    assert not run["correct"], run["checks"]


def test_fault_cache_not_written(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_pool_scatter", lambda pool, writes, vals: None)
    run = harness.run_cell(tiny.cell("rollout", limits=limits("qwen15b-rollout-long")))
    assert not run["correct"], run["checks"]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_fault_state_unchanged(monkeypatch, moe):
    from repro_torch import optim
    from repro_torch.core import trainer

    def unchanged(cfg, params, grads, state):
        return {"grad_norm": optim.global_norm(grads), "lr": cfg.lr}

    monkeypatch.setattr(trainer.optim, "apply_updates", unchanged)
    run = harness.run_cell(tiny.cell("train", moe=moe, limits=limits("qwen15b-train")))
    assert run["readings"]["change"] == pytest.approx(1.0)
    assert not run["correct"], run["checks"]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_fault_half_batch(monkeypatch, moe):
    from repro_torch.core.trainer import PPOTrainer
    prepare = PPOTrainer._prepare

    def half(self, batch):
        return prepare(self, batch[: len(batch) // 2])

    monkeypatch.setattr(PPOTrainer, "_prepare", half)
    run = harness.run_cell(tiny.cell("train", moe=moe, limits=limits("qwen15b-train")))
    assert not run["correct"], run["checks"]

"""Quickstart: the full AReaL pipeline on the PyTorch port, the twin of
``examples/quickstart.py``.

A tiny Qwen-shaped policy learns single-digit arithmetic with
asynchronous PPO: interruptible rollout workers stream generations, the
staleness controller (eta=4) admits work, the trainer runs decoupled-PPO
updates, and weight updates interrupt + re-prefill in-flight requests.

    PYTHONPATH=src python -m repro_torch.launch.quickstart           # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
import argparse

from repro_torch.launch.train import run_training


def main():
    ap = argparse.ArgumentParser(description="the quickstart on the PyTorch port")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ctl, trainer, reward = run_training(
        arch="areal-qwen-1.5b",       # reduced to laptop scale automatically
        steps=12, eta=4, batch_size=32, answers_per_prompt=4,
        n_slots=16, max_operand=9, lr=3e-4, seed=1, device=args.device)
    print(f"\nDone: {trainer.version} PPO steps, "
          f"virtual time {ctl.clock:.1f}s, "
          f"accuracy {reward.recent_accuracy:.1%}, "
          f"{ctl.engine.interruptions} weight-update interruptions, "
          f"staleness histogram {ctl.stal_stats.histogram()}")


if __name__ == "__main__":
    main()

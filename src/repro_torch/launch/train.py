"""AReaL training launcher, the virtual-clock path of
``repro/launch/train.py``.

Runs the asynchronous RL pipeline (rollout engine + PPO trainer + the
shared scheduling core) for an architecture at a scale:

  * ``scale="laptop"`` (default): the reduced model with the math
    tokenizer's vocabulary, the runnable end-to-end driver
    (``launch/quickstart.py`` wraps it);
  * ``scale="pod"``: the full config.

in f32, under the deterministic virtual-clock executor
(``core/controller.py``): the engine's generation and the trainer's PPO
updates are real computation, on the CUDA device unless ``device`` says
otherwise; their concurrency is simulated under the reference's analytic
``TimingModel`` (``core/simulator.py::make_llm_timing``), so ``clock``
is virtual seconds of the reference's modelled pod, not time on this
device.

Later parts of the port, refused here with ``NotImplementedError``: the
threaded and fleet runtimes, environments and the async reward service,
the checkpoint spill (slice 5), and the paged engine's speculative and
fused decode through this launcher.

    python -m repro_torch.launch.train --steps 12 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core.config import EngineConfig
from repro_torch.core.controller import AsyncRLController, AsyncScheduler
from repro_torch.core.evaluate import evaluate
from repro_torch.core.rollout import Noise, RolloutEngine
from repro_torch.core.simulator import HardwareModel, WorkloadModel, make_llm_timing
from repro_torch.core.trainer import PPOTrainer
from repro_torch.core.weights import ParameterStore
from repro_torch.data import tokenizer
from repro_torch.data.dataset import PromptStream
from repro_torch.device import resolve
from repro_torch.models.model import build_model
from repro_torch.models.transformer import LM
from repro_torch.obs import trace


def _refuse_later_slices(*, runtime, env, reward_workers, fused_decode, spec_decode,
                         ckpt_dir) -> None:
    later = []
    if runtime != "virtual":
        later.append(f"runtime={runtime!r} (slice 5: the threaded and fleet runtimes)")
    if env:
        later.append(f"env={env!r} (slice 5: environments)")
    if reward_workers > 0:
        later.append("reward_workers > 0 (slice 5: the async reward service)")
    if fused_decode:
        later.append("fused_decode through run_training (the paged engine's remainder)")
    if spec_decode:
        later.append("spec_decode (the paged engine's remainder: speculative decoding)")
    if ckpt_dir:
        later.append("ckpt_dir (slice 5: the checkpoint spill)")
    if later:
        raise NotImplementedError("later parts of the PyTorch port: " + "; ".join(later))


def run_training(arch: str = "areal-qwen-1.5b", *, steps: int = 25,
                 scale: str = "laptop", eta: int = 4, decoupled: bool = True,
                 interruptible: bool = True, batch_size: int = 32,
                 answers_per_prompt: int = 4, n_slots: int = 16,
                 prompt_len: int = 24, max_gen_len: int = 16,
                 lr: float = 3e-4, seed: int = 1, adv_estimator: str = "grpo",
                 ckpt_dir: str = "", log_every: int = 1, max_operand: int = 9,
                 colocated_sync: bool = False, on_step=None,
                 runtime: str = "virtual", train_fraction: float = 0.25,
                 run_timeout: float = 0.0, final_eval: bool = True,
                 prefill_chunk: int = 0, env: str = "",
                 reward_workers: int = 0, reward_latency: float = 0.0,
                 reward_backlog: int = 64, sandbox_timeout: float = 2.0,
                 rollout_workers: int = 2, trainer_procs: int = 1,
                 elastic: bool = False, min_workers: int = 1,
                 weight_stream: str = "full", fused_decode: str = "",
                 spec_decode: int = 0, spec_draft_units: int = 0,
                 cache: str = "ring", block_size: int = 16,
                 pool_blocks: int = 0, evict: str = "off", device="cuda",
                 model: Optional[LM] = None, noise: Optional[Noise] = None):
    """End-to-end AReaL training on the synthetic math task, under the
    virtual-clock executor.  The reference's signature and defaults; the
    threaded/fleet-only arguments (``train_fraction``, ``run_timeout``,
    ``reward_backlog``, ``sandbox_timeout``, ``rollout_workers``,
    ``trainer_procs``, ``elastic``, ``min_workers``, ``weight_stream``)
    and ``spec_draft_units`` are accepted and unused, as the reference's
    virtual path leaves them.

    ``device`` is where the models compute (CUDA by default; an error,
    never a fall back to the CPU, where there is none).  Two keyword-only
    test hooks that the reference has no need of:

      * ``model``: the ``LM`` to start from (of the config this call
        builds, on ``device``) instead of one initialised from ``seed``;
        the trainer trains it in place;
      * ``noise``: the engine's Gumbel noise, ``noise(step, shape)``
        (``RolloutEngine(noise=)``), so a test can feed the reference's.

    Returns (controller, trainer, reward service), as the reference."""
    if runtime not in ("virtual", "threaded", "fleet"):
        raise ValueError(f"unknown runtime {runtime!r}")
    if env not in ("", "math", "code", "multiturn"):
        raise ValueError(f"unknown env {env!r}")
    _refuse_later_slices(runtime=runtime, env=env, reward_workers=reward_workers,
                         fused_decode=fused_decode, spec_decode=spec_decode,
                         ckpt_dir=ckpt_dir)
    dev = resolve(device)
    full_cfg = get_model_config(arch)
    cfg = full_cfg
    if scale == "laptop":
        cfg = reduced(cfg)
        cfg = dataclasses.replace(cfg, vocab_size=tokenizer.VOCAB_SIZE,
                                  name=cfg.name + "-math")
    rl = RLConfig(batch_size=batch_size, answers_per_prompt=answers_per_prompt,
                  max_staleness=eta, decoupled_objective=decoupled,
                  interruptible=interruptible, lr=lr,
                  microbatch_token_budget=max(256, prompt_len + max_gen_len),
                  ppo_minibatches=2, total_steps=steps,
                  adv_estimator=adv_estimator,
                  max_prompt_len=prompt_len, max_gen_len=max_gen_len)

    if model is None:
        model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    elif model.cfg != cfg or model.device != dev:
        raise ValueError(f"model= is {model.cfg.name} on {model.device}; this run builds "
                         f"{cfg.name} on {dev}")
    # the reference's engine and trainer share one immutable tree; here the
    # trainer updates its LM in place, so the engine serves its own copy
    serving = build_model(cfg, device=dev, dtype=model.dtype)
    serving.load_state_dict(model.state_dict())
    engine = RolloutEngine(serving, EngineConfig(
        n_slots=n_slots, prompt_len=prompt_len, max_gen_len=max_gen_len,
        seed=seed, prefill_chunk=prefill_chunk, cache=cache,
        block_size=block_size, n_blocks=pool_blocks or None, evict=evict),
        device=dev, noise=noise)
    trainer = PPOTrainer(model, rl)
    store = ParameterStore()
    stream = PromptStream(seed=seed, answers_per_prompt=answers_per_prompt,
                          max_operand=max_operand)

    def _on_step(log):
        if on_step:
            on_step(log)
        # publication is the virtual executor's side channel
        store.publish(log.version, trainer.params)
        if log.version % log_every == 0:
            print(f"v{log.version:4d} clock={log.clock:10.2f}s "
                  f"reward={log.reward_mean:+6.2f} acc={log.accuracy:.3f} "
                  f"stale={log.staleness_mean:.2f}/{log.staleness_max} "
                  f"loss={log.loss:+.4f} interrupts={log.interruptions}",
                  flush=True)

    sched = AsyncScheduler(prompt_stream=stream, rl=rl, on_step=_on_step)
    # virtual-clock cost model for a small pod (sec 7.1: 75/25 split);
    # costs reflect the TARGET architecture's size, not the reduced model
    hw = HardwareModel()
    wl = WorkloadModel(n_params=float(full_cfg.param_count()))
    timing = make_llm_timing(hw, wl,
                             n_gen_devices=96 if not colocated_sync else 128,
                             n_train_devices=32 if not colocated_sync else 128,
                             colocated=colocated_sync)
    timing.reward_latency = reward_latency
    ctl = AsyncRLController(engine=engine, trainer=trainer, scheduler=sched, rl=rl,
                            timing=timing)
    if trace.get().enabled:
        # the virtual executor traces in its own time base (DESIGN.md
        # §Clock domains)
        trace.get().set_clock(lambda: ctl.clock)
    ctl.run(steps)
    if scale == "laptop" and final_eval:
        # paper protocol: evaluate the FINAL checkpoint on held-out problems
        res = evaluate(trainer.params, n_problems=64, prompt_len=prompt_len,
                       max_gen_len=max_gen_len, max_operand=max_operand)
        ctl.final_eval = res
        print(f"final held-out eval: {res.accuracy:.1%} "
              f"({res.n_correct}/{res.n}, mean len {res.mean_len:.1f})")
    return ctl, trainer, ctl.reward


def main():
    ap = argparse.ArgumentParser(description="AReaL training on the PyTorch port, virtual clock")
    ap.add_argument("--arch", default="areal-qwen-1.5b")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--scale", default="laptop", choices=["laptop", "pod"])
    ap.add_argument("--eta", type=int, default=4,
                    help="max staleness (-1 = unbounded, 0 = synchronous)")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--answers-per-prompt", type=int, default=4)
    ap.add_argument("--slots", type=int, default=16,
                    help="concurrent generation slots (engine batch width)")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-gen", type=int, default=16,
                    help="max generated tokens per request")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--adv", default="grpo", choices=["grpo", "rloo", "mc"])
    ap.add_argument("--naive-ppo", action="store_true",
                    help="disable the decoupled objective (Eq. 2 baseline)")
    ap.add_argument("--no-interrupt", action="store_true")
    ap.add_argument("--sync-colocated", action="store_true",
                    help="model the synchronous shared-device baseline")
    ap.add_argument("--no-final-eval", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the models compute: cuda (default) or cpu")
    args = ap.parse_args()

    t0 = time.time()
    ctl, trainer, reward = run_training(
        args.arch, steps=args.steps, scale=args.scale, eta=args.eta,
        decoupled=not args.naive_ppo, interruptible=not args.no_interrupt,
        batch_size=args.batch_size, answers_per_prompt=args.answers_per_prompt,
        n_slots=args.slots, prompt_len=args.prompt_len, max_gen_len=args.max_gen,
        adv_estimator=args.adv, seed=args.seed, colocated_sync=args.sync_colocated,
        final_eval=not args.no_final_eval, device=args.device)
    print(json.dumps({
        "arch": args.arch, "runtime": "virtual", "steps": trainer.version,
        "wall_s": round(time.time() - t0, 1),
        "final_accuracy": reward.recent_accuracy,
        "effective_throughput_tok_s": ctl.effective_throughput(),
        "staleness_hist": ctl.stal_stats.histogram(),
        "virtual_hours": ctl.clock / 3600,
    }))


if __name__ == "__main__":
    main()

"""AReaL training launcher, after ``repro/launch/train.py``.

Runs the asynchronous RL pipeline (rollout engine + PPO trainer + the
shared scheduling core) for an architecture at a scale:

  * ``scale="laptop"`` (default): the reduced model with the math
    tokenizer's vocabulary, the runnable end-to-end driver
    (``launch/quickstart.py`` wraps it);
  * ``scale="pod"``: the full config.

in f32, on the CUDA device unless ``device`` says otherwise, under one
of two executors:

  * ``runtime="virtual"`` (default): the deterministic virtual-clock
    executor (``core/controller.py``): the engine's generation and the
    trainer's PPO updates are real computation; their concurrency is
    simulated under the reference's analytic ``TimingModel``
    (``core/simulator.py::make_llm_timing``), so ``clock`` is virtual
    seconds of the reference's modelled pod, not time on this device.
  * ``runtime="threaded"``: the real threaded runtime
    (``core/runtime.py``): a rollout thread and a trainer thread, each
    on its own CUDA stream.  With one CUDA device both share it; with
    more, ``launch/disaggregated.py::split_devices`` gives the engine and
    the trainer their own (paper Sec 7.1's 75/25 split by default) and
    the trainer thread copies each publication onto the engine's card.
    ``clock`` is wall seconds.
  * ``runtime="fleet"``: the multi-process fleet (``core/fleet.py``):
    ``rollout_workers`` rollout processes and ``trainer_procs`` trainer
    replicas under this process as supervisor, with heartbeats, crash
    requeue/respawn and (``elastic``) reward-backlog-driven
    grow/shrink.  Every process builds its own model from ``seed`` on
    ``device`` (one card is shared by all); engines draw per-request
    RNG streams, so trajectories do not depend on which worker ran
    them.  ``clock`` is wall seconds.

``env`` routes scoring through an environment (``repro_torch/env/``:
``"math"``, ``"code"``, ``"multiturn"``, whose continuation hook turns
chunked prefill on), and ``reward_workers > 0`` scores on an
``AsyncRewardService`` pool off the rollout thread (threaded runtime).
``fused_decode`` serves from the paged cache with the fused decode tail;
``spec_decode`` (with ``spec_draft_units``) decodes self-speculatively,
greedily.  ``ckpt_dir`` spills every 10th published version to
``<ckpt_dir>/v<version>.npz`` on a background thread.

    python -m repro_torch.launch.train --steps 12 [--runtime threaded|fleet] [--device cpu]
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
from repro_torch.core.runtime import ThreadedRuntime
from repro_torch.core.simulator import HardwareModel, WorkloadModel, make_llm_timing
from repro_torch.core.trainer import PPOTrainer
from repro_torch.core.weights import ParameterStore
from repro_torch.data import tokenizer
from repro_torch.data.dataset import PromptStream
from repro_torch.device import resolve
from repro_torch.kernels import build
from repro_torch.launch import cli, disaggregated
from repro_torch.models.model import build_model
from repro_torch.models.transformer import LM
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace


def _make_env(env: str, *, seed: int, max_operand: int, sandbox_timeout: float):
    from repro_torch.env import make_env
    kwargs = {"seed": seed}
    if env == "code":
        kwargs["timeout_s"] = sandbox_timeout
    else:
        kwargs["max_operand"] = max_operand
    return make_env(env, **kwargs)


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
    """End-to-end AReaL training on a verifiable environment, under the
    virtual-clock, the threaded or the fleet executor.  The reference's
    signature and defaults.

    ``env`` selects the workload: "" = the synchronous math path, "math"
    / "code" route scoring through the Environment protocol.
    ``reward_workers > 0`` (threaded or fleet runtime) scores on an
    ``AsyncRewardService`` pool off the rollout side; with the virtual
    runtime, ``reward_latency`` models the pipelined verification delay
    instead.  ``run_timeout`` bounds a threaded or fleet run (wall
    seconds, 0 = none); ``weight_stream`` is its publication transport
    ("full", "delta", "delta-q").  The fleet's own arguments:
    ``rollout_workers``, ``trainer_procs``, ``elastic``, ``min_workers``.

    ``device`` is where the models compute (CUDA by default; an error,
    never a fall back to the CPU, where there is none).  Two keyword-only
    test hooks that the reference has no need of:

      * ``model``: the ``LM`` to start from (of the config this call
        builds, on ``device``) instead of one initialised from ``seed``;
        the trainer trains it in place;
      * ``noise``: the engine's Gumbel noise, ``noise(step, shape)``
        (``RolloutEngine(noise=)``), so a test can feed the reference's.

    Neither reaches a fleet's worker processes, which build their own.

    Returns (executor, trainer, reward service): the virtual-clock
    controller, the threaded runtime or the process fleet, all with
    .history / .clock / .effective_throughput().  A fleet's trainer is
    its ``.version`` / ``.params`` view (``params`` the last version's
    host state dict)."""
    if runtime not in ("virtual", "threaded", "fleet"):
        raise ValueError(f"unknown runtime {runtime!r}")
    if env not in ("", "math", "code", "multiturn"):
        raise ValueError(f"unknown env {env!r}")
    if reward_workers > 0 and runtime == "virtual":
        raise ValueError("reward_workers > 0 needs runtime='threaded' or 'fleet' (the "
                         "virtual executor models pipelined verification with "
                         "reward_latency instead)")
    if runtime == "fleet" and (model is not None or noise is not None):
        raise ValueError("model= and noise= do not reach a fleet's worker processes")
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

    if reward_workers > 0 and not env:
        env = "math"                       # async scoring needs an Environment
    environment = continuation = None
    if env:
        environment = _make_env(env, seed=seed, max_operand=max_operand,
                                sandbox_timeout=sandbox_timeout)
        continuation = environment.continuation_hook()
        if continuation is not None and prefill_chunk <= 0:
            # a continuation re-enters the FIFO ingest queue, which only the
            # chunked engine has
            prefill_chunk = prompt_len
    eng_extra = {"cache": cache, "block_size": block_size,
                 "n_blocks": pool_blocks or None, "evict": evict}
    if fused_decode:
        eng_extra["cache"] = "paged"       # the fused tail is a paged-pool kernel
        eng_extra["fused_decode"] = fused_decode
    if spec_decode:
        eng_extra["spec_decode"] = spec_decode
        eng_extra["spec_draft_units"] = spec_draft_units or None
        eng_extra["temperature"] = 0.0     # speculation is greedy-only

    # with more than one card, the threaded runtime gives the engine and
    # the trainer their own (Sec 7.1's split); with one, both share it
    train_dev = roll_dev = dev
    if runtime == "threaded" and dev.type == "cuda" and torch.cuda.device_count() > 1:
        rolls, trains = disaggregated.split_devices(train_fraction)
        roll_dev, train_dev = rolls[0], trains[0]
        print(f"disaggregated: {len(rolls)} rollout / {len(trains)} trainer devices "
              f"(engine on {roll_dev}, trainer on {train_dev})", flush=True)
    engine = trainer = None
    if runtime != "fleet":                 # fleet workers build their own
        if model is None:
            model = build_model(cfg, device=train_dev).init(
                torch.Generator(device=train_dev).manual_seed(seed))
        elif model.cfg != cfg or model.device != train_dev:
            raise ValueError(f"model= is {model.cfg.name} on {model.device}; this run "
                             f"builds {cfg.name} on {train_dev}")
        # the reference's engine and trainer share one immutable tree; here the
        # trainer updates its LM in place, so the engine serves its own copy
        serving = build_model(cfg, device=roll_dev, dtype=model.dtype)
        serving.load_state_dict(model.state_dict())
        engine = RolloutEngine(serving, EngineConfig(
            n_slots=n_slots, prompt_len=prompt_len, max_gen_len=max_gen_len,
            seed=seed, prefill_chunk=prefill_chunk, continuation=continuation, **eng_extra),
            device=roll_dev, noise=noise)
        trainer = PPOTrainer(model, rl)
    store = ParameterStore(ckpt_dir=ckpt_dir or None, ckpt_every=10 if ckpt_dir else 0)
    if environment is None:
        stream = PromptStream(seed=seed, answers_per_prompt=answers_per_prompt,
                              max_operand=max_operand)
    else:
        from repro_torch.env import EnvPromptStream
        stream = EnvPromptStream(environment, answers_per_prompt)
    service = None
    if reward_workers > 0:
        from repro_torch.env import AsyncRewardService
        service = AsyncRewardService(environment, n_workers=reward_workers,
                                     max_backlog=reward_backlog)

    def _on_step(log):
        if on_step:
            on_step(log)
        if runtime == "virtual":
            # the threaded runtime publishes on the trainer thread itself;
            # here publication is the virtual executor's side channel
            store.publish(log.version, trainer.params, {"clock": log.clock})
        if log.version % log_every == 0:
            print(f"v{log.version:4d} clock={log.clock:10.2f}s "
                  f"reward={log.reward_mean:+6.2f} acc={log.accuracy:.3f} "
                  f"stale={log.staleness_mean:.2f}/{log.staleness_max} "
                  f"loss={log.loss:+.4f} interrupts={log.interruptions}",
                  flush=True)

    sched = AsyncScheduler(prompt_stream=stream, rl=rl, on_step=_on_step,
                           env=environment, reward_service=service)
    if runtime == "threaded":
        ctl = ThreadedRuntime(engine=engine, trainer=trainer, scheduler=sched, store=store,
                              rollout_device=roll_dev if roll_dev != train_dev else None,
                              weight_stream=weight_stream)
        ctl.run(steps, timeout=run_timeout or None)
    elif runtime == "fleet":
        from repro_torch.core import fleet as fleet_mod
        if continuation is not None:
            raise ValueError(
                "runtime='fleet' does not support multi-turn environments (the "
                "continuation hook would have to live inside the rollout worker process)")
        if dev.type == "cuda":
            # every kernel built once, here, before the workers are spawned:
            # each worker then only loads them
            build.build()
        ctl = fleet_mod.FleetRuntime(
            scheduler=sched,
            engine_factory=fleet_mod.build_engine,
            engine_factory_kwargs=dict(
                model_cfg=cfg, seed=seed, device=str(dev),
                engine_kwargs=dict(n_slots=n_slots, prompt_len=prompt_len,
                                   max_gen_len=max_gen_len, prefill_chunk=prefill_chunk,
                                   rng="request", **eng_extra)),
            trainer_factory=fleet_mod.build_trainer,
            trainer_factory_kwargs=dict(model_cfg=cfg, rl=rl, seed=seed, device=str(dev)),
            n_slots=n_slots, rollout_workers=rollout_workers,
            trainer_procs=trainer_procs, store=store, elastic=elastic,
            min_workers=min_workers, weight_stream=weight_stream)
        try:
            ctl.run(steps, timeout=run_timeout or None)
        finally:
            ctl.close()
        trainer = ctl.trainer              # canonical post-run state view
        if trainer.params is not None:
            model = build_model(cfg, device=dev)
            fleet_mod.load_host_weights(model, trainer.params)
    else:
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
    if scale == "laptop" and final_eval and env in ("", "math") and model is not None:
        # paper protocol: evaluate the FINAL checkpoint on held-out problems
        res = evaluate(model, n_problems=64, prompt_len=prompt_len,
                       max_gen_len=max_gen_len, max_operand=max_operand)
        ctl.final_eval = res
        print(f"final held-out eval: {res.accuracy:.1%} "
              f"({res.n_correct}/{res.n}, mean len {res.mean_len:.1f})")
    return ctl, trainer, ctl.reward


def main():
    ap = argparse.ArgumentParser(description="AReaL training on the PyTorch port")
    ap.add_argument("--arch", default="areal-qwen-1.5b")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--scale", default="laptop", choices=["laptop", "pod"])
    # engine / env / runtime flags are declared once, in launch/cli.py
    cli.add_engine_flags(ap, slots=16, seed=1)
    cli.add_env_flags(ap, default="", allow_legacy=True)
    cli.add_runtime_flags(ap)
    cli.add_obs_flags(ap)
    ap.add_argument("--eta", type=int, default=4,
                    help="max staleness (-1 = unbounded, 0 = synchronous)")
    ap.add_argument("--naive-ppo", action="store_true",
                    help="disable the decoupled objective (Eq. 2 baseline)")
    ap.add_argument("--no-interrupt", action="store_true")
    ap.add_argument("--sync-colocated", action="store_true",
                    help="model the synchronous shared-device baseline")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--answers-per-prompt", type=int, default=4)
    ap.add_argument("--adv", default="grpo", choices=["grpo", "rloo", "mc"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--no-final-eval", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the models compute: cuda (default) or cpu")
    args = ap.parse_args()
    cli.obs_setup(args, actor="train")

    t0 = time.time()
    ctl, trainer, reward = run_training(
        args.arch, steps=args.steps, scale=args.scale, eta=args.eta,
        decoupled=not args.naive_ppo, interruptible=not args.no_interrupt,
        batch_size=args.batch_size, answers_per_prompt=args.answers_per_prompt,
        n_slots=args.slots, prompt_len=args.prompt_len, max_gen_len=args.max_gen,
        adv_estimator=args.adv, seed=args.seed, ckpt_dir=args.ckpt_dir,
        colocated_sync=args.sync_colocated, runtime=args.runtime,
        train_fraction=args.train_fraction, run_timeout=args.run_timeout,
        final_eval=not args.no_final_eval, prefill_chunk=args.prefill_chunk,
        env=args.env, reward_workers=args.reward_workers,
        reward_latency=args.reward_latency, reward_backlog=args.reward_backlog,
        sandbox_timeout=args.sandbox_timeout, rollout_workers=args.rollout_workers,
        trainer_procs=args.trainer_procs, elastic=args.elastic,
        min_workers=args.min_workers, weight_stream=args.weight_stream,
        fused_decode=args.fused_decode, spec_decode=args.spec_decode,
        spec_draft_units=args.spec_draft_units, cache=args.cache,
        block_size=args.block_size, pool_blocks=args.pool_blocks, evict=args.evict,
        device=args.device)
    out = {
        "arch": args.arch, "runtime": args.runtime, "steps": trainer.version,
        "wall_s": round(time.time() - t0, 1),
        "final_accuracy": reward.recent_accuracy,
        "effective_throughput_tok_s": ctl.effective_throughput(),
        "staleness_hist": ctl.stal_stats.histogram(),
    }
    if args.env:
        out["env"] = args.env
    svc = getattr(ctl, "reward_service", None)
    if svc is not None:
        out["reward_service"] = svc.stats()
        svc.close()
    if args.runtime == "virtual":
        out["virtual_hours"] = ctl.clock / 3600
    else:
        out["run_wall_s"] = round(ctl.clock, 3)
        out["trainer_busy_fraction"] = round(ctl.trainer_busy_s / max(ctl.clock, 1e-9), 4)
        out["tokens_during_train"] = ctl.tokens_during_train
        out["n_devices"] = (torch.cuda.device_count()
                            if torch.device(args.device).type == "cuda" else 1)
        ctl.store.close()
    if args.runtime == "fleet":
        out["respawns"] = ctl.respawns
        out["requeued"] = ctl.requeued
        out["fleet_events"] = len(ctl.registry.events)
    stats = {"scheduler": obs_metrics.scrape(ctl.sched, surfaces=("publication_stats",))}
    eng = getattr(ctl, "engine", None)
    if eng is not None:
        stats["engine"] = obs_metrics.scrape(eng, surfaces=("stats", "stream_stats"))
    out["stats"] = stats
    out.update(cli.obs_finish(args, stats=stats))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

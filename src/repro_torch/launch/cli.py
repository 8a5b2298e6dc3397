"""Shared launcher argparse surface (DESIGN.md §Serving gateway).

A copy of ``repro/launch/cli.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.  The port's
``launch/train.py`` and ``launch/serve.py`` use this one.

Three launchers (serve/train/dryrun) historically re-declared ~30
overlapping flags each; this module is the single place every ENGINE,
ENVIRONMENT, RUNTIME and GATEWAY flag is defined:

  * ``add_engine_flags``  — the ``EngineConfig`` surface (slots, prompt
    window, KV-cache organization, eviction policy, chunked prefill,
    decode fast paths, seed).  ``dryrun=True`` emits the dry-run's
    boolean variants (``--paged-cache`` / ``--fused-decode`` as
    store_true) over the same destinations it can.
  * ``add_env_flags``     — workload + reward-service flags.
  * ``add_runtime_flags`` — executor selection for the training
    launcher (virtual/threaded/fleet and their knobs).
  * ``add_gateway_flags`` — the serving gateway's own flags (``--port``,
    ``--sla-ms``, ``--sessions``; the eviction policy ``--evict`` is an
    engine flag).
  * ``add_obs_flags``     — the telemetry surface shared by every
    launcher (DESIGN.md §Telemetry): ``--trace`` / ``--trace-out``
    enable the structured tracer and export a Chrome/Perfetto timeline;
    ``--metrics-snapshot`` dumps the metrics registry as JSON at exit.
    ``obs_setup`` / ``obs_finish`` are the two call sites a launcher
    needs — everything between them is instrumented library code.

``engine_config_from_args`` is the one bridge from parsed args to a
validated ``EngineConfig`` — launchers never assemble engine kwargs by
hand, so a new engine option is added exactly twice (the dataclass
field and its flag) instead of once per launcher.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

from repro_torch.core.config import EngineConfig


def add_engine_flags(ap: argparse.ArgumentParser, *, dryrun: bool = False,
                     slots: int = 8, prompt_len: int = 24, max_gen: int = 16,
                     seed: int = 0) -> None:
    """Declare the rollout-engine flag set (the ``EngineConfig``
    surface).  ``dryrun=True`` switches to the compile-matrix variants:
    no capacity/sampling flags, boolean ``--paged-cache`` /
    ``--fused-decode`` (the dry-run lowers one step function, it does
    not build an engine)."""
    if dryrun:
        ap.add_argument("--paged-cache", action="store_true",
                        help="decode shapes: lower the paged block-pool "
                             "decode step (DESIGN.md §Paged KV-cache pool) "
                             "instead of the ring-buffer serve_step")
        ap.add_argument("--block-size", type=int, default=16,
                        help="KV block width (tokens) for --paged-cache")
        ap.add_argument("--prefill-chunk", type=int, default=0,
                        help="decode shapes with --paged-cache: also lower "
                             "+ compile the chunked-prefill ingest step "
                             "with spans of N tokens "
                             "(DESIGN.md §Chunked prefill)")
        ap.add_argument("--fused-decode", action="store_true",
                        help="decode shapes with --paged-cache: lower the "
                             "fused fast-path step "
                             "(DESIGN.md §Fused decode tail)")
        return
    ap.add_argument("--slots", type=int, default=slots,
                    help="concurrent generation slots (engine batch width)")
    ap.add_argument("--prompt-len", type=int, default=prompt_len)
    ap.add_argument("--max-gen", type=int, default=max_gen,
                    help="max generated tokens per request")
    ap.add_argument("--cache", default="ring", choices=["ring", "paged"],
                    help="KV-cache organization: 'ring' = per-slot ring "
                         "buffers (default); 'paged' = global block pool + "
                         "per-slot block tables with prompt-prefix sharing "
                         "(DESIGN.md §Paged KV-cache pool)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block for --cache paged")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="paged pool size in blocks; 0 = worst-case "
                         "(slots * ceil(max_len / block_size))")
    ap.add_argument("--evict", default="off", choices=["off", "lru"],
                    help="refcount-0 prefix-block policy for --cache "
                         "paged: 'off' = pool exhaustion defers admission; "
                         "'lru' = evict the least-recently-released "
                         "unpinned prefix block and recompute on miss "
                         "(DESIGN.md §Prefix eviction policy)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: ingest at most N prompt tokens "
                         "per engine step so admission and weight-refresh "
                         "re-prefills never stall decoding (0 = monolithic; "
                         "switches to per-request RNG streams; DESIGN.md "
                         "§Chunked prefill)")
    ap.add_argument("--fused-decode", default="", choices=["", "fused",
                                                           "split"],
                    help="paged decode fast path: 'fused' = one dispatch "
                         "per step, 'split' = measurement baseline "
                         "(DESIGN.md §Fused decode tail)")
    ap.add_argument("--spec-decode", type=int, default=0,
                    help="self-speculative decoding: total tokens per round "
                         "(1 committed + N-1 truncated-layer drafts); "
                         "forces greedy sampling (0 = off; DESIGN.md "
                         "§Self-speculative decoding)")
    ap.add_argument("--spec-draft-units", type=int, default=0,
                    help="stacked units the draft pass runs (0 = all but "
                         "the last)")
    ap.add_argument("--seed", type=int, default=seed)


def engine_config_from_args(args: argparse.Namespace,
                            **overrides) -> EngineConfig:
    """Bridge parsed ``add_engine_flags`` args to a validated
    ``EngineConfig``.  ``overrides`` win over flag values (launchers use
    them for computed settings — e.g. the multiturn continuation hook,
    or forcing ``cache='paged'`` under ``--fused-decode``)."""
    kw = dict(
        n_slots=args.slots,
        prompt_len=args.prompt_len,
        max_gen_len=args.max_gen,
        seed=args.seed,
        cache=args.cache,
        block_size=args.block_size,
        n_blocks=args.pool_blocks or None,
        evict=args.evict,
        prefill_chunk=args.prefill_chunk,
        fused_decode=args.fused_decode or None,
        spec_decode=args.spec_decode,
        spec_draft_units=args.spec_draft_units or None,
    )
    if args.spec_decode:
        kw["temperature"] = 0.0            # speculation is greedy-only
    kw.update(overrides)
    return EngineConfig(**kw)


def add_env_flags(ap: argparse.ArgumentParser, *, default: str = "",
                  allow_legacy: bool = True) -> None:
    """Workload + reward-service flags (DESIGN.md §Environments and
    reward service).  ``allow_legacy`` keeps the '' choice (the training
    launcher's bit-for-bit pre-env path)."""
    choices = ([""] if allow_legacy else []) + ["math", "code", "multiturn"]
    ap.add_argument("--env", default=default, choices=choices,
                    help="verifiable environment (repro/env/): math = "
                         "arithmetic string-match, code = sandboxed snippet "
                         "vs unit tests, multiturn = the environment "
                         "answers back (auto-enables chunked prefill)"
                         + ("; '' keeps the legacy synchronous math path"
                            if allow_legacy else ""))
    ap.add_argument("--reward-workers", type=int, default=0,
                    help="async reward service worker threads; finished "
                         "generations are scored off the rollout thread "
                         "(0 = synchronous scoring)")
    ap.add_argument("--reward-latency", type=float, default=0.0,
                    help="virtual runtime only: modeled pipelined "
                         "verification latency (seconds) per trajectory")
    ap.add_argument("--reward-backlog", type=int, default=64,
                    help="async reward backlog bound: fresh admission "
                         "pauses while this many trajectories await "
                         "scoring")
    ap.add_argument("--sandbox-timeout", type=float, default=2.0,
                    help="--env code: wall-clock kill deadline (s) for the "
                         "verification sandbox subprocess")


def add_runtime_flags(ap: argparse.ArgumentParser) -> None:
    """Executor flags for the training launcher (virtual / threaded /
    fleet; DESIGN.md §Async runtime, §Fleet runtime)."""
    ap.add_argument("--runtime", default="virtual",
                    choices=["virtual", "threaded", "fleet"],
                    help="virtual-clock executor (deterministic), the "
                         "threaded disaggregated runtime (real concurrency) "
                         "or the multi-process elastic fleet (supervised "
                         "worker processes, DESIGN.md §Fleet runtime)")
    ap.add_argument("--rollout-workers", type=int, default=2,
                    help="--runtime fleet: initial number of rollout worker "
                         "processes")
    ap.add_argument("--trainer-procs", type=int, default=1,
                    help="--runtime fleet: trainer replica processes "
                         "(stateless executors — any M reproduces the "
                         "single-trainer step sequence)")
    ap.add_argument("--elastic", action="store_true",
                    help="--runtime fleet: grow the rollout fleet while "
                         "generation starves admission, shrink (graceful "
                         "drain) while the reward backlog saturates")
    ap.add_argument("--min-workers", type=int, default=1,
                    help="--runtime fleet --elastic: floor for shrink")
    ap.add_argument("--weight-stream", default="full",
                    choices=["full", "delta", "delta-q"],
                    help="trainer→rollout publication transport "
                         "(DESIGN.md §Streaming weight publication): full "
                         "= whole param tree per update; delta = chunked "
                         "bitwise-exact XOR delta stream under a version "
                         "fence; delta-q = int8-quantized delta chunks")
    ap.add_argument("--train-fraction", type=float, default=0.25,
                    help="trainer share of the device pool for the threaded "
                         "runtime's submesh split (Sec 7.1: 0.25)")
    ap.add_argument("--run-timeout", type=float, default=0.0,
                    help="hard wall-clock bound (s) on a threaded run; "
                         "0 = unbounded")


def add_gateway_flags(ap: argparse.ArgumentParser) -> None:
    """Serving-gateway flags (DESIGN.md §Serving gateway).  Declared
    here exactly once; ``--evict`` lives in ``add_engine_flags`` — it is
    allocator policy, not gateway policy."""
    ap.add_argument("--port", type=int, default=0,
                    help="serve HTTP on this port (0 = offline mode: run "
                         "the synthetic trace and print a JSON summary)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--sla-ms", type=float, default=0.0,
                    help="default relative deadline per request, "
                         "milliseconds in HTTP mode / gateway ticks "
                         "offline (0 = no deadline); requests can override "
                         "per-call with deadline_ms")
    ap.add_argument("--sessions", type=int, default=0,
                    help="offline mode: logical session-id space the "
                         "synthetic trace draws from (session-keyed "
                         "requests prefix-share their KV blocks; 0 = "
                         "sessionless)")


def add_obs_flags(ap: argparse.ArgumentParser) -> None:
    """Telemetry flags shared by serve/train/dryrun (DESIGN.md
    §Telemetry).  Tracing is strictly opt-in: without ``--trace`` the
    tracer stays disabled and provably inert (DESIGN.md §Disabled-mode
    guarantee), so default runs stay bit-for-bit."""
    g = ap.add_argument_group("observability")
    g.add_argument("--trace", action="store_true",
                   help="enable the structured tracer: engine step / "
                        "ingest spans, trainer steps, weight-stream "
                        "fences, gateway request lifecycle (DESIGN.md "
                        "§Telemetry)")
    g.add_argument("--trace-out", default="",
                   help="write the collected events as Chrome/Perfetto "
                        "trace_event JSON to this path at exit (implies "
                        "--trace; open in ui.perfetto.dev)")
    g.add_argument("--metrics-snapshot", default="",
                   help="write a JSON snapshot of the metrics registry "
                        "(counters / gauges / histograms, DESIGN.md "
                        "§Metrics registry) to this path at exit")


def obs_setup(args: argparse.Namespace, *, actor: str) -> bool:
    """Enable the global tracer from ``--trace`` / ``--trace-out``.
    Called once at launcher start, BEFORE any instrumented code runs;
    ``actor`` becomes the Perfetto process name (DESIGN.md §Clock
    domains — launchers running in a virtual time base re-point the
    clock afterwards with ``trace.get().set_clock``)."""
    enabled = bool(getattr(args, "trace", False)
                   or getattr(args, "trace_out", ""))
    if enabled:
        from repro_torch.obs import trace
        trace.configure(enabled=True, actor=actor)
    return enabled


def obs_finish(args: argparse.Namespace, *,
               stats: Optional[Dict[str, Dict]] = None,
               registry=None) -> Dict[str, str]:
    """Write the telemetry artifacts a launcher owes at exit: the
    ``--trace-out`` timeline and the ``--metrics-snapshot`` JSON (the
    final ``stats`` dicts are absorbed under their prefix first, so the
    snapshot carries every legacy counter surface).  ``registry``
    overrides the global registry — the serve launcher passes the
    gateway's own, which already holds the TTFT/ITL/queue-wait
    histograms.  Returns ``{artifact: path}`` for the launcher's
    summary line."""
    written: Dict[str, str] = {}
    if getattr(args, "trace", False) or getattr(args, "trace_out", ""):
        from repro_torch.obs import export
        path = getattr(args, "trace_out", "") or "trace.json"
        export.write_trace(path)
        written["trace"] = path
    snap_path = getattr(args, "metrics_snapshot", "")
    if snap_path:
        from repro_torch.obs import metrics as obs_metrics
        reg = registry if registry is not None else obs_metrics.get()
        for prefix, st in (stats or {}).items():
            if st:
                reg.absorb(prefix, st)
        with open(snap_path, "w") as f:
            f.write(reg.snapshot_json(indent=2, sort_keys=True))
        written["metrics"] = snap_path
    return written

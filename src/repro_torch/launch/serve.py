"""Serving launcher: a thin CLI over the serving gateway (``repro_torch/
serve/``, DESIGN.md §Serving gateway), the twin of ``repro/launch/serve.py``.

Two modes share one engine + gateway construction path:

  * ``--port N`` — serve HTTP: streaming ``POST /v1/completions`` plus
    ``/stats``, ``/metrics`` and ``/healthz`` (serve/http.py).  Handler
    threads only enqueue; a single driver thread owns the engine.
  * offline (default) — submit ``--requests`` synthetic requests drawn
    from ``--env`` through the gateway (optionally spread over
    ``--sessions`` logical sessions so consecutive requests in a
    session prefix-share KV blocks), pump to completion, verify, and
    print a JSON summary.

The model is the reduced config of ``--arch`` with the math tokenizer's
vocabulary, random weights from a generator seeded with ``--seed`` (or
``--ckpt``'s, a checkpoint in ``checkpoint/io.py``'s format), in f32 on
``--device`` (the card unless told otherwise).

    PYTHONPATH=src python -m repro_torch.launch.serve --cache paged --prefill-chunk 16
    PYTHONPATH=src python -m repro_torch.launch.serve --cache paged --evict lru \\
        --port 8000 --sla-ms 2000
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch import checkpoint
from repro_torch.configs import get_model_config, reduced
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.device import resolve
from repro_torch.env import make_env
from repro_torch.launch import cli
from repro_torch.models.model import build_model
from repro_torch.models.transformer import LM
from repro_torch.obs import trace
from repro_torch.serve import Gateway, GatewayServer


def build_gateway(args, *, model: Optional[LM] = None):
    """Model + engine + gateway from parsed flags (shared by both
    modes).  ``model``: an ``LM`` to serve instead of the one built from
    ``--arch`` and ``--seed``; the engine's cache takes its dtype."""
    if model is None:
        dev = resolve(args.device)
        cfg = dataclasses.replace(reduced(get_model_config(args.arch)),
                                  vocab_size=tokenizer.VOCAB_SIZE)
        model = build_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(args.seed))
        if args.ckpt:
            weights, _, meta = checkpoint.load(args.ckpt, model)
            model.load_state_dict(weights)
            print(f"loaded checkpoint {args.ckpt} (version {meta.get('version')})")
    env = make_env(args.env, seed=args.seed)
    continuation = env.continuation_hook()
    overrides = {"dtype": model.dtype}
    if continuation is not None:
        overrides["continuation"] = continuation
    if args.prefill_chunk <= 0:
        # the gateway resumes preempted requests, and a continuation
        # appends its turn, through the chunked ingest queue; default to
        # one-span-per-step prompt ingestion
        overrides["prefill_chunk"] = args.prompt_len
    ec = cli.engine_config_from_args(args, **overrides)
    engine = RolloutEngine(model, ec, device=model.device)
    return Gateway(engine), env


def run_offline(gw: Gateway, env, args) -> dict:
    answers = {}
    t0 = time.time()
    for i in range(args.requests):
        p = env.sample()
        sid = f"s{i % args.sessions}" if args.sessions else None
        rid = gw.submit(p.prompt_tokens, session=sid,
                        sla=args.sla_ms or None, answer=p.answer)
        answers[rid] = p.answer
    ticks = gw.run_until_idle()
    dt = time.time() - t0
    n_ok = 0
    toks = 0
    for rid, ans in answers.items():
        d = gw.drain(rid)
        if d["end"] is None:
            raise RuntimeError(f"request {rid} never finished")
        toks += len(d["tokens"])
        fin = SimpleNamespace(response=d["tokens"], answer=ans,
                              prompt=[], rid=rid)
        n_ok += int(env.verify(fin).ok)
    st = gw.stats()
    out = {
        "requests": len(answers), "ticks": ticks,
        "generated_tokens": toks, "tokens_per_s": round(toks / dt, 1),
        "mean_len": round(toks / max(1, len(answers)), 2),
        "env": args.env, "verified_ok": n_ok, "verified": len(answers),
        "sessions": args.sessions,
    }
    for k in ("sla_misses", "preemptions", "resumes", "evictions",
              "revivals", "deferred", "prefix_hit_rate", "session_hits",
              "ttft_p50", "ttft_p99"):
        out[k] = st[k]
    eng = gw.engine
    if eng.continuations:
        out["continuations"] = eng.continuations
        out["continuation_tokens"] = eng.continuation_tokens
    return out


def add_flags(ap: argparse.ArgumentParser) -> None:
    """The launcher's flags: its own, then ``cli``'s engine, environment,
    gateway and observability groups."""
    ap.add_argument("--arch", default="areal-qwen-1.5b")
    ap.add_argument("--requests", type=int, default=32,
                    help="offline mode: synthetic requests to serve")
    ap.add_argument("--ckpt", default="", help="load weights from checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="where the model computes: cuda (default) or cpu")
    cli.add_engine_flags(ap)
    cli.add_env_flags(ap, default="math", allow_legacy=False)
    cli.add_gateway_flags(ap)
    cli.add_obs_flags(ap)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the serving gateway on the PyTorch port")
    add_flags(ap)
    args = ap.parse_args(argv)
    cli.obs_setup(args, actor="serve")

    gw, env = build_gateway(args)
    if args.port:
        srv = GatewayServer(gw, host=args.host, port=args.port,
                            default_sla_ms=args.sla_ms)
        print(json.dumps({"serving": f"http://{args.host}:{srv.port}",
                          "arch": args.arch,
                          "evict": gw.engine.engine_config.evict}),
              flush=True)
        try:
            srv.serve_forever()
        finally:
            cli.obs_finish(args, stats={"gateway": gw.stats()},
                           registry=gw.metrics_registry())
    else:
        if trace.get().enabled:
            # offline mode runs on the gateway's deterministic tick
            # clock: trace in that time base (DESIGN.md §Clock domains)
            trace.get().set_clock(gw.now)
        out = run_offline(gw, env, args)
        out.update(cli.obs_finish(args, stats={"gateway": gw.stats()},
                                  registry=gw.metrics_registry()))
        print(json.dumps(out))


if __name__ == "__main__":
    main()

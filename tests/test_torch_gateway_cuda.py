"""The port's serving gateway on the card (``-m cuda``; skipped without
a CUDA device), and the HTTP checks the CPU test shares.

This file imports no JAX, so it runs on the GPU machine as it is: the
reduced dense model in f32 on the card against the same weights on the
CPU.  The noise is drawn on the host for both devices (a generator per
(seed, rid, draw), as the ``"request"`` scheme keys it), so that the two
devices sample from the same Gumbel draws:

  * ``test_small_gateway_card_matches_cpu``: the paged gateway (blocks
    of 4, LRU, chunked prefill of 8, the fused tail) with urgent traffic
    that preempts, and its twin without: each run's trajectories equal
    between the devices, and on the card the preempted run equals its
    twin token for token;
  * ``test_http_on_the_card``: ``GatewayServer`` over an engine on the
    card, 4 clients in two waves.
"""
import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.configs import get_model_config, reduced
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine, request_seed
from repro_torch.data import tokenizer
from repro_torch.models.model import build_model
from repro_torch.serve import Gateway, GatewayServer

SMALL = dict(n_slots=4, prompt_len=24, max_gen_len=24, seed=0, cache="paged", block_size=4,
             evict="lru", prefill_chunk=8, fused_decode="fused")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def models(device):
    """The reduced areal-qwen-1.5b in f32 (the math tokenizer's vocab):
    weights from a seeded CPU generator, on the CPU and on ``device``."""
    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                              vocab_size=tokenizer.VOCAB_SIZE)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    dev = build_model(cfg, device=device)
    dev.load_state_dict(cpu.state_dict())
    return cpu, dev


def host_noise(seed):
    """Gumbel noise of request ``rid``'s draw ``draw``, drawn on the
    host: the same numbers for an engine on any device."""
    tiny = torch.finfo(torch.float32).tiny

    def noise(rid, draw, shape):
        g = torch.Generator().manual_seed(request_seed(seed, rid, draw))
        return -torch.log(-torch.log(torch.rand(shape, generator=g).clamp_min(tiny)))
    return noise


def preemption_run(model, with_urgent: bool):
    """6 requests at priority 2 in 4 slots, and (``with_urgent``) 2 at
    priority 0 arriving after 6 ticks, which preempt.  Returns (tokens by
    rid of the 6, stats)."""
    eng = RolloutEngine(model, EngineConfig(**SMALL), device=model.device,
                        noise=host_noise(SMALL["seed"]))
    gw = Gateway(eng)
    rng = np.random.default_rng(0)
    prompt = lambda: rng.integers(3, tokenizer.VOCAB_SIZE, size=int(rng.integers(9, 20))).tolist()
    rids = [gw.submit(prompt(), priority=2) for _ in range(6)]
    urgent = [prompt() for _ in range(2)]
    for _ in range(6):
        gw.pump()
    if with_urgent:
        for p in urgent:
            gw.submit(p, priority=0, sla=20)
    gw.run_until_idle()
    return {r: gw.drain(r)["tokens"] for r in rids}, gw.stats()


@pytest.mark.cuda
def test_small_gateway_card_matches_cpu(cuda):
    cpu, dev = models(cuda)
    runs = {(m.device.type, urgent): preemption_run(m, urgent)
            for m in (cpu, dev) for urgent in (False, True)}
    for urgent in (False, True):
        assert runs["cuda", urgent][0] == runs["cpu", urgent][0]
    assert runs["cuda", True][1]["preemptions"] >= 1
    assert runs["cuda", True][1]["resumes"] == runs["cuda", True][1]["preemptions"]
    assert runs["cuda", False][1]["preemptions"] == 0
    assert runs["cuda", True][0] == runs["cuda", False][0]


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return [json.loads(ln) for ln in r.read().splitlines() if ln.strip()]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        assert r.status == 200
        return r.read()


def http_waves(gw):
    """4 clients in two waves of 2 on 127.0.0.1 (a free port), then
    ``/stats``, ``/metrics`` and ``/healthz``.  Returns (each client's
    lines, stats, metrics text)."""
    srv = GatewayServer(gw, port=0)
    srv.start()
    try:
        results = {}

        def worker(i):
            results[i] = _post(srv.port, {"prompt": "2+3=", "session": f"u{i}"})

        # wave 1 registers the shared prompt's prefix block; its park in
        # the LRU keeps the registration alive, so wave 2 revives it
        for wave in range(2):
            ts = [threading.Thread(target=worker, args=(wave * 2 + j,)) for j in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
                assert not t.is_alive()
        st = json.loads(_get(srv.port, "/stats"))
        metrics = _get(srv.port, "/metrics").decode()
        assert json.loads(_get(srv.port, "/healthz")) == {"ok": True}
    finally:
        srv.shutdown()
    return results, st, metrics


def check_http(results, st, metrics):
    """Every stream ends in ``done`` and carries the tokens it reports;
    the prefix cache was shared; the TTFT histogram is exported."""
    assert len(results) == 4
    for lines in results.values():
        assert lines[-1].get("done") is True
        assert [ln["token"] for ln in lines[:-1]] == lines[-1]["tokens"]
    assert st["completed"] >= 4 and st["prefix_reused_blocks"] > 0
    assert "repro_gateway_ttft_bucket" in metrics


@pytest.mark.cuda
def test_http_on_the_card(cuda):
    _, dev = models(cuda)
    eng = RolloutEngine(dev, EngineConfig(**{**SMALL, "prompt_len": 12, "max_gen_len": 6}))
    check_http(*http_waves(Gateway(eng)))

"""The plain reference of served tokens: one forward pass over a request's
prompt and answer, and the logits that predict each answer token.

The engine samples by Gumbel-max under its ``"request"`` scheme: the
noise of draw j of request rid is ``-log(-log(u))``, u uniform over the
padded vocabulary from a generator on the card seeded by a blake2b digest
of (engine seed, rid, j).  ``gumbel`` draws the same noise from the same
published recipe, so a sampled token can be judged as a greedy one: its
noisy logit's gap below the best noisy logit of the reference.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import torch

from hbench.reference.model import Reference

LOGIT_ROWS = 1024


def request_seed(seed: int, rid: int, draw: int) -> int:
    d = hashlib.blake2b(f"{seed}:{rid}:{draw}".encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") & ((1 << 63) - 1)


def gumbel(seed: int, rid: int, draws: Sequence[int], width: int, device) -> torch.Tensor:
    """(len(draws), width) noise of request ``rid``."""
    g = torch.Generator(device=device)
    tiny = torch.finfo(torch.float32).tiny
    rows = []
    for j in draws:
        g.manual_seed(request_seed(seed, rid, j))
        u = torch.rand((width,), generator=g, device=device, dtype=torch.float32)
        rows.append(-torch.log(-torch.log(u.clamp_min(tiny))))
    return torch.stack(rows)


@torch.no_grad()
def answer_logits(ref: Reference, prompt: List[int], response: List[int], first: int,
                  device) -> torch.Tensor:
    """Logits (len(response) - first, vocab) over the real vocabulary that
    predict response[first:], from one forward pass over the prompt and
    the answer."""
    toks = torch.tensor(list(prompt) + list(response[:-1]), device=device)
    n = toks.shape[0]
    h, _, _ = ref.hidden(toks, torch.arange(n, device=device), [(0, n)])
    rows = h[len(prompt) + first - 1:]
    return torch.cat([ref.logits(rows[a:a + LOGIT_ROWS])[:, :ref.vocab]
                      for a in range(0, rows.shape[0], LOGIT_ROWS)])


def served_readings(ref_lf: torch.Tensor, noise: torch.Tensor, tokens: torch.Tensor,
                    logprobs: torch.Tensor) -> Dict[str, float]:
    """Of served ``tokens`` with the engine's ``logprobs``: the widest gap
    of a served token's noisy logit below the reference's best, and the
    widest distance of its log-probability from the reference's."""
    v = ref_lf.shape[1]
    noisy = ref_lf + noise[:, :v]
    gap = noisy.max(dim=1).values - noisy.gather(1, tokens[:, None])[:, 0]
    lp = torch.log_softmax(ref_lf, dim=1).gather(1, tokens[:, None])[:, 0]
    return {"gap": float(gap.max()), "lp_err": float((lp - logprobs).abs().max())}


def control_readings(ref_lf: torch.Tensor, ctl_lf: torch.Tensor,
                     noise: torch.Tensor) -> Dict[str, float]:
    """The same readings of the tokens that the control puts first, with
    the control's own log-probabilities."""
    v = ref_lf.shape[1]
    tok = (ctl_lf + noise[:, :v]).argmax(dim=1)
    lp = torch.log_softmax(ctl_lf, dim=1).gather(1, tok[:, None])[:, 0]
    return served_readings(ref_lf, noise, tok, lp)

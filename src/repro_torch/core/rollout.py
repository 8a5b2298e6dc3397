"""Interruptible rollout worker (paper §4.1), mirroring the ring-cache,
monolithic-prefill path of ``repro/core/rollout.py``.

A continuous-batching generation engine over ``n_slots`` concurrent
requests:

  * ``admit``           — prefill the prompts of a group of requests into
                          free slots and sample each one's first token.
  * ``step``            — one decode step across every active slot.
  * ``update_weights``  — interrupt all in-flight generations, discard the
                          KV cache computed under the old weights,
                          re-prefill every history under the new ones and
                          continue.  Kept tokens keep the logprobs and
                          version tags recorded when they were sampled, so
                          one trajectory may span several policy versions
                          (Proposition 1).

The model holds the weights: the engine is built from an ``LM`` and a
weight update hands it another ``LM``.  Device state is one ring cache
for all slots, updated in place; host state is per-slot bookkeeping.

Sampling is Gumbel-max: ``argmax(lf / T + g)`` with ``g`` drawn from the
engine's ``torch.Generator`` on its device (greedy when T <= 0), and the
logprob comes from ``log_softmax(lf / T)``.  The ``"step"`` scheme
advances one counter per admission and per decode step; an injectable
``noise(step, shape)`` replaces the generator's draws, so a test can feed
the reference's own Gumbel noise.  A re-prefill draws nothing.

Not in this part of the port (they raise ``NotImplementedError``): the
paged cache, chunked prefill, the fused and speculative decode paths,
multi-turn continuation and per-request RNG streams.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.device import resolve

Noise = Callable[[int, tuple], torch.Tensor]


@dataclass
class Slot:
    active: bool = False
    rid: int = -1
    prompt_id: int = -1
    prompt: List[int] = field(default_factory=list)
    response: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    versions: List[int] = field(default_factory=list)
    behavior_version: int = 0
    pending: int = 0                   # sampled token not yet fed to cache
    answer: object = None
    submit_time: float = 0.0

    @property
    def history_len(self) -> int:
        """Tokens already ingested by the cache (prompt + fed responses)."""
        return len(self.prompt) + len(self.response) - (1 if self.response else 0)


@dataclass
class Finished:
    rid: int
    prompt_id: int
    prompt: List[int]
    response: List[int]
    logprobs: List[float]
    versions: List[int]
    behavior_version: int
    answer: object
    submit_time: float
    truncated: bool
    loss_mask: Optional[List[float]] = None
    turns: int = 1


def _not_ported(cfg: EngineConfig) -> Optional[str]:
    if cfg.cache != "ring":
        return "cache='paged' (the paged engine)"
    if cfg.prefill_chunk:
        return "prefill_chunk > 0 (chunked prefill)"
    if cfg.fused_decode is not None:
        return "fused_decode (the paged fused decode tail)"
    if cfg.spec_decode:
        return "spec_decode (self-speculative decoding)"
    if cfg.continuation is not None:
        return "continuation (multi-turn episodes)"
    if cfg.resolved_rng != "step":
        return "rng='request' (per-request RNG streams)"
    return None


class RolloutEngine:
    """Batched, interruptible generation engine for a dense ``LM``.

    Threading contract: SINGLE-DRIVER.  ``admit``/``step``/
    ``update_weights``/``maybe_apply_pending`` must come from one thread;
    the first driving call binds it and ``release_driver()`` hands it off.
    """

    def __init__(self, model, cfg: Optional[EngineConfig] = None, *, device="cuda",
                 noise: Optional[Noise] = None):
        cfg = EngineConfig() if cfg is None else cfg
        missing = _not_ported(cfg)
        if missing is not None:
            raise NotImplementedError(f"{missing} is a later part of the PyTorch port")
        self.device = resolve(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine on {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.engine_config = cfg
        self.version = cfg.version
        self.n_slots = cfg.n_slots
        self.prompt_len = cfg.prompt_len
        self.max_gen_len = cfg.max_gen_len
        self.max_len = cfg.prompt_len + cfg.max_gen_len
        self.temperature = cfg.temperature
        self.eos_id = cfg.eos_id
        self.dtype = torch.float32 if cfg.dtype is None else cfg.dtype
        self.noise = noise
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        self._step_count = 0

        self.slots = [Slot() for _ in range(cfg.n_slots)]
        self._pending_weights = None
        self._driver_thread: Optional[int] = None

        self.tokens_generated = 0
        self.interruptions = 0
        self.prefill_tokens = 0
        self.reprefill_tokens = 0
        self.decode_dispatches = 0

        self.cache = model.init_cache(cfg.n_slots, self.max_len, self.dtype)
        vocab = torch.arange(self.cfg.padded_vocab, device=self.device)
        self._vocab_ok = vocab < self.cfg.vocab_size

    # ---- sampling ---------------------------------------------------------
    def _masked_logits(self, logits: torch.Tensor) -> torch.Tensor:
        # mask the padded vocab tail
        return torch.where(self._vocab_ok, logits.float(), torch.full_like(logits, -1e30,
                                                                           dtype=torch.float32))

    def _gumbel(self, step: int, shape) -> torch.Tensor:
        if self.noise is not None:
            return self.noise(step, tuple(shape)).to(device=self.device, dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(shape, generator=self._gen, device=self.device, dtype=torch.float32)
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    def _sample(self, logits: torch.Tensor, step: int):
        """(tokens, logprobs) of each row; greedy when the temperature is
        <= 0, else Gumbel-max with the noise of step counter ``step``."""
        lf = self._masked_logits(logits)
        if self.temperature <= 0.0:
            tok = torch.argmax(lf, dim=-1)
        else:
            if self.temperature != 1.0:
                lf = lf / self.temperature
            tok = torch.argmax(lf + self._gumbel(step, (self.n_slots, lf.shape[-1]))
                               [:lf.shape[0]], dim=-1)
        lp = torch.log_softmax(lf, dim=-1)
        lp_tok = torch.gather(lp, -1, tok[:, None])[:, 0]
        return tok, lp_tok

    def _next_step(self) -> int:
        self._step_count += 1
        return self._step_count

    # ---- threading contract -----------------------------------------------
    def _assert_single_driver(self) -> None:
        me = threading.get_ident()
        if self._driver_thread is None:
            self._driver_thread = me
        elif self._driver_thread != me:
            raise RuntimeError(
                f"RolloutEngine is single-driver: bound to thread "
                f"{self._driver_thread}, driven from {me}. Route all engine calls "
                f"through one rollout thread, or call release_driver() for a "
                f"deliberate handoff.")

    def release_driver(self) -> None:
        self._driver_thread = None

    # ---- public API -------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def inflight_tokens(self) -> int:
        return sum(s.history_len for s in self.slots if s.active)

    @property
    def n_active(self) -> int:
        return sum(s.active for s in self.slots)

    @property
    def has_pending_weights(self) -> bool:
        return self._pending_weights is not None

    def stats(self) -> Dict[str, int]:
        return {
            "tokens_generated": self.tokens_generated,
            "interruptions": self.interruptions,
            "prefill_tokens": self.prefill_tokens,
            "reprefill_tokens": self.reprefill_tokens,
            "decode_dispatches": self.decode_dispatches,
        }

    def _prefill_rows(self, histories: Sequence[Sequence[int]]):
        """Prefill right-padded histories into a fresh sub-cache: returns
        (logits (G, Vp), lengths (G,) int32, sub-cache).  Rows are padded
        to the longest history only; an empty one is fed as one pad
        token."""
        g = len(histories)
        lens = np.array([max(len(h), 1) for h in histories], np.int32)
        toks = np.zeros((g, int(lens.max())), np.int64)
        for j, h in enumerate(histories):
            toks[j, :len(h)] = h
        sub = self.model.init_cache(g, self.max_len, self.dtype)
        lens_d = torch.from_numpy(lens).to(self.device)
        logits, sub = self.model.prefill(torch.from_numpy(toks).to(self.device), sub,
                                         length=lens_d)
        return logits, lens, sub

    @torch.no_grad()
    def admit(self, requests: Sequence[Dict], clock: float = 0.0) -> int:
        """requests: dicts with rid, prompt_id, prompt (list[int]), answer.
        Returns the number admitted (bounded by free slots)."""
        self._assert_single_driver()
        free = self.free_slots()
        take = list(requests)[:len(free)]
        if not take:
            return 0
        prompts = [list(r["prompt"])[: self.prompt_len] for r in take]
        logits, lens, sub = self._prefill_rows(prompts)
        tok0, lp0 = self._sample(logits, self._next_step())
        slots = torch.tensor(free[:len(take)], dtype=torch.long, device=self.device)
        self.model.cache_insert(self.cache, sub, slots)
        tok0 = tok0.cpu().numpy()
        lp0 = lp0.cpu().numpy()
        for j, req in enumerate(take):
            s = self.slots[free[j]]
            s.active = True
            s.rid = req["rid"]
            s.prompt_id = req.get("prompt_id", req["rid"])
            s.prompt = prompts[j]
            s.response = [int(tok0[j])]
            s.logprobs = [float(lp0[j])]
            s.versions = [self.version]
            s.behavior_version = self.version
            s.pending = int(tok0[j])
            s.answer = req.get("answer")
            s.submit_time = clock
            self.prefill_tokens += int(lens[j])
        return len(take)

    def step(self) -> List[Finished]:
        """One decode step across all active slots.  Returns finished
        trajectories."""
        self._assert_single_driver()
        act = np.array([s.active for s in self.slots])
        if not act.any():
            return []
        with torch.no_grad():
            pend = torch.tensor([s.pending for s in self.slots], dtype=torch.long,
                                device=self.device)
            # with every slot decoding, no row needs its cache write held back
            active = None if act.all() else torch.from_numpy(act).to(self.device)
            step = self._next_step()
            logits, _ = self.model.decode_step(pend, self.cache, active)
            tok, lp = self._sample(logits, step)
            self.decode_dispatches += 1
            tok = tok.cpu().numpy()
            lp = lp.cpu().numpy()
        finished: List[Finished] = []
        for i, s in enumerate(self.slots):
            if not act[i]:
                continue
            # the pending token is now ingested; the new sample continues it
            t_new = int(tok[i])
            s.response.append(t_new)
            s.logprobs.append(float(lp[i]))
            s.versions.append(self.version)
            s.pending = t_new
            self.tokens_generated += 1
            fin = self._maybe_finish(i, s)
            if fin is not None:
                finished.append(fin)
        return finished

    def _maybe_finish(self, i: int, s: Slot) -> Optional[Finished]:
        done = s.response[-1] == self.eos_id
        trunc = len(s.response) >= self.max_gen_len
        if not (done or trunc):
            return None
        fin = self._make_finished(s, truncated=trunc and not done)
        self.slots[i] = Slot()
        return fin

    def _make_finished(self, s: Slot, truncated: bool) -> Finished:
        return Finished(
            rid=s.rid, prompt_id=s.prompt_id, prompt=s.prompt,
            response=list(s.response), logprobs=list(s.logprobs),
            versions=list(s.versions), behavior_version=s.behavior_version,
            answer=s.answer, submit_time=s.submit_time, truncated=truncated)

    # ---- update_weights (the interruption path) ---------------------------
    def update_weights(self, model, version: int, *, interruptible: bool = True) -> bool:
        """Swap in ``model`` (an ``LM`` holding the new weights) as policy
        ``version``.  Returns True if applied now; False if deferred
        (non-interruptible mode with requests in flight)."""
        self._assert_single_driver()
        if model.device != self.device:
            raise ValueError(f"the new model is on {model.device}, the engine on "
                             f"{self.device}")
        if not interruptible and self.n_active > 0:
            self._pending_weights = (model, version)
            return False
        self.model = model
        self.version = version
        if self.n_active > 0:
            self._reprefill_all()
            self.interruptions += 1
        return True

    def maybe_apply_pending(self) -> bool:
        self._assert_single_driver()
        if self._pending_weights is not None and self.n_active == 0:
            self.model, self.version = self._pending_weights
            self._pending_weights = None
            return True
        return False

    @torch.no_grad()
    def _reprefill_all(self) -> None:
        """Recompute the cache of every in-flight history under the current
        weights.  The history fed back is prompt + response[:-1]; the last
        sampled token stays ``pending`` and the decode loop continues, as
        it would have had the weights never changed.  Nothing is sampled
        and no noise is drawn, so an interruption with the same weights
        leaves generation unchanged (Proposition 1)."""
        ids = [i for i, s in enumerate(self.slots) if s.active]
        # an empty prompt was admitted as one pad token: the re-fed
        # history must include it or every position shifts by one
        hists = [((self.slots[i].prompt or [0]) + self.slots[i].response[:-1])[: self.max_len]
                 for i in ids]
        self.reprefill_tokens += sum(len(h) for h in hists)
        _, _, sub = self._prefill_rows(hists)
        self.model.cache_insert(self.cache, sub,
                                torch.tensor(ids, dtype=torch.long, device=self.device))

"""Interruptible rollout worker (paper §4.1), mirroring
``repro/core/rollout.py``.

A continuous-batching generation engine over ``n_slots`` concurrent
requests:

  * ``admit``           — take a group of requests into free slots: prefill
                          their prompts and sample each one's first token,
                          or, with chunked prefill, queue the prompts for
                          ingestion span by span.
  * ``step``            — one engine step: ingest at most one prefill span,
                          then one decode step across every slot whose
                          history is in the cache.
  * ``update_weights``  — interrupt all in-flight generations, discard the
                          KV cache computed under the old weights,
                          recompute every history under the new ones and
                          continue.  Kept tokens keep the logprobs and
                          version tags recorded when they were sampled, so
                          one trajectory may span several policy versions
                          (Proposition 1).

The engine owns its ``LM``: it is built from one, which it serves from
then on, and a weight update copies another ``LM``'s weights into it
(casting where the engine serves in another dtype), so a trainer that
goes on updating its own tensors in place never reaches the tokens the
engine samples under the version it was handed.  Host state is per-slot
bookkeeping; device state is one cache for all slots, updated in place:

  * ``cache="ring"``  — a ring buffer of ``max_len`` rows per slot.
  * ``cache="paged"`` — a global pool of fixed-size KV blocks and a block
    table per slot (``core.batching.BlockAllocator``).  Full prompt blocks
    are shared read-only between slots with the same prompt prefix (GRPO
    groups sample one prompt several times); with ``evict="lru"`` a
    released prefix block parks, revivable, until the pool needs it.  A
    re-prefill after ``update_weights`` rewrites each physical block at
    most once, skipping blocks already current under the new version.

Two prefill disciplines (``prefill_chunk``, paged cache only here):

  * ``0``   — admission prefills the whole group at once and
    ``update_weights`` re-prefills every history before any slot decodes.
  * ``> 0`` — prompts and post-interrupt histories are split into spans of
    at most ``prefill_chunk`` tokens (``core.batching.plan_prefill_chunks``)
    and ``step`` ingests one span, strictly FIFO across slots, before it
    decodes the slots whose histories are complete.

Sampling is Gumbel-max: ``argmax(lf / T + g)`` (greedy when T <= 0), and
the logprob comes from ``log_softmax(lf / T)``.  Two RNG schemes:

  * ``"step"``    — one draw of ``g`` for the whole batch from the
    engine's ``torch.Generator``, advanced once per admission and per
    decode step; trajectories depend on batch timing.
  * ``"request"`` — row j draws from a stream keyed by (seed, rid_j,
    draw_j), where draw_j is the index of the token in its response, so
    trajectories do not depend on admission timing, interrupts or
    chunking.  Chunked prefill requires it.

An injectable ``noise`` replaces the generator's draws, so that a test
can feed the reference's own Gumbel noise: ``noise(step, shape)`` under
``"step"``, ``noise(rid, draw, shape)`` under ``"request"``.  A re-prefill
draws nothing.

The fused decode tail (``fused_decode="fused"``) runs each layer's paged
attention and output projection as one kernel; ``"split"`` counts the
decode and the sampling as two dispatches, as the reference's
measurement baseline does, and computes what the default path computes.

Not in this part of the port (they raise ``NotImplementedError``):
chunked prefill on the ring cache, the paged cache for a model with
recurrent blocks, speculative decoding and multi-turn continuation;
preempt/resume is not ported either.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.batching import BlockAllocator, plan_prefill_chunks, prefix_block_hashes
from repro_torch.core.config import EngineConfig
from repro_torch.device import resolve

Noise = Callable[..., torch.Tensor]


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
    # chunked-prefill bookkeeping: the history being ingested, the
    # watermark (tokens of it already in the cache), the spans still to
    # feed, and the pool blocks this ingest pass has written so far
    ingest_tokens: List[int] = field(default_factory=list)
    ingested: int = 0
    chunk_plan: List[Tuple[int, int]] = field(default_factory=list)
    written_blocks: Set[int] = field(default_factory=set)
    reingest: bool = False             # redo after an interrupt, not fresh

    @property
    def history_len(self) -> int:
        """Tokens already ingested by the cache (prompt + fed responses)."""
        return len(self.prompt) + len(self.response) - (1 if self.response else 0)

    @property
    def ingesting(self) -> bool:
        """True while the slot's history is not yet fully in the cache
        (the slot holds its resources but does not decode)."""
        return self.active and self.ingested < len(self.ingest_tokens)


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


def _not_ported(cfg: EngineConfig, model_cfg) -> Optional[str]:
    if cfg.cache == "paged" and "rec" in model_cfg.block_pattern:
        return "cache='paged' with recurrent blocks (paged cache for recurrent blocks)"
    if cfg.spec_decode:
        return "spec_decode (self-speculative decoding)"
    if cfg.continuation is not None:
        return "continuation (multi-turn episodes)"
    if cfg.prefill_chunk and cfg.cache == "ring":
        return "prefill_chunk > 0 with cache='ring' (ring-cache chunked prefill)"
    return None


def request_seed(seed: int, rid: int, draw: int) -> int:
    """The generator seed of draw ``draw`` of request ``rid``: a digest,
    so that streams of different (seed, rid, draw) are unrelated."""
    d = hashlib.blake2b(f"{seed}:{rid}:{draw}".encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") & ((1 << 63) - 1)


class RolloutEngine:
    """Batched, interruptible generation engine for an ``LM`` (dense, or
    the RG-LRU hybrid on the ring cache).

    Threading contract: SINGLE-DRIVER.  ``admit``/``step``/
    ``update_weights``/``maybe_apply_pending`` must come from one thread;
    the first driving call binds it and ``release_driver()`` hands it off.
    """

    def __init__(self, model, cfg: Optional[EngineConfig] = None, *, device="cuda",
                 noise: Optional[Noise] = None):
        cfg = EngineConfig() if cfg is None else cfg
        missing = _not_ported(cfg, model.cfg)
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
        self.seed = cfg.seed
        self.dtype = torch.float32 if cfg.dtype is None else cfg.dtype
        self.noise = noise
        self.rng_mode = cfg.resolved_rng
        self.prefill_chunk = int(cfg.prefill_chunk)
        self.fused_decode = cfg.fused_decode
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        self._step_count = 0

        self.slots = [Slot() for _ in range(cfg.n_slots)]
        self._pending_weights = None
        self._driver_thread: Optional[int] = None
        self._ingest_queue: List[int] = []

        self.tokens_generated = 0
        self.interruptions = 0
        self.prefill_tokens = 0
        self.reprefill_tokens = 0
        self.prefix_reused_blocks = 0
        self.deferred = 0                  # requests bounced on pool pressure
        self.deferred_last = 0             # ... by the most recent admit()
        self.decode_steps_during_prefill = 0
        self.decode_dispatches = 0

        self.cache_mode = cfg.cache
        if cfg.cache == "paged":
            self.block_size = cfg.block_size
            self.n_entries = -(-self.max_len // cfg.block_size)
            self.n_blocks = cfg.n_blocks or cfg.n_slots * self.n_entries
            self.allocator = BlockAllocator(self.n_blocks, cfg.block_size, evict=cfg.evict)
            self.tables = np.full((cfg.n_slots, self.n_entries), -1, np.int32)
            self._tables_dev: Optional[torch.Tensor] = None   # device copy, refreshed on change
            self.cache = model.init_paged_cache(cfg.n_slots, self.n_blocks, cfg.block_size,
                                                self.dtype)
        else:
            self.cache = model.init_cache(cfg.n_slots, self.max_len, self.dtype)
        vocab = torch.arange(self.cfg.padded_vocab, device=self.device)
        self._vocab_ok = vocab < self.cfg.vocab_size

    # ---- sampling ---------------------------------------------------------
    def _masked_logits(self, logits: torch.Tensor) -> torch.Tensor:
        # mask the padded vocab tail
        return torch.where(self._vocab_ok, logits.float(), torch.full_like(logits, -1e30,
                                                                           dtype=torch.float32))

    def _gumbel_of(self, gen_seed: Optional[int], noise_args: tuple, shape) -> torch.Tensor:
        if self.noise is not None:
            return self.noise(*noise_args, tuple(shape)).to(device=self.device,
                                                            dtype=torch.float32)
        if gen_seed is not None:
            self._gen.manual_seed(gen_seed)
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(shape, generator=self._gen, device=self.device, dtype=torch.float32)
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    def _gumbel(self, step: int, rids: Sequence[int], draws: Sequence[int], rows: int,
                vocab: int) -> torch.Tensor:
        """Gumbel noise for ``rows`` rows: under ``"step"`` one draw of
        (n_slots, vocab) for step counter ``step``; under ``"request"``
        row j's own draw ``draws[j]`` of request ``rids[j]``."""
        if self.rng_mode == "step":
            return self._gumbel_of(None, (step,), (self.n_slots, vocab))[:rows]
        return torch.stack([self._gumbel_of(request_seed(self.seed, r, d), (r, d), (vocab,))
                            for r, d in zip(rids, draws)])

    def _sample(self, logits: torch.Tensor, step: int, rids: Sequence[int],
                draws: Sequence[int]):
        """(tokens, logprobs) of each row; greedy when the temperature is
        <= 0, else Gumbel-max with the noise of the engine's RNG scheme."""
        lf = self._masked_logits(logits)
        if self.temperature <= 0.0:
            tok = torch.argmax(lf, dim=-1)
        else:
            if self.temperature != 1.0:
                lf = lf / self.temperature
            tok = torch.argmax(lf + self._gumbel(step, rids, draws, lf.shape[0], lf.shape[-1]),
                               dim=-1)
        lp = torch.log_softmax(lf, dim=-1)
        lp_tok = torch.gather(lp, -1, tok[:, None])[:, 0]
        return tok.cpu().numpy(), lp_tok.cpu().numpy()

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

    def blocks_in_use(self) -> int:
        return self.allocator.n_live if self.cache_mode == "paged" else 0

    def ingest_backlog_tokens(self) -> int:
        """Prefill tokens still queued for chunked ingestion."""
        return sum(len(s.ingest_tokens) - s.ingested for s in self.slots if s.ingesting)

    def stats(self) -> Dict[str, int]:
        paged = self.cache_mode == "paged"
        return {
            "tokens_generated": self.tokens_generated,
            "interruptions": self.interruptions,
            "prefill_tokens": self.prefill_tokens,
            "reprefill_tokens": self.reprefill_tokens,
            "prefix_reused_blocks": self.prefix_reused_blocks,
            "deferred": self.deferred,
            "deferred_last": self.deferred_last,
            "evictions": self.allocator.evictions if paged else 0,
            "revivals": self.allocator.revivals if paged else 0,
            "decode_steps_during_prefill": self.decode_steps_during_prefill,
            "ingest_backlog_tokens": self.ingest_backlog_tokens(),
            "decode_dispatches": self.decode_dispatches,
            "blocks_in_use": self.blocks_in_use(),
        }

    # ---- admission ----------------------------------------------------------
    @staticmethod
    def _pad_rows(rows: Sequence[Sequence[int]], fill: int = 0) -> np.ndarray:
        """Right-pad rows to the longest (at least 1 wide)."""
        out = np.full((len(rows), max([len(r) for r in rows] + [1])), fill, np.int64)
        for j, r in enumerate(rows):
            out[j, :len(r)] = r
        return out

    def _prefill_rows(self, histories: Sequence[Sequence[int]]):
        """Prefill right-padded histories into a fresh ring sub-cache:
        returns (logits (G, Vp), lengths (G,) int32, sub-cache).  Rows
        are padded to the longest history only; an empty one is fed as
        one pad token."""
        lens = np.array([max(len(h), 1) for h in histories], np.int32)
        toks = self._pad_rows(histories)
        sub = self.model.init_cache(len(histories), self.max_len, self.dtype)
        logits, sub = self.model.prefill(torch.from_numpy(toks).to(self.device), sub,
                                         length=torch.from_numpy(lens).to(self.device))
        return logits, lens, sub

    @torch.no_grad()
    def admit(self, requests: Sequence[Dict], clock: float = 0.0) -> int:
        """requests: dicts with rid, prompt_id, prompt (list[int]), answer.
        Returns the number admitted: bounded by free slots and, paged, by
        free pool blocks (shared prefix blocks do not count).  Requests
        bounced on pool pressure are counted in ``deferred_last``."""
        self._assert_single_driver()
        self.deferred_last = 0
        if self.prefill_chunk:
            return self._admit_chunked(requests, clock)
        if self.cache_mode == "paged":
            return self._admit_paged(requests, clock)
        free = self.free_slots()
        take = list(requests)[:len(free)]
        if not take:
            return 0
        prompts = [list(r["prompt"])[: self.prompt_len] for r in take]
        logits, lens, sub = self._prefill_rows(prompts)
        tok0, lp0 = self._sample(logits, self._next_step(), [r["rid"] for r in take],
                                 [0] * len(take))
        slots = torch.tensor(free[:len(take)], dtype=torch.long, device=self.device)
        self.model.cache_insert(self.cache, sub, slots)
        self._activate_slots(take, free, lens, tok0, lp0, clock)
        return len(take)

    def _activate_slots(self, take, free, lens, tok0, lp0, clock) -> None:
        for j, req in enumerate(take):
            s = self.slots[free[j]]
            s.active = True
            s.rid = req["rid"]
            s.prompt_id = req.get("prompt_id", req["rid"])
            s.prompt = list(req["prompt"])[: self.prompt_len]
            s.response = [int(tok0[j])]
            s.logprobs = [float(lp0[j])]
            s.versions = [self.version]
            s.behavior_version = self.version
            s.pending = int(tok0[j])
            s.answer = req.get("answer")
            s.submit_time = clock
            self.prefill_tokens += int(lens[j])

    # ---- paged admission (prefix block reuse) -----------------------------
    def blocks_needed(self, prompt: Sequence[int]) -> int:
        """Worst-case pool blocks a request occupies (before sharing):
        table entries for the prompt plus every token the decode loop can
        feed back (the last sampled token stays pending, never written)."""
        lp = max(min(len(prompt), self.prompt_len), 1)
        return -(-(lp + self.max_gen_len - 1) // self.block_size)

    def _plan_blocks(self, prompt: Sequence[int],
                     fresh_unwritten: bool) -> Optional[Tuple[List[int], int]]:
        """Reserve the block-table row of one request: prefix-shared
        leading blocks plus a freshly allocated tail.  Returns (row,
        n_reused), or None when the pool cannot cover it (the caller
        defers the request).  ``fresh_unwritten`` tags every fresh block
        version -1 ("no contents yet") so that the chunked destination
        rule writes it on first touch."""
        bs = self.block_size
        need = self.blocks_needed(prompt)
        n_full = len(prompt) // bs
        try:
            prefix, reused = self.allocator.plan_prefix(self.version, prompt)
        except MemoryError:
            return None
        if self.allocator.n_available < need - n_full:
            # roll back without leaking blocks or registrations: a fresh
            # block registered by plan_prefix was never written, so its
            # registration goes before it is released (else LRU mode would
            # park it as a prefix holder with garbage contents)
            for j, b in enumerate(prefix):
                if j >= reused:
                    self.allocator.invalidate(b)
                self.allocator.release(b)
            return None
        tag = -1 if fresh_unwritten else self.version
        if fresh_unwritten:
            for b in prefix[reused:]:
                self.allocator.set_version(b, -1)
        tail = [self.allocator.alloc(tag) for _ in range(need - n_full)]
        self.prefix_reused_blocks += reused
        return prefix + tail, reused

    def _bind_table(self, i: int, row: List[int]) -> None:
        self.tables[i, :] = -1
        self.tables[i, :len(row)] = row
        self._tables_dev = None

    def _admit_paged(self, requests: Sequence[Dict], clock: float) -> int:
        free = self.free_slots()
        bs = self.block_size
        take: List[Dict] = []
        prompts, dests = [], []
        for req in requests:
            if len(take) >= len(free):
                break
            p = list(req["prompt"])[: self.prompt_len]
            plan = self._plan_blocks(p, fresh_unwritten=False)
            if plan is None:
                break
            row, reused = plan
            self._bind_table(free[len(take)], row)
            # write every position the prefill ingests: an empty prompt
            # still feeds one pad token, and a fresh block may hold a
            # released request's stale contents; shared blocks are filled
            dests.append([row[pos // bs] if pos // bs >= reused else -1
                          for pos in range(max(len(p), 1))])
            prompts.append(p)
            take.append(req)
        self._count_deferred(requests, free, len(take))
        if not take:
            return 0
        lens = np.array([max(len(p), 1) for p in prompts], np.int32)
        dev = self.device
        logits, self.cache = self.model.prefill_paged(
            torch.from_numpy(self._pad_rows(prompts)).to(dev), self.cache,
            torch.from_numpy(self._pad_rows(dests, fill=-1)).to(dev, torch.int32),
            torch.tensor(free[:len(take)], device=dev), length=torch.from_numpy(lens).to(dev))
        tok0, lp0 = self._sample(logits, self._next_step(), [r["rid"] for r in take],
                                 [0] * len(take))
        self._activate_slots(take, free, lens, tok0, lp0, clock)
        return len(take)

    def _count_deferred(self, requests, free, n_taken: int) -> None:
        """The admission loop stops early only on block exhaustion, so a
        request that had a free slot but was not taken was deferred for
        pool blocks."""
        self.deferred_last = max(0, min(len(requests), len(free)) - n_taken)
        self.deferred += self.deferred_last

    def _release_slot_blocks(self, i: int) -> None:
        for b in self.tables[i]:
            if b >= 0:
                self.allocator.release(int(b))
        self.tables[i, :] = -1
        self._tables_dev = None

    # ---- chunked admission and ingestion ------------------------------------
    def _admit_chunked(self, requests: Sequence[Dict], clock: float) -> int:
        """Occupy the slot, reserve its blocks and queue the prompt for
        ingestion span by span; nothing is prefilled here.  The span that
        completes the prompt samples the first token."""
        free = self.free_slots()
        take: List[Dict] = []
        reset_ids: List[int] = []
        for req in requests:
            if len(take) >= len(free):
                break
            i = free[len(take)]
            p = list(req["prompt"])[: self.prompt_len]
            plan = self._plan_blocks(p, fresh_unwritten=True)
            if plan is None:
                break
            self._bind_table(i, plan[0])
            s = self.slots[i] = Slot()
            s.active = True
            s.rid = req["rid"]
            s.prompt_id = req.get("prompt_id", req["rid"])
            s.prompt = p
            s.behavior_version = self.version
            s.answer = req.get("answer")
            s.submit_time = clock
            self._queue_ingest(i, p or [0])
            reset_ids.append(i)
            take.append(req)
        self._count_deferred(requests, free, len(take))
        if reset_ids:
            self._reset_rows(reset_ids)
        return len(take)

    def _queue_ingest(self, i: int, history: List[int], reingest: bool = False) -> None:
        s = self.slots[i]
        s.ingest_tokens = history
        s.ingested = 0
        s.written_blocks = set()
        s.reingest = reingest
        s.chunk_plan = plan_prefill_chunks(len(history), self.prefill_chunk,
                                           align=self.block_size)
        self._ingest_queue.append(i)

    def _reset_rows(self, slot_ids: List[int]) -> None:
        self.model.reset_slot_rows(self.cache, torch.tensor(slot_ids, device=self.device))

    def _ingest_one_chunk(self) -> None:
        """Feed the head-of-queue slot's next span.  Strictly FIFO across
        slots: a slot's ingestion completes before the next slot's starts,
        which is what makes prefix-shared pool blocks safe to skip (a
        "current" block a later slot sees was fully written by an earlier,
        completed one)."""
        i = self._ingest_queue[0]
        s = self.slots[i]
        begin, end = s.chunk_plan.pop(0)
        c = self.prefill_chunk
        bs = self.block_size
        span = s.ingest_tokens[begin:end]
        toks = np.zeros((1, c), np.int64)
        toks[0, :len(span)] = span
        dest = np.full((1, c), -1, np.int32)
        written = 0
        for k, pos in enumerate(range(begin, end)):
            e = pos // bs
            b = int(self.tables[i, e])
            if self.allocator.version_of(b) == self.version and b not in s.written_blocks:
                continue                   # fully written by a completed slot
            dest[0, k] = b
            written += 1
            s.written_blocks.add(b)
            # tag the block current only once its contents are complete: an
            # interrupt between two sub-block spans must see it stale
            if end >= min((e + 1) * bs, len(s.ingest_tokens)):
                self.allocator.set_version(b, self.version)
        completes = not s.chunk_plan and not s.response
        dev = self.device
        logits, self.cache = self.model.prefill_chunk_paged(
            torch.from_numpy(toks).to(dev), self.cache,
            torch.from_numpy(self.tables[i:i + 1]).to(dev), torch.from_numpy(dest).to(dev),
            torch.tensor([i], device=dev), torch.tensor([begin], dtype=torch.int32, device=dev),
            torch.tensor([len(span)], dtype=torch.int32, device=dev))
        s.ingested = end
        # a slot interrupted mid-admission re-ingests with no token sampled
        # yet: its redone spans are re-prefill work, not more prompt prefill
        if s.reingest:
            self.reprefill_tokens += written
        else:
            self.prefill_tokens += len(span)
        if s.ingesting:
            return
        self._ingest_queue.pop(0)
        s.written_blocks = set()
        # (re-)publish the prompt's full blocks under the current version
        # so that later admissions share them
        for e, h in enumerate(prefix_block_hashes(self.version, s.prompt, bs)):
            self.allocator.register(h, int(self.tables[i, e]))
        if completes:
            # the completing span's sample is the request's first token
            tok0, lp0 = self._sample(logits, 0, [max(s.rid, 0)], [0])
            s.response = [int(tok0[0])]
            s.logprobs = [float(lp0[0])]
            s.versions = [self.version]
            s.behavior_version = self.version
            s.pending = s.response[0]

    # ---- the engine step ----------------------------------------------------
    def step(self) -> List[Finished]:
        """One engine step: ingest at most one prefill span, then one
        decode step across every slot whose history is fully in the
        cache.  Returns finished trajectories.  Without chunked prefill
        no span is ever queued, so this is one decode step across all
        active slots."""
        self._assert_single_driver()
        if self._ingest_queue:
            self._ingest_one_chunk()
            # forward progress: while no slot can decode there is nothing
            # to overlap with, so ingest until the head slot can resume
            # (else a weight update every step would starve decoding)
            while self._ingest_queue and not any(s.active and not s.ingesting
                                                 for s in self.slots):
                self._ingest_one_chunk()
        act = np.array([s.active and not s.ingesting for s in self.slots])
        if not act.any():
            return []
        if self._ingest_queue:
            self.decode_steps_during_prefill += 1
        step = self._next_step() if self.rng_mode == "step" else 0
        with torch.no_grad():
            pend = torch.tensor([s.pending for s in self.slots], dtype=torch.long,
                                device=self.device)
            # with every slot decoding, no row needs its cache write held back
            active = None if act.all() else torch.from_numpy(act).to(self.device)
            if self.cache_mode == "paged":
                # tables change only at admission, finish and interrupt
                if self._tables_dev is None:
                    self._tables_dev = torch.from_numpy(self.tables).to(self.device)
                logits, _ = self.model.decode_step_paged(
                    pend, self.cache, self._tables_dev, active,
                    fused_tail=self.fused_decode == "fused")
            else:
                logits, _ = self.model.decode_step(pend, self.cache, active)
            # "split" counts decode and sampling as two dispatches, as the
            # reference's measurement baseline does
            self.decode_dispatches += 2 if self.fused_decode == "split" else 1
            tok, lp = self._sample(logits, step, [max(s.rid, 0) for s in self.slots],
                                   [len(s.response) for s in self.slots])
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
        if self.cache_mode == "paged":
            self._release_slot_blocks(i)
        self.slots[i] = Slot()
        return fin

    def _make_finished(self, s: Slot, truncated: bool) -> Finished:
        return Finished(
            rid=s.rid, prompt_id=s.prompt_id, prompt=s.prompt,
            response=list(s.response), logprobs=list(s.logprobs),
            versions=list(s.versions), behavior_version=s.behavior_version,
            answer=s.answer, submit_time=s.submit_time, truncated=truncated)

    # ---- update_weights (the interruption path) ---------------------------
    def _weights_of(self, src) -> List[torch.Tensor]:
        """``src``'s parameters, checked against the engine model's."""
        mine = list(self.model.parameters())
        theirs = [p.detach() for p in src.parameters()]
        if len(mine) != len(theirs) or any(a.shape != b.shape for a, b in zip(mine, theirs)):
            raise ValueError("the new weights do not fit the engine's model")
        return theirs

    @torch.no_grad()
    def _load(self, weights: Sequence[torch.Tensor]) -> None:
        """Copy ``weights`` into the engine's model, casting to its dtypes."""
        for a, b in zip(self.model.parameters(), weights):
            a.copy_(b)

    def update_weights(self, model, version: int, *, interruptible: bool = True) -> bool:
        """Apply the weights of ``model`` (an ``LM`` of the engine's
        config) as policy ``version``: they are copied into the engine's
        own ``LM``, now, or, when deferred, snapshotted now and copied
        when applied; the engine keeps no reference to ``model``.  Returns
        True if applied now; False if deferred (non-interruptible mode
        with requests in flight)."""
        self._assert_single_driver()
        if model.device != self.device:
            raise ValueError(f"the new model is on {model.device}, the engine on "
                             f"{self.device}")
        # the engine's own model as the source: the weights it holds already
        changed = model is not self.model
        weights = self._weights_of(model) if changed else None
        if not interruptible and self.n_active > 0:
            # a snapshot of call time, in the engine's dtypes
            snap = None if weights is None else [
                w.to(a.dtype, copy=True) for a, w in zip(self.model.parameters(), weights)]
            self._pending_weights = (snap, version)
            return False
        same_version = version == self.version
        if weights is not None:
            self._load(weights)
        self.version = version
        if self.cache_mode == "paged" and (changed or not same_version):
            # stale prefix hashes must never match again: the version seed
            # handles a bump, clearing handles new weights under a reused
            # version number
            self.allocator.clear_prefix_map()
        if self.n_active > 0:
            # new weights under a reused version: the version tags cannot
            # tell stale blocks, so every block is rewritten
            force = changed and same_version
            if self.prefill_chunk:
                self._requeue_all_histories(force)
            elif self.cache_mode == "paged":
                self._reprefill_paged(force)
            else:
                self._reprefill_all()
            self.interruptions += 1
        return True

    def maybe_apply_pending(self) -> bool:
        self._assert_single_driver()
        if self._pending_weights is not None and self.n_active == 0:
            weights, self.version = self._pending_weights
            if weights is not None:
                self._load(weights)
            self._pending_weights = None
            if self.cache_mode == "paged":
                self.allocator.clear_prefix_map()
            return True
        return False

    def _history(self, s: Slot) -> List[int]:
        """The history a re-prefill feeds back: prompt + response[:-1]
        (the last sampled token stays pending).  An empty prompt was
        admitted as one pad token, which the history keeps, or every
        position would shift by one."""
        return ((s.prompt or [0]) + s.response[:-1])[: self.max_len]

    def _requeue_all_histories(self, force: bool) -> None:
        """Chunked interruption: every in-flight history re-enters the
        ingest queue at watermark 0, and each slot decodes again as soon
        as its own history is back.  A slot interrupted mid-ingest
        restarts its history.  With ``force`` every live block of the
        interrupted slots is tagged stale, so the destination rule
        rewrites it."""
        if force:
            for i, s in enumerate(self.slots):
                if s.active:
                    for b in self.tables[i]:
                        if b >= 0:
                            self.allocator.set_version(int(b), -1)
        self._ingest_queue = []
        reset_ids = []
        for i, s in enumerate(self.slots):
            if s.active:
                self._queue_ingest(i, self._history(s), reingest=True)
                reset_ids.append(i)
        self._reset_rows(reset_ids)

    @torch.no_grad()
    def _reprefill_all(self) -> None:
        """Recompute the ring cache of every in-flight history under the
        current weights; the decode loop then continues from each slot's
        pending token, as it would have had the weights never changed.
        Nothing is sampled and no noise is drawn, so an interruption with
        the same weights leaves generation unchanged (Proposition 1)."""
        ids = [i for i, s in enumerate(self.slots) if s.active]
        hists = [self._history(self.slots[i]) for i in ids]
        self.reprefill_tokens += sum(len(h) for h in hists)
        _, _, sub = self._prefill_rows(hists)
        self.model.cache_insert(self.cache, sub,
                                torch.tensor(ids, dtype=torch.long, device=self.device))

    @torch.no_grad()
    def _reprefill_paged(self, force: bool = False) -> None:
        """Paged counterpart of ``_reprefill_all``: the forward pass runs
        over every in-flight history, but a pool block is written only if
        its contents are stale (version tag != the new version, or
        ``force``) and only by ONE of the slots that share it, so a
        prompt shared by a group is recomputed once, not once per slot."""
        bs = self.block_size
        ids, hists, dests = [], [], []
        written = set()
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            hist = self._history(s)
            dest = [-1] * len(hist)
            for e in range(-(-len(hist) // bs)):
                b = int(self.tables[i, e])
                if b < 0 or b in written:
                    continue               # another sharer rewrites it
                written.add(b)
                if not force and self.allocator.version_of(b) == self.version:
                    continue               # contents already current
                lo, hi = e * bs, min((e + 1) * bs, len(hist))
                dest[lo:hi] = [b] * (hi - lo)
                self.reprefill_tokens += hi - lo
                self.allocator.set_version(b, self.version)
            # re-publish the full prompt blocks under the new version
            for e, h in enumerate(prefix_block_hashes(self.version, s.prompt, bs)):
                self.allocator.register(h, int(self.tables[i, e]))
            ids.append(i)
            hists.append(hist)
            dests.append(dest)
        dev = self.device
        lens = np.array([max(len(h), 1) for h in hists], np.int32)
        self.model.prefill_paged(
            torch.from_numpy(self._pad_rows(hists)).to(dev), self.cache,
            torch.from_numpy(self._pad_rows(dests, fill=-1)).to(dev, torch.int32),
            torch.tensor(ids, device=dev), length=torch.from_numpy(lens).to(dev))

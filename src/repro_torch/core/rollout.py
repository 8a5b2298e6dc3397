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
  * ``feed_weight_message`` — apply a streamed publication one message at
                          a time behind a version fence: the weights flip
                          (through ``update_weights``) only when a stream
                          completes; a torn stream is discarded.
  * ``update_weights``  — interrupt all in-flight generations, discard the
                          KV cache computed under the old weights,
                          recompute every history under the new ones and
                          continue.  Kept tokens keep the logprobs and
                          version tags recorded when they were sampled, so
                          one trajectory may span several policy versions
                          (Proposition 1).
  * ``preempt_slot`` / ``admit_resume`` — park one slot's request on the
                          host and re-admit it later through the ingest
                          queue, bit-exact under the ``"request"`` RNG
                          (the serving gateway's SLA lever).

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

Two prefill disciplines (``prefill_chunk``):

  * ``0``   — admission prefills the whole group at once and
    ``update_weights`` re-prefills every history before any slot decodes.
  * ``> 0`` — prompts and post-interrupt histories are split into spans of
    at most ``prefill_chunk`` tokens (``core.batching.plan_prefill_chunks``)
    and ``step`` ingests one span, strictly FIFO across slots, before it
    decodes the slots whose histories are complete.  On the ring cache a
    span attends to the slot's cache entries before its watermark and to
    itself (``LM.prefill_chunk``); on the paged cache it is written into
    the pool first and read back through the block table.

A multi-turn ``continuation`` hook ``fn(finished, turn, budget)`` may
answer a finished turn with environment tokens: they are appended to the
response (logprob 0, masked out of the loss) and only they are ingested,
at the slot's watermark, before decoding continues (chunked prefill
only).

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

Self-speculative decoding (``spec_decode=k``, greedy only) makes a round
of two engine steps: a draft step runs k - 1 decode steps of the first
``spec_draft_units`` units from each slot's pending token; the next step
scores the pending token and the k - 1 drafts in one full-model chunk
pass (verify), accepts the leading drafts the full model agrees with
(cut at EOS and at the response room), and runs the span again with its
length cut to that count (commit).  Drafts and verify leave no state
behind, although the caches are updated in place: the draft saves the
few rows it overwrites and puts them back (``LM.draft_rows``), the verify
drops its copy of the ring rows (and its recurrent rows; its pool writes
lie at and past the watermark, which the commit rewrites), and only the
commit's state stays.  An ``update_weights`` (or a preemption) between
the two steps discards the drafted round.

A mixture-of-experts model's capacity couples the rows of each call:
a token's expert output depends on every token of its group, padding
and dummy rows included.  So for such a model (``ref_rows``) the
monolithic prefills run over the reference's block, not over the taken
rows alone: admission over every slot's row (the requests first, dummy
rows of one pad token after) at ``prompt_len``, a re-prefill over every
slot at its own row at ``max_len``; only the real rows' state is kept.
Chunked spans (one row of ``prefill_chunk``) and decode steps (every
slot) already match.  A speculative round's verify and commit run over
every slot too, a non-member as the reference's dummy row (length 0,
reading the last slot's ring rows, writing nothing), and the draft and
the verify put back the pool entries they wrote: a row that sees no key
averages every entry its table gathers (``ops`` ``mean_empty_rows``).

With the tracer enabled (``obs.trace``) the engine records the spans
``engine.step`` and ``engine.ingest`` and the instants ``engine.admit``,
``engine.finished`` and ``engine.weight_flip``; they time the host, and
each step ends in a host read of its sampled tokens.  Disabled, they
record nothing and read no clock.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.batching import (BlockAllocator, plan_prefill_chunks, prefix_block_hashes,
                                       span_dest_blocks)
from repro_torch.core.config import EngineConfig
from repro_torch.core.weights import StreamDecoder, device_leaf, host_weights, tree_rebuild
from repro_torch.device import resolve
from repro_torch.obs import trace

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
    cont: bool = False                 # multi-turn continuation ingest
    # multi-turn bookkeeping: completed environment turns, and the
    # [start, end) spans of environment tokens in ``response`` (masked out
    # of the loss in training)
    turns: int = 0
    env_spans: List[Tuple[int, int]] = field(default_factory=list)

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


def request_seed(seed: int, rid: int, draw: int) -> int:
    """The generator seed of draw ``draw`` of request ``rid``: a digest,
    so that streams of different (seed, rid, draw) are unrelated."""
    d = hashlib.blake2b(f"{seed}:{rid}:{draw}".encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") & ((1 << 63) - 1)


class RolloutEngine:
    """Batched, interruptible generation engine for an ``LM`` (dense, or
    the RG-LRU hybrid).

    Threading contract: SINGLE-DRIVER.  ``admit``/``step``/
    ``update_weights``/``maybe_apply_pending`` must come from one thread;
    the first driving call binds it and ``release_driver()`` hands it off.
    """

    def __init__(self, model, cfg: Optional[EngineConfig] = None, *, device="cuda",
                 noise: Optional[Noise] = None):
        cfg = EngineConfig() if cfg is None else cfg
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
        # fn(finished, turn, budget) -> environment tokens to append, or None
        self.continuation = cfg.continuation
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
        self.preemptions = 0               # slots preempted by the gateway
        self.resumes = 0                   # preempted requests re-admitted
        self.decode_steps_during_prefill = 0
        self.continuations = 0             # multi-turn episode extensions
        self.continuation_tokens = 0       # appended-span tokens ingested
        # decode fast-path counters
        self.decode_dispatches = 0
        self.drafted_tokens = 0            # truncated-model draft proposals
        self.accepted_tokens = 0           # tokens committed by spec rounds
        self.accepted_draft_tokens = 0     # drafts the full model agreed with
        self.spec_rounds = 0
        self.spec_member_rounds = 0        # per-slot round participations
        self.spec_decode = int(cfg.spec_decode)
        # the MoE's capacity couples the rows of a call: its prefills get
        # the reference's token set (every slot a row, the full width)
        self.ref_rows = bool(model.cfg.is_moe)
        if self.spec_decode:
            n_units = model.n_units
            du = (max(1, n_units - 1) if cfg.spec_draft_units is None
                  else int(cfg.spec_draft_units))
            if not 1 <= du <= n_units:
                raise ValueError(f"spec_draft_units must be in [1, {n_units}], got {du}")
            self._spec_draft_units = du
        # one speculative round in flight: set by the draft step, consumed
        # by verify+commit, discarded by update_weights
        self._draft: Optional[Dict] = None
        # streaming pickup (DESIGN.md §Version fence)
        self._stream_decoder = None
        self._staged_dev: Dict[str, torch.Tensor] = {}
        self._in_stream_flip = False
        self._stream_need_full = False
        self.weight_streams_completed = 0
        self.weight_streams_torn = 0

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
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "evictions": self.allocator.evictions if paged else 0,
            "revivals": self.allocator.revivals if paged else 0,
            "decode_steps_during_prefill": self.decode_steps_during_prefill,
            "ingest_backlog_tokens": self.ingest_backlog_tokens(),
            "continuations": self.continuations,
            "continuation_tokens": self.continuation_tokens,
            "decode_dispatches": self.decode_dispatches,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "spec_rounds": self.spec_rounds,
            "draft_acceptance_rate": self.draft_acceptance_rate,
            "accepted_tokens_per_step": self.accepted_tokens_per_step,
            "blocks_in_use": self.blocks_in_use(),
            **self.stream_stats(),
        }

    @property
    def draft_acceptance_rate(self) -> float:
        """Fraction of the draft proposals that the full model's verify
        pass agreed with."""
        return self.accepted_draft_tokens / max(1, self.drafted_tokens)

    @property
    def accepted_tokens_per_step(self) -> float:
        """Committed tokens per full-model pass over a slot: a slot's
        round costs two (verify and commit; the truncated draft is not
        counted) and commits its accepted count.  Speculation wins when
        this exceeds 1, what the plain engine commits a pass."""
        return self.accepted_tokens / max(1, 2 * self.spec_member_rounds)

    @property
    def spec_pending(self) -> bool:
        """True between a round's draft step and its verify+commit: an
        ``update_weights`` then discards the drafts."""
        return self._draft is not None

    # ---- admission ----------------------------------------------------------
    @staticmethod
    def _pad_rows(rows: Sequence[Sequence[int]], fill: int = 0) -> np.ndarray:
        """Right-pad rows to the longest (at least 1 wide)."""
        out = np.full((len(rows), max([len(r) for r in rows] + [1])), fill, np.int64)
        for j, r in enumerate(rows):
            out[j, :len(r)] = r
        return out

    def _ref_block(self, rows: Sequence[Sequence[int]], places: Sequence[int], width: int,
                   fill: int = 0) -> np.ndarray:
        """The reference's (n_slots, width) block: row ``places[j]`` holds
        ``rows[j]``, right-padded with ``fill``; the other rows (dummy
        rows, of length 1) hold ``fill`` only."""
        out = np.full((self.n_slots, width), fill, np.int64)
        for j, r in zip(places, rows):
            out[j, :len(r)] = r
        return out

    def _block_lens(self, histories, places) -> np.ndarray:
        lens = np.ones((self.n_slots,), np.int32)
        lens[list(places)] = [max(len(h), 1) for h in histories]
        return lens

    def _prefill_rows(self, histories: Sequence[Sequence[int]], places: Sequence[int],
                      width: int):
        """Prefill right-padded histories into a fresh ring sub-cache:
        returns (logits (G, Vp), lengths (G,) int32, sub-cache) of the G
        histories.  Rows are padded to the longest history only; an empty
        one is fed as one pad token.  With ``ref_rows`` the prefill runs
        over the reference's block instead, history j in row ``places[j]``
        of ``n_slots`` rows ``width`` wide, and keeps only those rows."""
        lens = np.array([max(len(h), 1) for h in histories], np.int32)
        dev = self.device
        if not self.ref_rows:
            toks = self._pad_rows(histories)
            sub = self.model.init_cache(len(histories), self.max_len, self.dtype)
            logits, sub = self.model.prefill(torch.from_numpy(toks).to(dev), sub,
                                             length=torch.from_numpy(lens).to(dev))
            return logits, lens, sub
        toks = self._ref_block(histories, places, width)
        sub = self.model.init_cache(self.n_slots, self.max_len, self.dtype)
        logits, sub = self.model.prefill(
            torch.from_numpy(toks).to(dev), sub,
            length=torch.from_numpy(self._block_lens(histories, places)).to(dev))
        pick = torch.tensor(list(places), dtype=torch.long, device=dev)
        return logits[pick], lens, self.model.cache_gather(sub, pick)

    @torch.no_grad()
    def admit(self, requests: Sequence[Dict], clock: float = 0.0) -> int:
        """requests: dicts with rid, prompt_id, prompt (list[int]), answer.
        Returns the number admitted: bounded by free slots and, paged, by
        free pool blocks (shared prefix blocks do not count).  Requests
        bounced on pool pressure are counted in ``deferred_last``."""
        self._assert_single_driver()
        if trace.get().enabled and requests:
            trace.instant("engine.admit", n=len(requests), rids=[r["rid"] for r in requests])
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
        logits, lens, sub = self._prefill_rows(prompts, range(len(take)), self.prompt_len)
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
        logits = self._prefill_paged_rows(prompts, dests, range(len(take)), free[:len(take)],
                                          self.prompt_len)
        tok0, lp0 = self._sample(logits, self._next_step(), [r["rid"] for r in take],
                                 [0] * len(take))
        self._activate_slots(take, free, lens, tok0, lp0, clock)
        return len(take)

    def _prefill_paged_rows(self, histories, dests, places, slot_ids, width: int):
        """Prefill histories into the pool (``dests`` their blocks, -1 =
        not written) for slots ``slot_ids``; returns their logits (G, Vp).
        With ``ref_rows`` the prefill runs over the reference's block, as
        ``_prefill_rows``, its dummy rows writing nothing."""
        dev = self.device
        lens = [max(len(h), 1) for h in histories]
        if not self.ref_rows:
            return self.model.prefill_paged(
                torch.from_numpy(self._pad_rows(histories)).to(dev), self.cache,
                torch.from_numpy(self._pad_rows(dests, fill=-1)).to(dev, torch.int32),
                torch.tensor(list(slot_ids), device=dev),
                length=torch.tensor(lens, dtype=torch.int32, device=dev))[0]
        places = list(places)
        sids = np.zeros((self.n_slots,), np.int64)
        sids[places] = list(slot_ids)
        pick = torch.tensor(places, dtype=torch.long, device=dev)
        logits, _ = self.model.prefill_paged(
            torch.from_numpy(self._ref_block(histories, places, width)).to(dev), self.cache,
            torch.from_numpy(self._ref_block(dests, places, width, fill=-1)).to(dev, torch.int32),
            torch.from_numpy(sids).to(dev),
            length=torch.from_numpy(self._block_lens(histories, places)).to(dev), rows=pick)
        return logits[pick]

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
        """Occupy the slot (paged: reserve its blocks) and queue the prompt
        for ingestion span by span; nothing is prefilled here.  The span
        that completes the prompt samples the first token."""
        free = self.free_slots()
        take: List[Dict] = []
        reset_ids: List[int] = []
        for req in requests:
            if len(take) >= len(free):
                break
            i = free[len(take)]
            p = list(req["prompt"])[: self.prompt_len]
            if self.cache_mode == "paged":
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
        if self.cache_mode == "paged":
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
        s.cont = False                     # a whole (re-)ingest, not a turn
        s.chunk_plan = plan_prefill_chunks(len(history), self.prefill_chunk,
                                           align=self._align)
        self._ingest_queue.append(i)

    @property
    def _align(self) -> int:
        """Span boundaries: pool blocks (paged) or none (ring)."""
        return self.block_size if self.cache_mode == "paged" else 1

    def _reset_rows(self, slot_ids: List[int]) -> None:
        self.model.reset_slot_rows(self.cache, torch.tensor(slot_ids, device=self.device))

    # ---- preempt / resume (the serving gateway's SLA lever) -----------------
    def preempt_slot(self, i: int) -> Dict:
        """Evict active slot ``i`` mid-generation and return a host-side
        snapshot that ``admit_resume`` re-admits later.  Like a weight
        update's interrupt, but for one slot, and the trajectory parks on
        the host instead of re-entering the queue at once.  The resumed
        trajectory equals the uninterrupted one because every draw of the
        ``"request"`` RNG is a function of (seed, rid, draw index) only
        (needs ``prefill_chunk > 0``)."""
        self._assert_single_driver()
        if not self.prefill_chunk:
            raise ValueError("preempt/resume requires prefill_chunk > 0: resumption replays "
                             "the history through the chunked ingest queue")
        s = self.slots[i]
        if not s.active:
            raise ValueError(f"slot {i} is not active")
        snap = {
            "rid": s.rid, "prompt_id": s.prompt_id, "prompt": list(s.prompt),
            "response": list(s.response), "logprobs": list(s.logprobs),
            "versions": list(s.versions), "behavior_version": s.behavior_version,
            "answer": s.answer, "submit_time": s.submit_time, "turns": s.turns,
            "env_spans": list(s.env_spans),
        }
        if i in self._ingest_queue:
            self._ingest_queue.remove(i)
        if self.cache_mode == "paged":
            self._release_slot_blocks(i)
        self.slots[i] = Slot()
        self.preemptions += 1
        # a drafted round counts this slot as a member: drop the round, the
        # next step drafts anew for the slots still active
        self._draft = None
        return snap

    def admit_resume(self, snap: Dict, clock: float = 0.0) -> Optional[int]:
        """Re-admit a ``preempt_slot`` snapshot.  Returns the slot, or None
        when no slot or, paged, no pool room is free (the caller keeps the
        snapshot and retries).  The history (prompt + response[:-1])
        re-enters the FIFO ingest queue; prefix-shared pool blocks still
        current are skipped and evicted ones recomputed, and decoding
        continues from the snapshot's pending token at draw index
        len(response)."""
        self._assert_single_driver()
        if not self.prefill_chunk:
            raise ValueError("admit_resume requires prefill_chunk > 0")
        free = self.free_slots()
        if not free:
            return None
        i = free[0]
        p = list(snap["prompt"])[: self.prompt_len]
        if self.cache_mode == "paged":
            plan = self._plan_blocks(p, fresh_unwritten=True)
            if plan is None:
                self.deferred += 1         # pool pressure: retry later
                return None
            self._bind_table(i, plan[0])
        s = self.slots[i] = Slot()
        s.active = True
        s.rid = snap["rid"]
        s.prompt_id = snap["prompt_id"]
        s.prompt = p
        s.answer = snap["answer"]
        s.submit_time = snap["submit_time"]
        s.behavior_version = snap["behavior_version"]
        s.turns = snap["turns"]
        s.env_spans = [tuple(x) for x in snap["env_spans"]]
        resp = list(snap["response"])
        if resp:
            s.response = resp
            s.logprobs = list(snap["logprobs"])
            s.versions = list(snap["versions"])
            s.pending = int(resp[-1])
        # an empty response resumes as a fresh admission: the span that
        # completes the prompt samples draw index 0, as the first time
        self._queue_ingest(i, self._history(s), reingest=True)
        self._reset_rows([i])
        self.resumes += 1
        return i

    # ---- ingestion ----------------------------------------------------------
    def _ingest_one_chunk(self) -> None:
        """Feed the head-of-queue slot's next span.  Strictly FIFO across
        slots: a slot's ingestion completes before the next slot's starts,
        which is what makes prefix-shared pool blocks safe to skip (a
        "current" block a later slot sees was fully written by an earlier,
        completed one)."""
        tr = trace.get()
        if not tr.enabled:
            return self._ingest_one_chunk_impl()
        i = self._ingest_queue[0]
        s = self.slots[i]
        begin, end = s.chunk_plan[0]
        with tr.span("engine.ingest", slot=i, rid=s.rid, begin=begin, end=end):
            return self._ingest_one_chunk_impl()

    def _chunk_dest(self, s: Slot, i: int, begin: int, end: int) -> Tuple[np.ndarray, int]:
        """Paged: the pool block each position of span [begin, end) is
        written to (-1 = skip: fully written by a completed slot), padded
        to ``prefill_chunk``, and how many positions are written."""
        bs = self.block_size
        dest = np.full((1, self.prefill_chunk), -1, np.int32)
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
        return dest, written

    def _ingest_one_chunk_impl(self) -> None:
        i = self._ingest_queue[0]
        s = self.slots[i]
        begin, end = s.chunk_plan.pop(0)
        span = s.ingest_tokens[begin:end]
        toks = np.zeros((1, self.prefill_chunk), np.int64)
        toks[0, :len(span)] = span
        completes = not s.chunk_plan and not s.response
        dev = self.device
        args = (torch.tensor([i], device=dev), torch.tensor([begin], dtype=torch.int32, device=dev),
                torch.tensor([len(span)], dtype=torch.int32, device=dev))
        if self.cache_mode == "paged":
            dest, written = self._chunk_dest(s, i, begin, end)
            logits, self.cache = self.model.prefill_chunk_paged(
                torch.from_numpy(toks).to(dev), self.cache,
                torch.from_numpy(self.tables[i:i + 1]).to(dev), torch.from_numpy(dest).to(dev),
                *args)
        else:
            written = len(span)
            logits, self.cache = self.model.prefill_chunk(torch.from_numpy(toks).to(dev),
                                                          self.cache, *args)
        s.ingested = end
        # accounting keys on the kind of ingest: a slot interrupted
        # mid-admission re-ingests with no token sampled yet, and its redone
        # spans are re-prefill work, not more prompt prefill; a multi-turn
        # continuation ingests only its appended tokens
        if s.cont:
            self.continuation_tokens += written
        elif s.reingest:
            self.reprefill_tokens += written
        else:
            self.prefill_tokens += len(span)
        if s.ingesting:
            return
        self._ingest_queue.pop(0)
        s.written_blocks = set()
        s.cont = False
        if self.cache_mode == "paged":
            # (re-)publish the prompt's full blocks under the current
            # version so that later admissions share them
            for e, h in enumerate(prefix_block_hashes(self.version, s.prompt,
                                                      self.block_size)):
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
        tr = trace.get()
        if not tr.enabled:
            return self._step_impl()
        with tr.span("engine.step", version=self.version, n_active=self.n_active):
            fin = self._step_impl()
        if fin:
            tr.instant("engine.finished", n=len(fin), rids=[f.rid for f in fin])
        return fin

    def _step_impl(self) -> List[Finished]:
        self._assert_single_driver()
        if self._ingest_queue:
            self._ingest_one_chunk()
            # forward progress: while no slot can decode there is nothing
            # to overlap with, so ingest until the head slot can resume
            # (else a weight update every step would starve decoding)
            while self._ingest_queue and not any(s.active and not s.ingesting
                                                 for s in self.slots):
                self._ingest_one_chunk()
        if self.spec_decode:
            return self._step_spec()
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

    # ---- speculative decoding -----------------------------------------------
    def _step_spec(self) -> List[Finished]:
        """One speculative engine step: the draft step of a round, or its
        verify+commit when a round is drafted (``_spec_verify_commit``).
        The draft runs k - 1 truncated-model decode steps from every
        member slot's pending token, greedily, and parks the proposals in
        ``_draft``; the rows the steps overwrite are saved first and put
        back after (``LM.draft_rows``), so the draft leaves the cache as
        it found it."""
        if self._draft is not None:
            return self._spec_verify_commit()
        act = np.array([s.active and not s.ingesting for s in self.slots])
        if not act.any():
            return []
        if self._ingest_queue:
            self.decode_steps_during_prefill += 1
        k, du = self.spec_decode, self._spec_draft_units
        pend = np.array([s.pending for s in self.slots], np.int64)
        t0 = np.array([s.history_len if s.active else 0 for s in self.slots], np.int32)
        with torch.no_grad():
            active = None if act.all() else torch.from_numpy(act).to(self.device)
            if self.cache_mode == "paged" and self._tables_dev is None:
                self._tables_dev = torch.from_numpy(self.tables).to(self.device)
            saved = self.model.draft_rows(self.cache, k - 1, du,
                                          self._tables_dev if self.cache_mode == "paged" else None)
            tok = torch.from_numpy(pend).to(self.device)
            drafts = []
            for _ in range(k - 1):
                if self.cache_mode == "paged":
                    logits, _ = self.model.decode_step_paged(tok, self.cache, self._tables_dev,
                                                             active, draft_units=du)
                else:
                    logits, _ = self.model.decode_step(tok, self.cache, active, draft_units=du)
                tok = torch.argmax(self._masked_logits(logits), dim=-1)
                drafts.append(tok)
            self.model.restore_rows(self.cache, saved)
            drafts = torch.stack(drafts).cpu().numpy()          # (k - 1, n_slots)
        self.decode_dispatches += 1
        self.drafted_tokens += (k - 1) * int(act.sum())
        self._draft = {"members": act, "pend": pend, "t0": t0, "drafts": drafts}
        return []

    def _span_dest(self, rows: np.ndarray, start: np.ndarray, length: np.ndarray) -> np.ndarray:
        """Pool blocks of the spans [start, start + length) of slots
        ``rows``: every decode position was allocated at admission
        (``blocks_needed``), so this reads the block tables; -1 past the
        span and past the table."""
        return span_dest_blocks(self.tables[rows], start, length, self.block_size,
                                self.spec_decode)

    def _spec_chunk(self, rows, toks, start, length, *, verify: bool):
        """The span pass of verify (every position's logits, no state
        kept) or commit (the state of ``length`` tokens a row kept) over
        slots ``rows``.  With ``ref_rows`` a row of length 0 is a dummy
        row, as the reference's: it reads the last slot's ring rows (the
        reference clamps its out-of-range id) and writes nothing."""
        dev = self.device
        ids, real = rows, None
        if self.ref_rows:
            ids = np.where(length > 0, rows, self.n_slots - 1)
            real = torch.from_numpy(np.nonzero(length > 0)[0]).to(dev)
        args = (torch.from_numpy(toks).to(dev), self.cache)
        tail = (torch.from_numpy(ids).to(dev), torch.from_numpy(start).to(dev),
                torch.from_numpy(length).to(dev))
        if self.cache_mode == "paged":
            dest = torch.from_numpy(self._span_dest(rows, start, length)).to(dev)
            args += (self._tables_dev[torch.from_numpy(rows).to(dev)], dest)
            fn = self.model.prefill_chunk_paged
        else:
            fn = self.model.prefill_chunk
        logits, _ = fn(*args, *tail, all_logits=verify, commit=not verify, rows=real)
        return logits

    @torch.no_grad()
    def _spec_verify_commit(self) -> List[Finished]:
        """Score the pending token and the drafts in one full-model pass
        (verify: nothing of it stays), accept the leading drafts the full
        model agrees with, cut at the first EOS and at the response room,
        and run the span again with each row's length cut to its accepted
        count (commit), so the cache advances exactly that far."""
        k = self.spec_decode
        round_, self._draft = self._draft, None
        members = round_["members"]
        rows = np.nonzero(members)[0]
        # the pass's rows: the members, or with ref_rows every slot, the
        # others of length 0 (the reference's dummy rows)
        span = np.arange(self.n_slots) if self.ref_rows else rows
        toks = np.concatenate([round_["pend"][span, None], round_["drafts"][:, span].T], axis=1)
        start = np.where(members, round_["t0"], 0)[span].astype(np.int32)
        at = {int(i): j for j, i in enumerate(span)}           # slot -> row of the pass
        if self.cache_mode == "paged" and self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self.tables).to(self.device)
        logits = self._spec_chunk(span, toks, start, np.where(members, k, 0)[span].astype(np.int32),
                                  verify=True)
        lf = self._masked_logits(logits)                       # (G, k, Vp)
        gtok = torch.argmax(lf, dim=-1)
        glp = torch.gather(torch.log_softmax(lf, dim=-1), -1, gtok[..., None])[..., 0]
        gtok, glp = gtok.cpu().numpy(), glp.cpu().numpy()
        self.decode_dispatches += 1
        acc = np.zeros(len(span), np.int32)
        for i in rows:
            j = at[int(i)]
            a = 1
            while a < k and toks[j, a] == gtok[j, a - 1]:
                a += 1
            a = min(a, self.max_gen_len - len(self.slots[i].response))
            eos = np.nonzero(gtok[j, :a] == self.eos_id)[0]
            acc[j] = eos[0] + 1 if len(eos) else a
        self._spec_chunk(span, toks, start, acc, verify=False)
        self.decode_dispatches += 1
        self.spec_rounds += 1
        self.spec_member_rounds += len(rows)
        finished: List[Finished] = []
        for i in rows:
            j = at[int(i)]
            s, a = self.slots[i], int(acc[j])
            s.response += [int(x) for x in gtok[j, :a]]
            s.logprobs += [float(x) for x in glp[j, :a]]
            s.versions += [self.version] * a
            s.pending = s.response[-1]
            self.tokens_generated += a
            self.accepted_tokens += a
            self.accepted_draft_tokens += a - 1
            fin = self._maybe_finish(i, s)
            if fin is not None:
                finished.append(fin)
        return finished

    def _maybe_finish(self, i: int, s: Slot) -> Optional[Finished]:
        """End of a trajectory: the EOS / truncation check, the multi-turn
        continuation hook, block release and slot reset.  Returns the
        Finished record, or None (still running, or continued)."""
        done = s.response[-1] == self.eos_id
        trunc = len(s.response) >= self.max_gen_len
        if not (done or trunc):
            return None
        fin = self._make_finished(s, truncated=trunc and not done)
        extra = None
        if self.continuation is not None and not trunc:
            # the environment may answer back: its message and at least one
            # sampled token must fit the response room left
            budget = self.max_gen_len - len(s.response) - 1
            if budget > 0:
                extra = self.continuation(fin, s.turns, budget)
            if extra is not None and not 0 < len(extra) <= budget:
                extra = None
        if extra is not None:
            self._continue_slot(i, [int(t) for t in extra])
            return None                    # the slot stays active, turn k + 1
        if self.cache_mode == "paged":
            self._release_slot_blocks(i)
        self.slots[i] = Slot()
        return fin

    def _make_finished(self, s: Slot, truncated: bool) -> Finished:
        mask = None
        if s.env_spans:
            mask = [1.0] * len(s.response)
            for lo, hi in s.env_spans:
                mask[lo:hi] = [0.0] * (hi - lo)
        return Finished(
            rid=s.rid, prompt_id=s.prompt_id, prompt=s.prompt,
            response=list(s.response), logprobs=list(s.logprobs),
            versions=list(s.versions), behavior_version=s.behavior_version,
            answer=s.answer, submit_time=s.submit_time, truncated=truncated,
            loss_mask=mask, turns=s.turns + 1)

    def _continue_slot(self, i: int, extra: List[int]) -> None:
        """Multi-turn continuation: append the environment's tokens to the
        slot's response (logprob 0, an env span masked out of the loss)
        and re-enter the FIFO ingest queue at the slot's watermark.  The
        cache rows or pool blocks of the history are reused; only the
        appended span is ingested.  The last env token becomes the pending
        token the next decode step feeds."""
        s = self.slots[i]
        w = len(s.prompt or [0]) + len(s.response) - 1     # ingested history
        lo = len(s.response)
        s.response += extra
        s.logprobs += [0.0] * len(extra)
        s.versions += [self.version] * len(extra)
        s.env_spans.append((lo, len(s.response)))
        s.pending = s.response[-1]
        s.turns += 1
        s.ingest_tokens = self._history(s)
        s.ingested = w
        s.written_blocks = set()
        s.reingest = False
        s.cont = True
        s.chunk_plan = plan_prefill_chunks(len(s.ingest_tokens), self.prefill_chunk,
                                           align=self._align, start=w)
        if self.cache_mode == "paged" and w % self.block_size:
            # the boundary block is only partly filled (its tag may read
            # current from the admission ingest): let the span fill its
            # appended positions; full history blocks stay skipped
            s.written_blocks.add(int(self.tables[i, w // self.block_size]))
        self._ingest_queue.append(i)
        self.continuations += 1

    # ---- streaming weight pickup (DESIGN.md §Version fence) ---------------
    def feed_weight_message(self, msg, *, interruptible: bool = True) -> bool:
        """Version-fenced application of one publication-stream message
        (DESIGN.md §Version fence).

        While a stream is in flight the engine keeps decoding under the
        LAST COMPLETE version: chunks assemble host-side in the stream
        decoder and each completed leaf is copied to the device at once
        (``on_leaf`` → ``_stage_stream_leaf``), under decode of the
        earlier ones.  Slots only interrupt when the stream COMPLETES —
        the flip is one ordinary ``update_weights`` call over the staged
        leaves and the engine's own tensors for the leaves the stream did
        not change.  A torn stream (missing chunks, superseding begin —
        DESIGN.md §Torn-stream recovery) discards the staging and the
        engine keeps serving the last complete version.

        Returns True when ``msg`` completed a stream (the flip was
        applied, or queued via the non-interruptible pending path)."""
        self._assert_single_driver()
        if self._stream_decoder is None:
            self._stream_decoder = StreamDecoder(host_weights(self.model), self.version,
                                                 on_leaf=self._stage_stream_leaf)
        dec = self._stream_decoder
        torn_before = dec.torn
        out = dec.feed(msg)
        if dec.torn > torn_before:
            self.weight_streams_torn += 1
            self._staged_dev = {}
        if dec.need_full:
            dec.need_full = False
            self._stream_need_full = True
            self._staged_dev = {}
        if out is None:
            return False
        version, _host_tree = out
        staged, self._staged_dev = self._staged_dev, {}
        weights = tree_rebuild(self.model.state_dict(), staged)
        self._in_stream_flip = True
        try:
            self.update_weights(weights, version, interruptible=interruptible)
        finally:
            self._in_stream_flip = False
        self.weight_streams_completed += 1
        return True

    def _stage_stream_leaf(self, path: str, arr) -> None:
        """Decoder ``on_leaf`` hook: copy one completed leaf to the device
        NOW, in the engine's dtype (bf16 from its ``uint16`` bits).  The
        staged tensor reaches the model only at the stream-complete flip."""
        self._staged_dev[path] = device_leaf(arr, self.model.state_dict()[path])

    def consume_stream_need_full(self) -> bool:
        """True once after a delta stream arrived whose base version this
        engine does not hold (DESIGN.md §Torn-stream recovery): the
        caller should request a full retransmit from the publisher."""
        flag = self._stream_need_full
        self._stream_need_full = False
        return flag

    def _invalidate_stream_decoder(self) -> None:
        """A full update replaced the weights outside the stream path: the
        decoder's host base no longer matches, so drop it (recreated
        lazily from the new weights) along with anything staged.  An open
        stream dies torn — last-complete semantics."""
        if self._stream_decoder is not None:
            if self._stream_decoder.mid_stream:
                self.weight_streams_torn += 1
            self._stream_decoder = None
            self._staged_dev = {}

    def stream_stats(self) -> Dict[str, int]:
        """Streaming-pickup counters (DESIGN.md §Streaming weight
        publication)."""
        dec = self._stream_decoder
        base = dec.stats() if dec is not None else {
            "streams_completed": 0, "streams_torn": 0,
            "stream_chunks_received": 0, "stream_orphans": 0,
            "stream_base_mismatches": 0, "stream_active": 0}
        base["streams_completed"] = self.weight_streams_completed
        base["streams_torn"] = self.weight_streams_torn
        return base

    # ---- update_weights (the interruption path) ---------------------------
    def _weights_of(self, src) -> List[torch.Tensor]:
        """``src``'s weights in the order of the engine model's state dict,
        checked against it: ``src`` is an ``LM`` or a dict by state-dict
        name (``ParameterStore.latest()``)."""
        mine = self.model.state_dict()
        if isinstance(src, dict):
            ok = set(src) == set(mine) and all(
                tuple(src[n].shape) == tuple(t.shape) for n, t in mine.items())
            theirs = [src[n] for n in mine] if ok else []
        else:
            theirs = [t.detach() for t in src.state_dict().values()]
            ok = len(mine) == len(theirs) and all(
                a.shape == b.shape for a, b in zip(mine.values(), theirs))
        if not ok:
            raise ValueError("the new weights do not fit the engine's model")
        dev = {t.device for t in theirs}
        if dev != {self.device}:
            raise ValueError(f"the new weights are on {sorted(map(str, dev))}, the engine "
                             f"on {self.device}")
        return theirs

    @torch.no_grad()
    def _load(self, weights: Sequence[torch.Tensor]) -> None:
        """Copy ``weights`` into the engine's model, casting to its dtypes
        (a tensor that is already the engine's own is left as it is)."""
        for a, b in zip(self.model.state_dict().values(), weights):
            if b.data_ptr() != a.data_ptr():
                a.copy_(b)

    def update_weights(self, weights, version: int, *, interruptible: bool = True) -> bool:
        """Apply ``weights`` as policy ``version``: an ``LM`` of the
        engine's config, or its weights as a dict by state-dict name (what
        ``ParameterStore.latest()`` returns).  They are copied into the
        engine's own ``LM``, now, or, when deferred, snapshotted now and
        copied when applied; the engine keeps no reference to them.
        Returns True if applied now; False if deferred (non-interruptible
        mode with requests in flight).  An update from outside the stream
        path tears an open weight stream."""
        self._assert_single_driver()
        trace.instant("engine.weight_flip", version=version, n_active=self.n_active,
                      interruptible=interruptible, stream=self._in_stream_flip)
        if not self._in_stream_flip:
            self._invalidate_stream_decoder()
        # the engine's own model as the source: the weights it holds already
        changed = weights is not self.model
        weights = self._weights_of(weights) if changed else None
        if not interruptible and self.n_active > 0:
            # a snapshot of call time, in the engine's dtypes
            snap = None if weights is None else [
                w.to(a.dtype, copy=True)
                for a, w in zip(self.model.state_dict().values(), weights)]
            self._pending_weights = (snap, version)
            return False
        # a round caught between draft and verify dies with the old weights:
        # its drafts must not be verified or committed under the new ones
        self._draft = None
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
        if self.cache_mode == "paged" and force:
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
        _, _, sub = self._prefill_rows(hists, ids, self.max_len)
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
        self._prefill_paged_rows(hists, dests, ids, ids, self.max_len)

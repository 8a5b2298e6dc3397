"""Consolidated rollout-engine configuration (DESIGN.md §Serving
gateway).

``EngineConfig`` is the rollout engine's whole configuration surface
as ONE frozen dataclass:

  * **capacity**       — ``n_slots``, ``prompt_len``, ``max_gen_len``
  * **sampling**       — ``temperature``, ``eos_id``, ``seed``,
                         ``rng`` (per-step vs per-request streams)
  * **cache**          — ``cache`` (ring/paged), ``block_size``,
                         ``n_blocks``, ``evict`` (DESIGN.md §Prefix
                         eviction policy)
  * **prefill**        — ``prefill_chunk`` (DESIGN.md §Chunked prefill)
  * **fast paths**     — ``fused_decode``, ``spec_decode``,
                         ``spec_draft_units``
  * **multi-turn**     — ``continuation`` (the env answer-back hook)

Every *pure-config* invariant lives in ``__post_init__`` — the checks
that need only the config itself (speculation is greedy-only, the fused
tail and speculation are mutually exclusive fast paths, chunked prefill
forces per-request RNG, eviction is a paged-pool policy).  Checks that
depend on the MODEL (does it implement a paged cache, how many stacked
units can a draft pass truncate to) stay in ``RolloutEngine.__init__``,
which is where the model is first seen.

A copy of ``repro.core.config.EngineConfig`` with the same fields and
the same validation.  ``dtype`` is a ``torch.dtype`` here.  The PyTorch
``RolloutEngine`` implements everything the reference's does, for dense
and RG-LRU hybrid models alike: both caches (ring and paged, with prefix
sharing and ``evict="lru"``), monolithic and chunked prefill, both RNG
schemes, the fused decode tail, self-speculative decoding and
``continuation``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.data import tokenizer


@dataclass(frozen=True)
class EngineConfig:
    """One rollout engine's full configuration surface.

    Frozen: an engine's config is immutable for its lifetime (weight
    version is runtime state, not configuration — it moves through
    ``update_weights``).  ``dataclasses.replace`` derives variants.
    """

    # capacity
    n_slots: int = 8
    prompt_len: int = 24
    max_gen_len: int = 16
    # sampling
    temperature: float = 1.0
    eos_id: int = tokenizer.EOS
    seed: int = 0
    rng: str = "auto"                  # "auto" | "step" | "request"
    # cache organization (DESIGN.md §Paged KV-cache pool)
    cache: str = "ring"                # "ring" | "paged"
    block_size: int = 16
    n_blocks: Optional[int] = None     # None = worst-case sizing
    evict: str = "off"                 # "off" | "lru" (§Prefix eviction policy)
    # prefill discipline (DESIGN.md §Chunked prefill)
    prefill_chunk: int = 0
    # decode fast paths (DESIGN.md §Fused decode tail,
    # §Self-speculative decoding)
    fused_decode: Optional[str] = None  # None | "fused" | "split"
    spec_decode: int = 0
    spec_draft_units: Optional[int] = None
    # runtime plumbing that historically rode the constructor
    version: int = 0
    dtype: Any = None                  # None = engine default (torch.float32)
    continuation: Any = None           # multi-turn env hook (callable)

    def __post_init__(self):
        if self.n_slots <= 0 or self.prompt_len <= 0 or self.max_gen_len <= 0:
            raise ValueError("n_slots, prompt_len and max_gen_len must be "
                             "positive")
        if self.cache not in ("ring", "paged"):
            raise ValueError(f"cache must be 'ring' or 'paged', "
                             f"got {self.cache!r}")
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        if self.rng not in ("auto", "step", "request"):
            raise ValueError(f"rng must be 'auto', 'step' or 'request', "
                             f"got {self.rng!r}")
        if self.evict not in ("off", "lru"):
            raise ValueError(f"evict must be 'off' or 'lru', "
                             f"got {self.evict!r}")
        if self.evict != "off" and self.cache != "paged":
            raise ValueError("evict='lru' is a paged-pool policy: prefix "
                             "blocks only exist with cache='paged' "
                             "(DESIGN.md §Prefix eviction policy)")
        if self.fused_decode not in (None, "fused", "split"):
            raise ValueError(f"fused_decode must be None, 'fused' or "
                             f"'split', got {self.fused_decode!r}")
        if self.fused_decode is not None and self.cache != "paged":
            raise ValueError("fused_decode requires cache='paged': the "
                             "fused tail is a paged-pool kernel "
                             "(DESIGN.md §Fused decode tail)")
        if self.spec_decode:
            if self.spec_decode < 2:
                raise ValueError("spec_decode is the total tokens per "
                                 "round (1 committed + drafts); needs >= 2")
            if self.temperature > 0.0:
                raise ValueError(
                    "spec_decode requires temperature <= 0 (greedy): "
                    "acceptance compares draft tokens against the full "
                    "model's argmax, which is only exact without sampling "
                    "(DESIGN.md §Self-speculative decoding)")
            if self.fused_decode is not None:
                raise ValueError("spec_decode and fused_decode are "
                                 "separate decode fast paths; enable one")
        if self.prefill_chunk and self.rng == "step":
            raise ValueError("prefill_chunk > 0 requires rng='request': "
                             "the step-counter scheme cannot reproduce "
                             "monolithic trajectories under chunking")
        if self.continuation is not None and not self.prefill_chunk:
            raise ValueError(
                "continuation (multi-turn environments) requires "
                "prefill_chunk > 0: appended env tokens are ingested "
                "through the FIFO span queue "
                "(DESIGN.md §Environments and reward service)")

    @property
    def resolved_rng(self) -> str:
        """The RNG discipline after resolving ``"auto"``: chunked
        engines need per-request streams, monolithic ones default to the
        legacy per-step scheme (DESIGN.md §Chunked prefill)."""
        if self.rng == "auto":
            return "request" if self.prefill_chunk else "step"
        return self.rng

    @property
    def max_len(self) -> int:
        return self.prompt_len + self.max_gen_len

    def replace(self, **changes) -> "EngineConfig":
        """Derive a variant config (re-validated by ``__post_init__``)."""
        return dataclasses.replace(self, **changes)

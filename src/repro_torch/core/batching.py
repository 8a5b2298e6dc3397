"""Dynamic micro-batch allocation (paper Algorithm 1) and padding-free
sequence packing, the trainer's host side; the paged KV-cache block
allocator and the chunked-prefill planners, the paged rollout engine's.

A copy of ``repro/core/batching.py`` (``dynamic_batching``,
``static_batching``, ``PackedBatch``, ``pack_sequences``,
``plan_prefill_chunks``, ``span_dest_blocks``, ``prefix_block_hashes``
and ``BlockAllocator``): that module needs no JAX, but importing it runs
the JAX package's ``__init__``, so the port keeps its own.  The logic is
the reference's line for line; its asserts are checks that raise.
``tests/test_torch_batching.py`` and ``tests/test_torch_trainer.py`` hold
the two copies to the same micro-batches, packings, plans, hashes and
allocator states.

Algorithm 1: sort sequences by length descending; each sequence goes to
a new micro-batch if fewer than k_min exist or none can fit it, otherwise
to the fitting micro-batch with the fewest sequences.  Packing turns each
micro-batch into fixed-shape (rows, pack_len) arrays with segment ids
(-1 = padding) and within-segment positions.

``BlockAllocator`` is a free list over a fixed pool of KV blocks with
per-block refcounts, so that prompt-prefix blocks can be shared
read-only across slots (GRPO groups sample the same prompt n times),
per-block weight-version tags, so that an ``update_weights`` interrupt
recomputes each physical block at most once, and a prefix-hash map
keyed on (version, token chain) for admission-time reuse.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


def dynamic_batching(seq_lens: Sequence[int], capacity: int,
                     min_microbatches: int = 1) -> List[List[int]]:
    """Paper Algorithm 1.  Returns micro-batches as lists of indices into
    ``seq_lens``.  Sequences longer than ``capacity`` get singleton
    micro-batches (cannot be split)."""
    order = sorted(range(len(seq_lens)), key=lambda i: -seq_lens[i])
    batches: List[List[int]] = []
    loads: List[int] = []
    for i in order:
        s = seq_lens[i]
        fits = [j for j in range(len(batches)) if loads[j] + s <= capacity]
        if len(batches) < min_microbatches or not fits:
            batches.append([i])
            loads.append(s)
        else:
            j = min(fits, key=lambda j: len(batches[j]))    # fewest sequences
            batches[j].append(i)
            loads[j] += s
    return batches


def static_batching(seq_lens: Sequence[int], n_microbatches: int) -> List[List[int]]:
    """Baseline: fixed number of micro-batches, round-robin by arrival
    order (the 'standard micro-batching strategy' of Section 7.5)."""
    batches: List[List[int]] = [[] for _ in range(n_microbatches)]
    for i in range(len(seq_lens)):
        batches[i % n_microbatches].append(i)
    return [b for b in batches if b]


# ---------------------------------------------------------------------------
# Chunked-prefill planner (DESIGN.md §Chunked prefill)
# ---------------------------------------------------------------------------

def plan_prefill_chunks(total: int, budget: int, align: int = 1,
                        start: int = 0) -> List[Tuple[int, int]]:
    """Token-budget chunk plan for one slot's pending prefill work.

    Splits the history span [start, total) into consecutive (begin, end)
    spans of at most ``budget`` tokens, covering every token exactly
    once.  Every span end except the last is rounded DOWN to a multiple
    of ``align`` when that loses no progress (paged engines align to
    ``block_size`` so a prefix-shared block is rewritten by exactly one
    chunk and its version tag means "fully written"); when
    budget < align the spans are necessarily sub-block — safe, because
    the engine ingests slots strictly FIFO, so no other sharer reads a
    half-written block in between.
    """
    if not (budget > 0 and align >= 1 and 0 <= start <= total):
        raise ValueError(f"bad chunk plan: total={total} budget={budget} align={align} "
                         f"start={start}")
    spans: List[Tuple[int, int]] = []
    b = start
    while b < total:
        e = min(total, b + budget)
        if e < total and align > 1:
            aligned = (e // align) * align
            if aligned > b:
                e = aligned
        spans.append((b, e))
        b = e
    return spans


def span_dest_blocks(tables: np.ndarray, start: Sequence[int],
                     length: Sequence[int], block_size: int,
                     width: int) -> np.ndarray:
    """Physical destination blocks for per-slot position spans.

    tables: (n_slots, E) int32 block tables (-1 = unbound); row i's span
    covers absolute positions [start[i], start[i] + length[i]), laid out
    in a fixed-width (n_slots, width) array (length <= width; the rest
    is -1 = "don't write").  Positions past the table (or in unbound
    entries) also map to -1.  Used by the speculative verify/commit
    passes (DESIGN.md §Self-speculative decoding), whose multi-token
    spans land in the blocks ``blocks_needed`` preallocated at
    admission.
    """
    start = np.asarray(start, np.int64)
    length = np.asarray(length, np.int64)
    pos = start[:, None] + np.arange(width)[None, :]
    entry = pos // block_size
    valid = ((np.arange(width)[None, :] < length[:, None])
             & (entry < tables.shape[1]))
    dest = np.take_along_axis(tables,
                              np.clip(entry, 0, tables.shape[1] - 1).astype(np.int64),
                              axis=1)
    return np.where(valid, dest, -1).astype(np.int32)


# ---------------------------------------------------------------------------
# Paged KV-cache block allocator (host side of the paged rollout engine)
# ---------------------------------------------------------------------------

def prefix_block_hashes(version: int, tokens: Sequence[int],
                        block_size: int) -> List[bytes]:
    """SHA-256 chain over the *full* blocks of a token prefix.

    Entry i is a digest of (weight version, tokens[0 : (i+1)*block_size]) —
    chained, so block i+1's digest commits to the whole prefix before it,
    not just its own tokens.  Two slots share physical block i iff their
    chains agree at i, which is exactly "same weights and same prompt
    prefix through the end of block i": a cryptographic digest makes the
    map safe to trust on a hit without storing or re-comparing token
    prefixes (Python ``hash()`` collisions are constructible from token
    sequences; these are not).  Partial trailing blocks are never
    shareable (generation appends into them), so only
    len(tokens) // block_size entries are produced.
    """
    out: List[bytes] = []
    d = hashlib.sha256(f"kv-prefix:{version}".encode()).digest()
    for i in range(len(tokens) // block_size):
        block = tuple(tokens[i * block_size:(i + 1) * block_size])
        d = hashlib.sha256(d + repr(block).encode()).digest()
        out.append(d)
    return out


class BlockAllocator:
    """Fixed-pool KV block allocator with refcounts, prefix reuse, and
    optional LRU eviction of parked prefix blocks.

    Device state (the (N, bs, Hkv, hd) pools) never moves; this class
    tracks which physical blocks are live, how many slots reference
    each (shared prompt-prefix blocks are read-only with refcount > 1),
    which weight version each block's contents were computed under, and
    a prefix-hash -> block map for admission-time sharing.

    ``evict="lru"`` (DESIGN.md §Prefix eviction policy) changes what
    happens when a *registered* prefix block's refcount reaches zero:
    instead of returning to the free list (killing its prefix-map
    entry), the block PARKS in an LRU cache, contents and registration
    intact.  A later ``plan_prefix`` hit on a parked block revives it
    (refcount 0 -> 1); ``alloc`` under an empty free list evicts the
    least-recently-parked unpinned block instead of raising
    ``MemoryError``.  Eviction is strictly confined to parked blocks —
    a block with refcount > 0 or a pinned block is never touched — and
    ``clear_prefix_map`` (every weight change) flushes the whole cache
    plus all pins, because stale-version contents must never be revived.
    """

    def __init__(self, n_blocks: int, block_size: int, evict: str = "off"):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError("n_blocks and block_size must be positive")
        if evict not in ("off", "lru"):
            raise ValueError(f"evict must be 'off' or 'lru', got {evict!r}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.evict = evict
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._refs = np.zeros(n_blocks, np.int32)
        self._version = np.full(n_blocks, -1, np.int64)
        self._hash_of: Dict[int, bytes] = {}     # block -> prefix digest
        self._block_of: Dict[bytes, int] = {}    # prefix digest -> block
        # LRU park of refcount-0 registered blocks (insertion order =
        # recency: oldest first) and the version-scoped pin set
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._pinned: Set[int] = set()
        self.evictions = 0                 # parked blocks reclaimed by alloc
        self.revivals = 0                  # parked blocks rescued by a hit

    # ---- capacity ---------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        """Parked refcount-0 prefix blocks (LRU mode only)."""
        return len(self._lru)

    @property
    def n_evictable(self) -> int:
        """Parked blocks ``alloc`` may reclaim (cached minus pinned)."""
        return sum(1 for b in self._lru if b not in self._pinned)

    @property
    def n_available(self) -> int:
        """Blocks an admission plan can count on: free + evictable."""
        return len(self._free) + self.n_evictable

    @property
    def n_live(self) -> int:
        return self.n_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._refs[block])

    def version_of(self, block: int) -> int:
        return int(self._version[block])

    def is_cached(self, block: int) -> bool:
        return block in self._lru

    # ---- alloc / share / release -----------------------------------------
    def alloc(self, version: int) -> int:
        """Take a free block (refcount 1, tagged ``version``).  In LRU
        mode an empty free list evicts the least-recently-parked
        unpinned prefix block first (DESIGN.md §Prefix eviction policy);
        only when nothing is evictable does the pool raise."""
        if not self._free and self.evict == "lru":
            self._evict_one()
        if not self._free:
            raise MemoryError("KV block pool exhausted")
        b = self._free.pop()
        self._refs[b] = 1
        self._version[b] = version
        return b

    def _evict_one(self) -> None:
        """Reclaim the oldest unpinned parked block: unregister its
        prefix hash (the next admission of that prefix MISSES and
        recomputes through chunked ingest) and return it to the free
        list.  Refcounted and pinned blocks are structurally exempt —
        they are never in the eviction scan."""
        for b in self._lru:
            if b not in self._pinned:
                del self._lru[b]
                self._unregister(b)
                self._version[b] = -1
                self._free.append(b)
                self.evictions += 1
                return

    def retain(self, block: int) -> int:
        """Add a reference to a live block (prefix sharing).  A parked
        refcount-0 block is revived: it leaves the LRU cache with its
        contents, version tag and registration intact."""
        if self._refs[block] == 0 and block in self._lru:
            del self._lru[block]
            self._refs[block] = 1
            self.revivals += 1
            return block
        if self._refs[block] <= 0:
            raise RuntimeError(f"retain of free block {block}")
        self._refs[block] += 1
        return block

    def release(self, block: int) -> bool:
        """Drop one reference.  At refcount zero: LRU mode parks a
        still-registered block (contents stay revivable — returns
        False); otherwise the block is freed and its prefix-map entry
        dies (returns True)."""
        if self._refs[block] <= 0:
            raise RuntimeError(f"release of free block {block}")
        self._refs[block] -= 1
        if self._refs[block]:
            return False
        if self.evict == "lru" and block in self._hash_of:
            self._lru[block] = None        # park, most-recently-used end
            self._lru.move_to_end(block)
            return False
        self._unregister(block)
        self._pinned.discard(block)
        self._version[block] = -1
        self._free.append(block)
        return True

    # ---- pinning (version-scoped) -----------------------------------------
    def pin(self, block: int) -> None:
        """Exempt a block from eviction while parked (hot-session prompt
        blocks).  Pins are version-scoped: ``clear_prefix_map`` — every
        weight change — dissolves them all."""
        self._pinned.add(block)

    def unpin(self, block: int) -> None:
        self._pinned.discard(block)

    def is_pinned(self, block: int) -> bool:
        return block in self._pinned

    # ---- prefix map -------------------------------------------------------
    def _require_live(self, block: int) -> None:
        if self._refs[block] <= 0:
            raise RuntimeError(f"block {block} is not live")

    def _unregister(self, block: int) -> None:
        h = self._hash_of.pop(block, None)
        if h is not None and self._block_of.get(h) == block:
            del self._block_of[h]

    def lookup(self, prefix_hash: bytes) -> Optional[int]:
        return self._block_of.get(prefix_hash)

    def register(self, prefix_hash: bytes, block: int) -> None:
        """Publish a live block as the holder of ``prefix_hash``."""
        self._require_live(block)
        self._unregister(block)
        self._hash_of[block] = prefix_hash
        self._block_of[prefix_hash] = block

    def invalidate(self, block: int) -> None:
        """Withdraw a live block's prefix registration and stale its
        version tag — for blocks that were RESERVED and registered but
        never written (an admission plan rolled back on pool pressure).
        Without this, LRU mode would park garbage-content blocks as
        prefix holders and a later admission could reuse them without
        recomputation (DESIGN.md §Prefix eviction policy)."""
        self._require_live(block)
        self._unregister(block)
        self._version[block] = -1

    def set_version(self, block: int, version: int) -> None:
        """Tag a live block's contents as recomputed under ``version``
        (the update_weights re-prefill path)."""
        self._require_live(block)
        self._version[block] = version

    def clear_prefix_map(self) -> None:
        """Drop every prefix registration (a weight-version bump makes all
        old-version hashes unreachable; the re-prefill re-registers).
        Parked blocks hold old-version contents that must never be
        revived, so the whole LRU cache flushes to the free list and
        every pin dissolves."""
        self._hash_of.clear()
        self._block_of.clear()
        for b in self._lru:
            self._version[b] = -1
            self._free.append(b)
        self._lru.clear()
        self._pinned.clear()

    # ---- admission planning ----------------------------------------------
    def plan_prefix(self, version: int, prompt: Sequence[int]
                    ) -> Tuple[List[int], int]:
        """Shared-prefix admission plan for ``prompt``: returns
        (block ids for each full prompt block — existing shared blocks
        retained (parked ones revived), the rest freshly allocated and
        registered — and the count of *reused* leading blocks).  Raises
        MemoryError (after rolling back) if the pool cannot cover the
        unshared tail.  Rollback withdraws the registrations of the
        fresh, never-written blocks so they cannot be parked as garbage
        prefix holders."""
        hashes = prefix_block_hashes(version, prompt, self.block_size)
        blocks: List[int] = []
        reused = 0
        try:
            for h in hashes:
                hit = self.lookup(h)
                if hit is not None and reused == len(blocks):
                    blocks.append(self.retain(hit))
                    reused += 1
                else:
                    b = self.alloc(version)
                    self.register(h, b)
                    blocks.append(b)
        except MemoryError:
            for j, b in enumerate(blocks):
                if j >= reused:            # fresh: registered, never written
                    self.invalidate(b)
                self.release(b)
            raise
        return blocks, reused


@dataclass
class PackedBatch:
    """Fixed-shape packed arrays for one micro-batch."""
    tokens: np.ndarray          # (R, L) int32
    positions: np.ndarray       # (R, L) int32 within-segment positions
    segment_ids: np.ndarray     # (R, L) int32; -1 = padding
    loss_mask: np.ndarray       # (R, L) float32; 1 on response tokens
    advantages: np.ndarray      # (R, L) float32
    behav_logprob: np.ndarray   # (R, L) float32
    seq_index: np.ndarray       # (R, L) int32 source sequence (-1 pad)

    @property
    def n_tokens(self) -> int:
        return int((self.segment_ids >= 0).sum())

    @property
    def padding_fraction(self) -> float:
        return 1.0 - self.n_tokens / self.tokens.size


def pack_sequences(seqs: List[Dict], pack_len: int, rows: int = 0) -> PackedBatch:
    """Greedy first-fit packing of variable-length sequences into
    (rows, pack_len) with segment ids.

    Each seq dict: tokens (list[int]), loss_mask (list[float]),
    advantage (float, broadcast over response tokens),
    behav_logprob (list[float] aligned with tokens).
    """
    lens = [len(s["tokens"]) for s in seqs]
    if not all(l <= pack_len for l in lens):
        raise ValueError("sequence exceeds pack length")
    # first-fit decreasing row assignment
    order = sorted(range(len(seqs)), key=lambda i: -lens[i])
    row_of: Dict[int, int] = {}
    row_loads: List[int] = []
    for i in order:
        placed = False
        for r, load in enumerate(row_loads):
            if load + lens[i] <= pack_len:
                row_of[i] = r
                row_loads[r] += lens[i]
                placed = True
                break
        if not placed:
            row_of[i] = len(row_loads)
            row_loads.append(lens[i])
    n_rows = max(rows, len(row_loads)) or 1

    shape = (n_rows, pack_len)
    tokens = np.zeros(shape, np.int32)
    positions = np.zeros(shape, np.int32)
    segment_ids = np.full(shape, -1, np.int32)
    loss_mask = np.zeros(shape, np.float32)
    advantages = np.zeros(shape, np.float32)
    behav_lp = np.zeros(shape, np.float32)
    seq_index = np.full(shape, -1, np.int32)

    offsets = [0] * n_rows
    for seg, i in enumerate(order):
        r = row_of[i]
        o = offsets[r]
        L = lens[i]
        s = seqs[i]
        tokens[r, o:o + L] = s["tokens"]
        positions[r, o:o + L] = np.arange(L)
        segment_ids[r, o:o + L] = seg
        loss_mask[r, o:o + L] = s["loss_mask"]
        advantages[r, o:o + L] = np.asarray(s["loss_mask"], np.float32) * s["advantage"]
        behav_lp[r, o:o + L] = s["behav_logprob"]
        seq_index[r, o:o + L] = i
        offsets[r] = o + L

    return PackedBatch(tokens, positions, segment_ids, loss_mask,
                       advantages, behav_lp, seq_index)

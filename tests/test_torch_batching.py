"""The port's copy of the paged engine's host side (``repro_torch.core.batching``)
against ``repro.core.batching``: the same chunk plans, span destinations
and prefix hashes, and the same ``BlockAllocator`` state after the same
random sequences of operations, with ``evict`` off and ``"lru"``."""
import numpy as np
import pytest

from repro.core import batching as jb
from repro_torch.core import batching as tb


def test_chunk_plans_agree():
    rng = np.random.default_rng(0)
    for _ in range(300):
        total = int(rng.integers(0, 80))
        args = (total, int(rng.integers(1, 20)), int(rng.integers(1, 9)),
                int(rng.integers(0, total + 1)))
        assert tb.plan_prefill_chunks(*args) == jb.plan_prefill_chunks(*args)
    with pytest.raises(ValueError):
        tb.plan_prefill_chunks(5, 0)


def test_span_destinations_agree():
    rng = np.random.default_rng(1)
    tables = rng.integers(-1, 40, size=(6, 5)).astype(np.int32)
    for _ in range(50):
        start = rng.integers(0, 24, size=6)
        length = rng.integers(0, 5, size=6)
        got = tb.span_dest_blocks(tables, start, length, 4, 5)
        np.testing.assert_array_equal(got, jb.span_dest_blocks(tables, start, length, 4, 5))


def test_prefix_hashes_agree_byte_for_byte():
    rng = np.random.default_rng(2)
    for version in (0, 1, 7):
        tokens = rng.integers(0, 1000, size=int(rng.integers(0, 40))).tolist()
        for bs in (1, 4, 16):
            assert tb.prefix_block_hashes(version, tokens, bs) == \
                jb.prefix_block_hashes(version, tokens, bs)


def _state(a):
    return (list(a._free), a._refs.tolist(), a._version.tolist(), dict(a._hash_of),
            dict(a._block_of), list(a._lru), sorted(a._pinned), a.evictions, a.revivals,
            a.n_available, a.n_live)


@pytest.mark.parametrize("evict", ["off", "lru"])
def test_allocator_states_agree_over_random_operations(evict):
    rng = np.random.default_rng(3 if evict == "off" else 4)
    allocs = [jb.BlockAllocator(12, 4, evict=evict), tb.BlockAllocator(12, 4, evict=evict)]
    prompts = [rng.integers(0, 9, size=n).tolist() for n in (4, 8, 9, 12, 5)]
    live = []                               # blocks held, as the reference holds them
    version = 0
    for _ in range(400):
        op = rng.integers(0, 8)
        ref = allocs[0]
        if op == 0 and ref.n_available:
            results = [a.alloc(version) for a in allocs]
            live.append(results[0])
        elif op == 1:
            prompt = prompts[int(rng.integers(len(prompts)))]
            outs = []
            for a in allocs:
                try:
                    outs.append(a.plan_prefix(version, prompt))
                except MemoryError:
                    outs.append("full")
            assert outs[0] == outs[1]
            if outs[0] != "full":
                live.extend(outs[0][0])
        elif op == 2 and live:
            b = live.pop(int(rng.integers(len(live))))
            assert len({a.release(b) for a in allocs}) == 1
        elif op == 3 and live:
            b = live[int(rng.integers(len(live)))]
            for a in allocs:
                a.retain(b)
            live.append(b)
        elif op == 4 and live:
            b = live[int(rng.integers(len(live)))]
            pin = rng.random() < 0.5
            for a in allocs:
                a.pin(b) if pin else a.unpin(b)
        elif op == 5 and live:
            b = live[int(rng.integers(len(live)))]
            v = int(rng.integers(-1, 3))
            for a in allocs:
                a.set_version(b, v)
        elif op == 6 and rng.random() < 0.1:
            version += 1
            for a in allocs:
                a.clear_prefix_map()
        elif op == 7 and live:
            b = live[int(rng.integers(len(live)))]
            for a in allocs:
                a.invalidate(b)
        assert _state(allocs[1]) == _state(allocs[0])
    assert allocs[0].n_live > 0


def test_allocator_raises_on_misuse():
    a = tb.BlockAllocator(2, 4)
    with pytest.raises(RuntimeError, match="free block"):
        a.release(0)
    b = a.alloc(0)
    a.alloc(0)
    with pytest.raises(MemoryError):
        a.alloc(0)
    a.release(b)
    with pytest.raises(RuntimeError, match="not live"):
        a.set_version(b, 1)
    with pytest.raises(ValueError):
        tb.BlockAllocator(0, 4)

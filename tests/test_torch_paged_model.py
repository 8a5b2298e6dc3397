"""The PyTorch port's paged LM methods against the JAX ``LM`` on the same
weights.

The reference initialises the parameters; ``params_from_jax`` loads them
into the port.  Two slots are prefilled monolithically into a shared
block pool (the second shares the first's leading prompt block, so it
writes only its own blocks), a third slot ingests its prompt in two
chunks through ``prefill_chunk_paged``, and then all three decode with
one slot held back, unfused and through the fused tail.  Logits, the
pool contents and the positions ``t`` are compared in f32 with atol =
rtol = 1e-4 (same operations, different summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax

TOL = 1e-4
BS, N_BLOCKS = 4, 16
TABLES = np.array([[3, 7, 1, 9, -1],
                   [3, 5, 11, -1, -1],       # shares block 3 with slot 0
                   [2, 4, 6, 8, 10]], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def pair(**extra):
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE, **extra)
    jcfg = dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")), **kw)
    tcfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), **kw)
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(2))
    return jmodel, params, params_from_jax(tcfg, flat_params(params), device="cpu")


def dest_of(slot, positions, skip_entries=0):
    """Pool block of each position of ``slot`` (-1 for shared entries)."""
    e = np.asarray(positions) // BS
    return np.where(e >= skip_entries, TABLES[slot][e], -1).astype(np.int32)


@pytest.mark.parametrize("extra", [{}, {"sliding_window": 4}], ids=["attn", "swa"])
def test_paged_prefill_chunks_and_decode_match_reference(extra):
    jmodel, params, model = pair(**extra)
    rng = np.random.default_rng(1)
    n_slots = 3
    jcache = jmodel.init_paged_cache(n_slots, N_BLOCKS, BS)
    cache = model.init_paged_cache(n_slots, N_BLOCKS, BS)
    assert cache["k_pool"].shape == (len(model.blocks), N_BLOCKS, BS, model.cfg.n_kv_heads,
                                     model.cfg.head_dim)

    def check(jlogits, logits):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
        ju = jcache["units"][0]              # stacked (n_layers, N, bs, Hkv, hd)
        for name in ("k_pool", "v_pool"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(ju[name]),
                                       atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))

    # slots 0 and 1: one monolithic prefill; slot 1's first block is slot 0's
    s = 9
    toks = rng.integers(3, tokenizer.VOCAB_SIZE, size=(2, s)).astype(np.int32)
    toks[1, :BS] = toks[0, :BS]
    length = np.array([9, 6], np.int32)
    dest = np.stack([dest_of(0, np.arange(s)), dest_of(1, np.arange(s), skip_entries=1)])
    dest[1, 6:] = -1
    jlogits, jcache = jmodel.prefill_paged(params, jnp.asarray(toks), jcache, jnp.asarray(dest),
                                           jnp.asarray([0, 1], jnp.int32),
                                           length=jnp.asarray(length))
    logits, cache = model.prefill_paged(torch.from_numpy(toks), cache, torch.from_numpy(dest),
                                        torch.tensor([0, 1]), length=torch.from_numpy(length))
    assert logits.dtype == torch.float32
    check(jlogits, logits)

    # slot 2: its prompt in two spans of a 6-token chunk
    prompt = rng.integers(3, tokenizer.VOCAB_SIZE, size=11).astype(np.int32)
    for begin, end in ((0, 5), (5, 11)):
        c = 6
        span = np.zeros((1, c), np.int32)
        span[0, :end - begin] = prompt[begin:end]
        d = np.full((1, c), -1, np.int32)
        d[0, :end - begin] = dest_of(2, np.arange(begin, end))
        args = (TABLES[2:3], d, np.array([2], np.int32), np.array([begin], np.int32),
                np.array([end - begin], np.int32))
        jlogits, jcache = jmodel.prefill_chunk_paged(params, jnp.asarray(span), jcache,
                                                     *map(jnp.asarray, args))
        logits, cache = model.prefill_chunk_paged(torch.from_numpy(span), cache,
                                                  *map(torch.from_numpy, args))
        check(jlogits, logits)

    # decode: slot 1 held back on the first steps; unfused, then fused
    tables = TABLES.copy()
    for step, fused in enumerate((False, False, True, True)):
        active = np.array([True, step >= 2, True])
        tok = rng.integers(3, tokenizer.VOCAB_SIZE, size=(n_slots,)).astype(np.int32)
        jlogits, jcache = jmodel.decode_step_paged(params, jnp.asarray(tok), jcache,
                                                   jnp.asarray(tables), jnp.asarray(active),
                                                   fused_tail=fused)
        logits, cache = model.decode_step_paged(torch.from_numpy(tok), cache,
                                                torch.from_numpy(tables),
                                                torch.from_numpy(active), fused_tail=fused)
        check(jlogits, logits)

    jcache = jmodel.reset_slot_rows(jcache, jnp.asarray([1], jnp.int32))
    cache = model.reset_slot_rows(cache, torch.tensor([1]))
    np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))


def test_pool_writes_skip_unset_destinations():
    from repro_torch.models import attention
    dest = torch.tensor([[4, -1, 2], [-1, -1, 7]])
    pos = torch.tensor([[5, 6, 7], [0, 1, 9]])
    rows, blocks, offsets = attention.pool_writes(dest, pos, 4)
    assert rows.tolist() == [0, 2, 5]
    assert blocks.tolist() == [4, 2, 7] and offsets.tolist() == [1, 3, 1]

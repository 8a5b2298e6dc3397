"""The port's production step functions (``repro_torch.launch.steps``)
against the reference's (``repro.launch.steps``), on reduced dense, MoE
and RG-LRU hybrid configs in f32 from one init (``params_from_jax``).

``train_step`` at accum_steps 1 and 2, with and without the
vocab-parallel loss: the updated parameters within 1e-5 max abs (lr
1e-3: an Adam step moves a weight by about lr) and every metric within
1e-5 relative.  ``prox_step``'s logprobs within 1e-5.  The serving
steps (prefill, ring decode, paged decode, the fused tail and the
chunked-prefill span) on caches each side filled from the same prompts:
logits within 1e-4 (f32 sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import RLConfig as JaxRLConfig
from repro.launch import steps as jsteps
from repro.models.model import build_model as jax_build_model
from repro_torch import optim
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.launch import steps
from repro_torch.models.convert import params_from_jax

ARCHS = ["areal-qwen-1.5b", "olmoe-1b-7b", "recurrentgemma-9b"]
LR = 1e-3
TRAIN_TOL, LOGIT_TOL = 1e-5, 1e-4
B, S = 4, 16
BS = 4


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


_PAIRS = {}


def pair(arch):
    """(reference model, its params, the port's config), one init an arch."""
    if arch not in _PAIRS:
        kw = dict(vocab_size=256)
        jcfg = dataclasses.replace(jax_reduced(jax_config(arch)), **kw)
        tcfg = dataclasses.replace(reduced(get_model_config(arch)), **kw)
        jmodel = jax_build_model(jcfg, remat=False)
        _PAIRS[arch] = (jmodel, jmodel.init(jax.random.key(4)), tcfg)
    return _PAIRS[arch]


def port(tcfg, params):
    return params_from_jax(tcfg, flat_params(params), device="cpu")


def train_batch(vocab, seed=0):
    """Packed rows: two sequences a row (the second cut by a -1 tail in
    two rows), per-token advantages, behaviour and proximal logprobs and
    a loss mask on the answers."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for r in range(B):
        cut = int(rng.integers(5, 11))
        seg[r, cut:] = 1
        pos[r] = np.concatenate([np.arange(cut), np.arange(S - cut)])
        if r % 2:
            seg[r, S - 3:] = -1
    mask = (rng.random((B, S)) < 0.6).astype(np.float32)
    behav = (-3 * rng.random((B, S))).astype(np.float32)
    return {"tokens": rng.integers(3, vocab, (B, S)).astype(np.int32), "positions": pos,
            "segment_ids": seg, "advantages": rng.standard_normal((B, S)).astype(np.float32),
            "behav_logprob": behav,
            "prox_logprob": (behav + 0.1 * rng.standard_normal((B, S))).astype(np.float32),
            "loss_mask": mask}


TRAIN_CASES = [(arch, a, vp) for arch in ARCHS for a in (1, 2) for vp in (False, True)]


@pytest.mark.parametrize("arch,accum,vocab_parallel", TRAIN_CASES,
                         ids=[f"{a}-{n}-{'vp' if vp else 'plain'}" for a, n, vp in TRAIN_CASES])
def test_train_step_matches_the_reference(arch, accum, vocab_parallel):
    jmodel, params, tcfg = pair(arch)
    model = port(tcfg, params)
    batch = train_batch(tcfg.vocab_size)
    jstep = jsteps.make_train_step(jmodel, JaxRLConfig(lr=LR), vocab_parallel_loss=vocab_parallel,
                                   accum_steps=accum)
    jparams, _, jmet = jax.jit(jstep)(params, joptim.init_state(params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    step = steps.make_train_step(model, RLConfig(lr=LR), vocab_parallel_loss=vocab_parallel,
                                 accum_steps=accum)
    opt = optim.init_state(list(model.parameters()))
    met = step(opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=TRAIN_TOL, atol=1e-8,
                                   err_msg=k)
    want = port(tcfg, jparams)
    init = port(tcfg, params)
    moved = 0.0
    for (name, p), w, p0 in zip(model.named_parameters(), want.parameters(), init.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=0, atol=TRAIN_TOL,
                                   err_msg=name)
        moved = max(moved, (p.detach() - p0).abs().max().item())
    assert moved > 0.5 * LR
    assert opt["step"] == 1 and all(m.dtype == torch.float32 for m in opt["m"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prox_step_matches_the_reference(arch):
    jmodel, params, tcfg = pair(arch)
    model = port(tcfg, params)
    batch = train_batch(tcfg.vocab_size, seed=1)
    want = jsteps.make_prox_logprob_step(jmodel)(params, {k: jnp.asarray(v)
                                                          for k, v in batch.items()})
    got = steps.make_prox_logprob_step(model)({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TRAIN_TOL, atol=TRAIN_TOL)
    assert not np.all(np.asarray(want) == 0)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_steps_match_the_reference(arch):
    """prefill_step then serve_step on the ring cache; prefill_paged into
    a pool, then paged_serve_step, fused_serve_step and one chunk span
    through paged_prefill_chunk_step, each side on its own cache."""
    jmodel, params, tcfg = pair(arch)
    model = port(tcfg, params)
    rng = np.random.default_rng(2)
    n, s, max_len = 3, 10, 24
    toks = rng.integers(3, tcfg.vocab_size, (n, s)).astype(np.int32)
    length = np.array([10, 7, 9], np.int32)
    j = lambda x: jnp.asarray(x)
    t = lambda x: torch.from_numpy(np.asarray(x))
    jlog, jcache = jsteps.make_prefill_step(jmodel, max_len, jnp.float32)(
        params, {"tokens": j(toks), "length": j(length)})
    log, cache = steps.make_prefill_step(model, max_len, torch.float32)(
        {"tokens": t(toks), "length": t(length)})
    close(log, jlog)
    jserve, serve = jsteps.make_serve_step(jmodel), steps.make_serve_step(model)
    for _ in range(3):
        tok = rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
        jlog, jcache = jserve(params, j(tok), jcache)
        log, cache = serve(t(tok), cache)
        close(log, jlog)

    # the paged pool: slot i owns blocks i*E .. i*E+E-1
    e = -(-max_len // BS)
    n_blocks = n * e
    tables = np.arange(n_blocks, dtype=np.int32).reshape(n, e)
    dest = np.where(np.arange(s)[None] < length[:, None],
                    tables[:, np.arange(s) // BS], -1).astype(np.int32)
    slots = np.arange(n, dtype=np.int32)
    jpc = jmodel.init_paged_cache(n, n_blocks, BS, jnp.float32)
    pc = model.init_paged_cache(n, n_blocks, BS, torch.float32)
    jlog, jpc = jmodel.prefill_paged(params, j(toks), jpc, j(dest), j(slots), length=j(length))
    log, pc = model.prefill_paged(t(toks), pc, t(dest), t(slots), length=t(length))
    close(log, jlog)
    for jfn, fn in ((jsteps.make_paged_serve_step(jmodel), steps.make_paged_serve_step(model)),
                    (jsteps.make_fused_serve_step(jmodel), steps.make_fused_serve_step(model))):
        tok = rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
        jlog, jpc = jfn(params, j(tok), jpc, j(tables))
        log, pc = fn(t(tok), pc, t(tables))
        close(log, jlog)
    # a span of 6 for slot 1, continuing from its position
    c = 6
    start = np.asarray(pc["t"])[1:2].astype(np.int32)
    span = rng.integers(3, tcfg.vocab_size, (1, c)).astype(np.int32)
    pos = start[0] + np.arange(c)
    cdest = tables[1, pos // BS][None].astype(np.int32)
    args = (tables[1:2], cdest, np.array([1], np.int32), start, np.array([5], np.int32))
    jlog, jpc = jsteps.make_paged_prefill_chunk_step(jmodel)(params, j(span), jpc,
                                                            *map(j, args))
    log, pc = steps.make_paged_prefill_chunk_step(model)(t(span), pc, *map(t, args))
    close(log, jlog)
    assert np.asarray(pc["t"]).tolist() == np.asarray(jpc["t"]).tolist()

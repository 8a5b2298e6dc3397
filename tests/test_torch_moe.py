"""The PyTorch port's mixture-of-experts layer and MoE LM against the live
JAX package.

``moe_apply`` against ``repro.models.moe.moe_apply`` on the same weights
and inputs (numpy seeds), in f32 at 1e-5: y, the load-balance loss, the
z-loss and the dropped share, with one group and with 32, with explicit
capacity and groups, at the default capacity factor where assignments
are dropped and at a dropless factor of 16, and with router
probabilities tied on purpose, where the port's stable-sort selection
must pick the experts ``lax.top_k`` picks.  Gradients of a scalar of y
and of the router losses against ``jax.grad``.

The reduced olmoe-1b-7b ``LM`` (4 experts, top 2, QK-norm) from
``params_from_jax`` of the reference's init: the training forward and
its summed aux, packed and plain; ``prefill`` then ``decode_step`` and
``prefill_chunk`` on the ring cache; ``prefill_paged``,
``prefill_chunk_paged`` and ``decode_step_paged`` unfused and fused on
the paged cache; logits and caches at 1e-4 (as the dense model's tests:
several layers of f32 rounding), with assignments dropped.  Packed rows
equal separate rows at factor 16, as ``tests/test_models.py`` asserts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_model_config, reduced
from repro_torch.data import tokenizer
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax

TOL = 1e-5
LM_TOL = 1e-4
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


def configs(**extra):
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE, **extra)
    return (dataclasses.replace(jax_reduced(jax_config("olmoe-1b-7b")), **kw),
            dataclasses.replace(reduced(get_model_config("olmoe-1b-7b")), **kw))


def layer_pair(seed=0, **extra):
    """The reference's MoE params and the port's ``MoE`` holding them."""
    jcfg, tcfg = configs(**extra)
    params = jax_moe.moe_init(jax.random.key(seed), jcfg)
    layer = moe.MoE(tcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name in ("router", "w_up", "w_gate", "w_down"):
            getattr(layer, name).copy_(torch.from_numpy(np.array(params[name])))
    return jcfg, tcfg, params, layer


def t(x):
    return torch.from_numpy(np.array(x))


def jit_apply(jcfg, params, x, capacity=0, n_groups=0):
    """The reference's ``moe_apply``, jitted (eager JAX dispatch is slow)."""
    fn = jax.jit(lambda p, xx: jax_moe.moe_apply(jcfg, p, xx, capacity=capacity,
                                                  n_groups=n_groups))
    return fn(params, x)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

LAYER_CASES = {
    # name: (input shape, capacity factor, capacity, n_groups)
    "g1": ((24,), 1.25, 0, 0),
    "g1-batched": ((3, 10), 1.25, 0, 0),
    "g32": ((256,), 1.25, 0, 0),
    "explicit": ((40,), 1.25, 3, 2),
    "dropless": ((64,), 16.0, 0, 0),
}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_moe_apply_matches_reference(name):
    lead, cf, cap, ng = LAYER_CASES[name]
    jcfg, tcfg, params, layer = layer_pair(moe_capacity_factor=cf)
    x = np.random.default_rng(1).normal(size=lead + (jcfg.d_model,)).astype(np.float32)
    y, aux = jit_apply(jcfg, params, jnp.asarray(x), capacity=cap, n_groups=ng)
    ty, taux = moe.moe_apply(tcfg, layer, t(x), capacity=cap, n_groups=ng)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=TOL, rtol=TOL)
    for k, want in (("lb", aux.load_balance_loss), ("z", aux.z_loss),
                    ("drop", aux.dropped_fraction)):
        np.testing.assert_allclose(taux[k].item(), float(want), atol=TOL, rtol=TOL, err_msg=k)
    drop = taux["drop"].item()
    if name in ("g32", "explicit"):
        assert drop > 0, "the case must drop assignments"
    if name == "dropless":
        assert drop == 0


def test_top_k_order_matches_lax_top_k():
    """Ties go to the lower expert id, as ``lax.top_k`` (``torch.topk``
    does not promise this): the vector of the port's design note, and rows
    of many ties."""
    rows = [np.array([0.5, 0.7, 0.7, 0.1, 0.7, 0.2], np.float32)]
    rng = np.random.default_rng(2)
    rows += [rng.integers(0, 3, size=16).astype(np.float32) / 4 for _ in range(20)]
    for row in rows:
        for k in (1, 2, 3, 5):
            jv, ji = jax.lax.top_k(jnp.asarray(row), k)
            tv, ti = moe.top_k_stable(torch.from_numpy(row), k)
            assert ti.tolist() == np.asarray(ji).tolist(), (row, k)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert moe.top_k_stable(torch.from_numpy(rows[0]), 2)[1].tolist() == [1, 2]


@pytest.mark.parametrize("tie", ["all-equal", "twin-experts"])
def test_moe_apply_with_tied_router_probabilities(tie):
    """Router probabilities tied on purpose: a zero router (every expert
    equal: each token goes to experts 0 and 1, most are dropped), or
    experts 1 and 2 with the same router column (a tie in every row).
    The expert choice, and so y and the drops, match the reference."""
    jcfg, tcfg, params, layer = layer_pair(seed=3)
    router = np.array(params["router"])
    router = np.zeros_like(router) if tie == "all-equal" else router
    router[:, 2] = router[:, 1]
    params = {**params, "router": jnp.asarray(router)}
    with torch.no_grad():
        layer.router.copy_(t(router))
    x = np.random.default_rng(4).normal(size=(32, jcfg.d_model)).astype(np.float32)
    y, aux = jit_apply(jcfg, params, jnp.asarray(x))
    ty, taux = moe.moe_apply(tcfg, layer, t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(taux["drop"].item(), float(aux.dropped_fraction), atol=TOL)
    np.testing.assert_allclose(taux["lb"].item(), float(aux.load_balance_loss), atol=TOL,
                               rtol=TOL)
    probs = torch.softmax(t(x) @ t(router), dim=-1)
    _, top_e = moe.top_k_stable(probs, tcfg.experts_per_token)
    _, jtop_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1),
                              jcfg.experts_per_token)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    if tie == "all-equal":
        # 32 tokens x 2 choices on experts 0 and 1, 21 rows each
        assert (top_e == torch.tensor([0, 1])).all()
        assert taux["drop"].item() == pytest.approx(1 - 2 * 21 / 64)


@pytest.mark.parametrize("name", ["g1", "g32"])
def test_moe_gradients_match_jax_grad(name):
    """d/d(params, x) of sum(y * r) + lb + z: 1e-5 of each gradient's
    largest entry."""
    lead, cf, cap, ng = LAYER_CASES[name]
    jcfg, tcfg, params, layer = layer_pair(seed=5, moe_capacity_factor=cf)
    rng = np.random.default_rng(6)
    x = rng.normal(size=lead + (jcfg.d_model,)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_moe.moe_apply(jcfg, p, xx)
        return jnp.sum(y * r) + aux.load_balance_loss + aux.z_loss
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    for p in layer.parameters():
        p.requires_grad_(True)
    y, aux = moe.moe_apply(tcfg, layer, xt)
    ((y * t(r)).sum() + aux["lb"] + aux["z"]).backward()
    pairs = [(xt.grad, jgx)] + [(getattr(layer, n).grad, jgp[n])
                                for n in ("router", "w_up", "w_gate", "w_down")]
    for got, want in pairs:
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)


# ---------------------------------------------------------------------------
# the MoE LM
# ---------------------------------------------------------------------------

def lm_pair(seed=2, **extra):
    jcfg, tcfg = configs(**extra)
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(seed))
    return jmodel, params, params_from_jax(tcfg, flat_params(params), device="cpu")


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_lm_forward_and_aux_match_reference(packed):
    jmodel, params, model = lm_pair()
    rng = np.random.default_rng(7)
    toks = rng.integers(3, tokenizer.VOCAB_SIZE, size=(2, 16)).astype(np.int32)
    kw = {}
    if packed:
        kw = dict(segment_ids=np.array([[0] * 7 + [1] * 9, [0] * 12 + [-1] * 4], np.int32),
                  positions=np.array([list(range(7)) + list(range(9)),
                                      list(range(12)) + [0] * 4], np.int32))
    logits, aux = jmodel.forward(params, jnp.asarray(toks),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, taux = model.forward(t(toks), **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(logits), atol=LM_TOL,
                               rtol=LM_TOL)
    for k in ("lb", "z", "drop"):
        np.testing.assert_allclose(taux[k].item(), float(aux[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)
    assert taux["drop"].item() > 0


def test_packed_equals_separate_at_a_dropless_factor():
    """At capacity factor 16 no assignment is dropped, so rows do not
    couple and two sequences packed into one row score as separate rows
    (``tests/test_models.py::test_packed_equals_separate``, 2e-3), and the
    packed hidden states equal the reference's within 1e-4."""
    jmodel, params, model = lm_pair(moe_capacity_factor=16.0)
    rng = np.random.default_rng(8)
    s1, s2 = (rng.integers(0, tokenizer.VOCAB_SIZE, size=(1, 6)) for _ in range(2))
    packed = np.concatenate([s1, s2], axis=1)
    seg = np.array([[0] * 6 + [1] * 6], np.int32)
    pos = np.array([list(range(6)) * 2], np.int32)
    h, aux = model.hidden_states(t(packed), positions=t(pos), segment_ids=t(seg))
    h1, _ = model.hidden_states(t(s1))
    h2, _ = model.hidden_states(t(s2))
    assert aux["drop"].item() == 0
    np.testing.assert_allclose(h[:, :6].detach().numpy(), h1.detach().numpy(), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(h[:, 6:].detach().numpy(), h2.detach().numpy(), atol=2e-3,
                               rtol=2e-3)
    jh, _ = jmodel.hidden_states(params, jnp.asarray(packed, jnp.int32),
                                 positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=LM_TOL, rtol=LM_TOL)


def test_ring_prefill_chunk_and_decode_match_reference():
    """Right-padded prefill of 3 rows (the padding reaches the experts and
    takes capacity), a chunked span of one slot, then decode steps with a
    slot held back."""
    jmodel, params, model = lm_pair()
    rng = np.random.default_rng(9)
    b, s, max_len = 3, 10, 24
    toks = rng.integers(3, tokenizer.VOCAB_SIZE, size=(b, s)).astype(np.int32)
    length = np.array([10, 4, 7], np.int32)
    jcache = jmodel.init_cache(b, max_len)
    cache = model.init_cache(b, max_len)

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL, rtol=LM_TOL)
        ju = jcache["units"][0]
        for name in ("k", "v", "pos"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(ju[name]), atol=LM_TOL,
                                       rtol=LM_TOL)
        np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))

    jl, jcache = jmodel.prefill(params, jnp.asarray(toks), jcache, length=jnp.asarray(length))
    tl, cache = model.prefill(t(toks), cache, length=t(length))
    check(jl, tl)
    span = np.zeros((1, 5), np.int32)
    span[0, :3] = rng.integers(3, tokenizer.VOCAB_SIZE, size=3)
    args = (np.array([1], np.int32), np.array([4], np.int32), np.array([3], np.int32))
    jl, jcache = jmodel.prefill_chunk(params, jnp.asarray(span), jcache,
                                      *map(jnp.asarray, args))
    tl, cache = model.prefill_chunk(t(span), cache, *map(t, args))
    check(jl, tl)
    for step in range(3):
        active = np.array([True, step > 0, True])
        tok = rng.integers(3, tokenizer.VOCAB_SIZE, size=(b,)).astype(np.int32)
        jl, jcache = jmodel.decode_step(params, jnp.asarray(tok), jcache, jnp.asarray(active))
        tl, cache = model.decode_step(t(tok), cache, t(active))
        check(jl, tl)


def dest_of(slot, positions, skip_entries=0):
    e = np.asarray(positions) // BS
    return np.where(e >= skip_entries, TABLES[slot][e], -1).astype(np.int32)


def test_paged_prefill_chunks_and_decode_match_reference():
    """The paged methods: a group prefill into a shared pool with a dummy
    third row (the engine's reference-shaped block), a chunked span of
    the third slot, and decode unfused, then through the fused tail."""
    jmodel, params, model = lm_pair()
    rng = np.random.default_rng(10)
    n_slots = 3
    jcache = jmodel.init_paged_cache(n_slots, N_BLOCKS, BS)
    cache = model.init_paged_cache(n_slots, N_BLOCKS, BS)

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LM_TOL, rtol=LM_TOL)
        ju = jcache["units"][0]
        for name in ("k_pool", "v_pool"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(ju[name]), atol=LM_TOL,
                                       rtol=LM_TOL)
        np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jcache["t"]))

    s = 9
    toks = rng.integers(3, tokenizer.VOCAB_SIZE, size=(3, s)).astype(np.int32)
    toks[1, :BS] = toks[0, :BS]
    toks[2] = 0
    length = np.array([9, 6, 1], np.int32)
    dest = np.stack([dest_of(0, np.arange(s)), dest_of(1, np.arange(s), skip_entries=1),
                     np.full(s, -1, np.int32)])
    dest[1, 6:] = -1
    jl, jcache = jmodel.prefill_paged(params, jnp.asarray(toks), jcache, jnp.asarray(dest),
                                      jnp.asarray([0, 1, n_slots + 1], jnp.int32),
                                      length=jnp.asarray(length))
    tl, cache = model.prefill_paged(t(toks), cache, t(dest), torch.tensor([0, 1, 0]),
                                    length=t(length), rows=torch.tensor([0, 1]))
    check(jl, tl)
    prompt = rng.integers(3, tokenizer.VOCAB_SIZE, size=11).astype(np.int32)
    for begin, end in ((0, 5), (5, 11)):
        span = np.zeros((1, 6), np.int32)
        span[0, :end - begin] = prompt[begin:end]
        d = np.full((1, 6), -1, np.int32)
        d[0, :end - begin] = dest_of(2, np.arange(begin, end))
        args = (TABLES[2:3], d, np.array([2], np.int32), np.array([begin], np.int32),
                np.array([end - begin], np.int32))
        jl, jcache = jmodel.prefill_chunk_paged(params, jnp.asarray(span), jcache,
                                                *map(jnp.asarray, args))
        tl, cache = model.prefill_chunk_paged(t(span), cache, *map(t, args))
        check(jl, tl)
    for step, fused in enumerate((False, False, True, True)):
        active = np.array([True, step >= 2, True])
        tok = rng.integers(3, tokenizer.VOCAB_SIZE, size=(n_slots,)).astype(np.int32)
        jl, jcache = jmodel.decode_step_paged(params, jnp.asarray(tok), jcache,
                                              jnp.asarray(TABLES), jnp.asarray(active),
                                              fused_tail=fused)
        tl, cache = model.decode_step_paged(t(tok), cache, t(TABLES), t(active),
                                            fused_tail=fused)
        check(jl, tl)


# ---------------------------------------------------------------------------
# rows that see no key: the plain version's value, which the card's MoE
# calls restore after the kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 6], ids=["full", "window"])
def test_empty_rows_get_the_plain_versions_value(window):
    """``ops._empty_rows`` flags exactly the rows whose plain attention
    sees no key (a free slot's unbound table, a padded query at -1, a
    window past the bound entries), and ``ops._gathered_mean`` is the
    plain version's output there (its uniform softmax over every gathered
    row: V averaged, an unbound entry reading block 0), in f32 and bf16."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(11)
    n, bs, hkv, hd, h = 12, 4, 2, 8, 6
    tables = torch.tensor([[3, 7, 1, -1], [-1, -1, -1, -1], [2, 4, -1, -1], [5, 6, 8, 9]],
                          dtype=torch.int32)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        kp, vp = (t(rng.normal(size=(n, bs, hkv, hd)).astype(np.float32)).to(dtype)
                  for _ in range(2))
        q = t(rng.normal(size=(4, 3, h, hd)).astype(np.float32)).to(dtype)
        q_pos = torch.tensor([[0, 5, -1], [3, 4, -1], [7, 20, 30], [-1, 14, 15]],
                             dtype=torch.int32)
        want = ref.paged_prefill_attention(q, kp, vp, tables, q_pos, window=window)
        _, _, key_pos = ref.gather_pool(kp, vp, tables)
        kpos, qp = key_pos[:, None, :], q_pos[..., None]
        seen = (kpos >= 0) & (kpos <= qp) & (qp >= 0)
        if window:
            seen &= kpos > qp - window
        empty = ops._empty_rows(tables, q_pos, bs, window)
        assert torch.equal(empty, ~seen.any(-1))
        assert empty.any() and not empty.all()
        fill = ops._gathered_mean(vp, tables, h, dtype)
        got = torch.where(empty[..., None, None], fill[:, None], want)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol,
                                   rtol=tol)
        # one decode row a slot at t = q_pos[:, 1]: the paged decode's plain version
        tq = q_pos[:, 1].clamp(min=0)
        dwant = ref.paged_decode_attention(q[:, 1], kp, vp, tables, tq, window=window)
        dempty = ops._empty_rows(tables, tq[:, None], bs, window)[:, 0]
        assert dempty[1] and not dempty[0]
        dgot = torch.where(dempty[:, None, None], fill, dwant)
        np.testing.assert_allclose(dgot.float().numpy(), dwant.float().numpy(), atol=tol,
                                   rtol=tol)

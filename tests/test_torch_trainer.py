"""The PyTorch port's trainer path against the live JAX package.

Each piece gets the same inputs on both sides, made with numpy: the PPO
objective and its diagnostics (decoupled and naive), next-token
logprobs, AdamW over several steps with clipping active, the advantage
estimators, Algorithm 1 and the packing (exactly equal), the LM's
training forward over packed segments, and one whole
``PPOTrainer.train_step`` from ``params_from_jax`` of the reference's
init.  Then the engine's weight hand-off, which must copy.  f32
throughout, but for the logits head's gradient in bf16; each tolerance
is stated where it is used.
"""
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
from repro.core import advantages as jadv
from repro.core import batching as jbatching
from repro.core import ppo as jppo
from repro.core.buffer import Trajectory as JaxTrajectory
from repro.core.trainer import PPOTrainer as JaxPPOTrainer
from repro.models.model import build_model as jax_build_model
from repro_torch import optim
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core import advantages, batching, ppo
from repro_torch.core.buffer import ReplayBuffer, Trajectory
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.core.trainer import PPOTrainer
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

# a trainer step: 8 trajectories in two GRPO groups, micro-batches of at
# most 48 tokens in two PPO minibatches; lr 1e-3 so that an update is far
# above f32 rounding of the weights
RL = dict(batch_size=8, answers_per_prompt=4, ppo_minibatches=2, microbatch_token_budget=48,
          lr=1e-3, warmup_proportion=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread each, so this file does not
    crowd the processes that other test files run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    key = lambda p: str(getattr(p, "key", getattr(p, "idx", p)))
    return {"/".join(key(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def configs(**kw):
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE, **kw)
    return (dataclasses.replace(jax_reduced(jax_config("areal-qwen-1.5b")), **kw),
            dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")), **kw))


def models(seed=3, **kw):
    jcfg, tcfg = configs(**kw)
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(seed))
    return jmodel, params, tcfg, params_from_jax(tcfg, flat_params(params), device="cpu")


def trajectories(seed=0, n=8, group=4, vocab=tokenizer.VOCAB_SIZE):
    """``n`` trajectories in groups of ``group``; rewards 0/1, both in each
    group; one carries an environment's per-token loss mask."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rlen = int(rng.integers(3, 20))
        out.append(dict(rid=i, prompt_id=i // group,
                        prompt_tokens=rng.integers(3, vocab, int(rng.integers(4, 12))).tolist(),
                        response_tokens=rng.integers(3, vocab, rlen).tolist(),
                        behav_logprobs=(-4 * rng.random(rlen)).tolist(),
                        versions=[0] * rlen, behavior_version=int(rng.integers(0, 2)),
                        reward=float(i % 2)))
    n5 = len(out[5]["response_tokens"])
    out[5]["meta"] = {"loss_mask": [float(x) for x in rng.integers(0, 2, n5)]}
    return out


# ---------------------------------------------------------------------------
# PPO objective
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decoupled", [True, False], ids=["decoupled", "naive"])
def test_ppo_loss_and_diagnostics_match(decoupled):
    rng = np.random.default_rng(1)
    shape = (3, 17)
    new, behav, prox = (-3 * rng.random(shape, dtype=np.float32) for _ in range(3))
    adv = rng.standard_normal(shape, dtype=np.float32)
    mask = (rng.random(shape) < 0.7).astype(np.float32)
    kw = dict(clip_eps=0.2, decoupled=decoupled, ratio_clip=1.5)   # the ratio clip bites
    jloss, jdiag = jppo.ppo_loss(*(jnp.asarray(x) for x in (new, behav, prox, adv, mask)), **kw)
    jgrad = jax.grad(lambda x: jppo.ppo_loss(x, behav, prox, adv, mask, **kw)[0])(
        jnp.asarray(new))
    tnew = torch.from_numpy(new).requires_grad_(True)
    loss, diag = ppo.ppo_loss(tnew, *(torch.from_numpy(x) for x in (behav, prox, adv, mask)),
                              **kw)
    loss.backward()
    # f32, sums of 51 terms: 1e-6
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tnew.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-8)
    assert set(diag) == set(jdiag)
    for k in diag:
        np.testing.assert_allclose(diag[k].item(), float(jdiag[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_next_token_logprobs_match():
    rng = np.random.default_rng(2)
    logits = 3 * rng.standard_normal((2, 9, 40), dtype=np.float32)
    tokens = rng.integers(0, 40, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.5).astype(np.float32)
    for m in (None, mask):
        want = jppo.next_token_logprobs(jnp.asarray(logits), jnp.asarray(tokens),
                                        None if m is None else jnp.asarray(m))
        got = ppo.next_token_logprobs(torch.from_numpy(logits), torch.from_numpy(tokens),
                                      None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_matches_over_steps_with_clipping():
    """Five steps, warmup over three, weight decay, a clip that bites on
    every step.  f32 on both sides: the parameters agree within 1e-6 and
    m, v and the norms within 1e-5 relative."""
    rng = np.random.default_rng(3)
    shapes = [(5, 7), (7,), (3, 4, 2)]
    params = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    cfg = dict(lr=1e-2, beta1=0.9, beta2=0.95, eps=1e-5, weight_decay=0.05, grad_clip=0.5,
               warmup_steps=3)
    jp, js = list(map(jnp.asarray, params)), joptim.init_state(list(map(jnp.asarray, params)))
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = optim.init_state(tp)
    for step in range(5):
        grads = [rng.standard_normal(s, dtype=np.float32) * (step + 1) for s in shapes]
        jp, js, jm = joptim.apply_updates(joptim.AdamConfig(**cfg), jp,
                                          list(map(jnp.asarray, grads)), js)
        tm = optim.apply_updates(optim.AdamConfig(**cfg), tp,
                                 [torch.from_numpy(g) for g in grads], ts)
        assert float(jm["grad_norm"]) > cfg["grad_clip"]
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-7)
        for a, b, m, jm_, v, jv in zip(tp, jp, ts["m"], js["m"], ts["v"], js["v"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(m.numpy(), np.asarray(jm_), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-7)
    assert ts["step"] == int(js["step"]) == 5
    grads = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    got, norm = optim.clip_by_global_norm([torch.from_numpy(g) for g in grads], 0.5)
    want, jnorm = joptim.clip_by_global_norm(list(map(jnp.asarray, grads)), 0.5)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)


def test_adamw_keeps_bf16_weights_with_f32_state():
    p = torch.ones(4, dtype=torch.bfloat16)
    state = optim.init_state([p])
    g = torch.full((4,), 0.5, dtype=torch.bfloat16)
    optim.apply_updates(optim.AdamConfig(lr=0.1), [p], [g], state)
    assert p.dtype == torch.bfloat16 and state["m"][0].dtype == torch.float32
    assert torch.all(p < 1)


# ---------------------------------------------------------------------------
# advantages, batching, packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("estimator", ["grpo", "rloo", "mc"])
def test_group_advantages_match(estimator):
    rng = np.random.default_rng(4)
    rewards = rng.integers(0, 2, 12).astype(np.float32) * 5
    groups = np.repeat(np.arange(4), 3)
    groups[-1] = 9                              # a group of one
    want = jadv.group_advantages(rewards, groups, estimator)
    got = advantages.group_advantages(rewards, groups, estimator)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(advantages.normalize_global(got), jadv.normalize_global(want))


def test_batching_and_packing_agree_exactly():
    rng = np.random.default_rng(5)
    for _ in range(40):
        lens = rng.integers(1, 30, int(rng.integers(1, 14))).tolist()
        cap, kmin = int(rng.integers(30, 80)), int(rng.integers(1, 4))
        assert batching.dynamic_batching(lens, cap, kmin) == jbatching.dynamic_batching(
            lens, cap, kmin)
        n = int(rng.integers(1, 5))
        assert batching.static_batching(lens, n) == jbatching.static_batching(lens, n)
        seqs = [{"tokens": rng.integers(0, 50, n_).tolist(),
                 "loss_mask": rng.integers(0, 2, n_).astype(float).tolist(),
                 "behav_logprob": (-rng.random(n_)).tolist(),
                 "advantage": float(rng.standard_normal())} for n_ in lens]
        rows = int(rng.integers(0, 3))
        got, want = (mod.pack_sequences(seqs, 30, rows=rows) for mod in (batching, jbatching))
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))
        assert got.n_tokens == want.n_tokens and got.padding_fraction == want.padding_fraction
    with pytest.raises(ValueError):
        batching.pack_sequences([{"tokens": [1] * 31}], 30)


def test_replay_buffer_pops_oldest_first():
    buf = ReplayBuffer()
    for i, v in enumerate([2, 0, 1, 0]):
        buf.add(Trajectory(rid=i, prompt_id=0, prompt_tokens=[1], response_tokens=[2],
                           behav_logprobs=[-1.0], versions=[v], behavior_version=v))
    assert [t.rid for t in buf.pop_batch(3)] == [1, 3, 2]
    assert buf.pop_batch(2) is None and len(buf) == 1


# ---------------------------------------------------------------------------
# the logits head in bf16: an f32 result, and gradients of the f32 cotangent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tie", [False, True], ids=["head", "tied"])
def test_bf16_logits_head_gradient_matches_jax_grad(tie):
    """bf16 hidden states and weights, f32 logits: the reference's
    transpose takes its products from the f32 cotangent and casts the
    sums to bf16.  The port's gradients must be those sums' bf16 roundings:
    at most one bf16 spacing off (or 1e-6, where a sum of O(1) terms
    cancels to near zero and f32 rounds it), and equal on all but 1% of
    entries (summation order flips a rounding now and then: 1 of dx's 768
    here; a cotangent rounded to bf16 first moves about half of them).
    The vocab of 20 000 spans two column blocks, the second ragged."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    rng = np.random.default_rng(11)
    t, d, vocab = 24, 32, 20000
    x = jnp.asarray(rng.standard_normal((t, d), dtype=np.float32), jnp.bfloat16)
    w = jnp.asarray(0.1 * rng.standard_normal((d, vocab), dtype=np.float32), jnp.bfloat16)
    cot = rng.standard_normal((t, vocab), dtype=np.float32)

    def head(x, w):
        embed, hw = ({"table": w.T}, None) if tie else (None, {"w": w})
        return jlayers.unembed_apply(embed, hw, x, tie)

    jout, vjp = jax.vjp(head, x, w)
    jdx, jdw = vjp(jnp.asarray(cot))
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
              .requires_grad_(True) for a in (x, w))
    table, hw = (tw.t(), None) if tie else (None, tw)
    out = layers.unembed_apply(table, hw, tx, tie)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-5)
    out.backward(torch.from_numpy(cot))
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= np.maximum(spacing, 1e-6)).all()
        assert (got != want).mean() <= 1e-2


# ---------------------------------------------------------------------------
# the LM's training forward
# ---------------------------------------------------------------------------

def _packed_rows(seed, vocab, rows=2, length=40):
    rng = np.random.default_rng(seed)
    seqs = [{"tokens": rng.integers(3, vocab, int(n)).tolist(), "loss_mask": [1.0] * int(n),
             "behav_logprob": [0.0] * int(n), "advantage": 0.0}
            for n in rng.integers(5, 25, 5)]
    return batching.pack_sequences(seqs, length, rows=rows)


@pytest.mark.parametrize("window", [0, 6], ids=["attn", "swa"])
def test_training_forward_matches_over_packed_segments(window):
    """Logits of the packed rows (segments, -1 padding, per-segment
    positions) and the aux scalars: 1e-4, f32 over two layers."""
    kw = dict(block_pattern=("swa",), sliding_window=window) if window else {}
    jmodel, params, tcfg, model = models(seed=4, **kw)
    pb = _packed_rows(6, tcfg.vocab_size)
    jlogits, jaux = jmodel.forward(params, jnp.asarray(pb.tokens),
                                   positions=jnp.asarray(pb.positions),
                                   segment_ids=jnp.asarray(pb.segment_ids))
    logits, aux = model.forward(torch.from_numpy(pb.tokens),
                                positions=torch.from_numpy(pb.positions),
                                segment_ids=torch.from_numpy(pb.segment_ids))
    assert logits.shape == (2, 40, tcfg.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for k in jaux:
        assert aux[k].item() == float(jaux[k]) == 0.0
    hidden, _ = model.hidden_states(torch.from_numpy(pb.tokens),
                                    positions=torch.from_numpy(pb.positions),
                                    segment_ids=torch.from_numpy(pb.segment_ids))
    assert torch.equal(model.logits(hidden), logits)


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_step():
    """The reference and the port, from the same init, each take one
    train_step over the same trajectories.  Also the gradients of the
    first micro-batch's loss, before any update."""
    jmodel, params, tcfg, model = models()
    data = trajectories(vocab=tcfg.vocab_size)
    jt = JaxPPOTrainer(jmodel, JaxRLConfig(**RL), params)
    tt = PPOTrainer(model, RLConfig(**RL))

    jbatch = [JaxTrajectory(**d) for d in data]
    jmb = jt._pack_microbatches(jt._prepare(jbatch))[0]
    jmb["prox_logprob"] = jt._jit_logprobs(params, jmb)
    (_, _), jgrads = jt._jit_grad(params, jmb)
    mb = tt._pack_microbatches(tt._prepare([Trajectory(**d) for d in data]))[0]
    with torch.no_grad():
        mb["prox_logprob"] = tt._forward_logprobs(mb)[0]
    tt._loss(mb)[0].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None

    jmet = jt.train_step(jbatch, current_version=2)
    tmet = tt.train_step([Trajectory(**d) for d in data], current_version=2)
    return dict(tcfg=tcfg, jt=jt, tt=tt, jmet=jmet, tmet=tmet, model=model,
                grads=grads, jgrads=params_from_jax(tcfg, flat_params(jgrads), device="cpu"))


def test_train_step_metrics_match(one_step):
    """Loss and every diagnostic within 1e-5 relative (f32; sums in
    another order); the counts exactly."""
    jmet, tmet = one_step["jmet"], one_step["tmet"]
    assert tmet.n_microbatches == jmet.n_microbatches > 2
    for f in ("version", "n_tokens", "staleness_max", "reward_mean", "seq_len_mean",
              "staleness_mean"):
        assert getattr(tmet, f) == getattr(jmet, f), f
    np.testing.assert_allclose(tmet.loss, jmet.loss, rtol=1e-5, atol=1e-7)
    assert set(tmet.diag) == set(jmet.diag)
    for k in jmet.diag:
        np.testing.assert_allclose(tmet.diag[k], jmet.diag[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert len(one_step["tt"].opt_metrics) == RL["ppo_minibatches"]


def test_train_step_gradients_match(one_step):
    """The first micro-batch's gradients, before Adam: 1e-5 of each
    tensor's largest entry (f32 sums over the batch in another order)."""
    want = dict(one_step["jgrads"].named_parameters())
    for name, g in one_step["grads"].items():
        w = want[name].detach()
        scale = w.abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_train_step_updates_match(one_step):
    """Updated weights, mapped through ``params_from_jax``.  Adam's first
    step moves each weight by about lr·sign(g); where |g| is near Adam's
    eps (1e-5) the step is sensitive to g, so rounding of g moves it by a
    small part of lr.  Tolerance: 1e-3 · lr absolute."""
    tcfg = one_step["tcfg"]
    new = params_from_jax(tcfg, flat_params(one_step["jt"].params), device="cpu")
    lr = RL["lr"]
    moved = 0.0
    for (name, a), b in zip(one_step["model"].named_parameters(), new.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=0, atol=1e-3 * lr,
                                   err_msg=name)
    jmodel, params, _, init = models()
    for a, b in zip(one_step["model"].parameters(), init.parameters()):
        moved = max(moved, (a.detach() - b).abs().max().item())
    assert moved > 0.5 * lr


def test_train_step_in_bf16_keeps_f32_optimizer_state():
    _, _, tcfg, model = models()
    model = model.to(torch.bfloat16)
    tt = PPOTrainer(model, RLConfig(**RL))
    met = tt.train_step([Trajectory(**d) for d in trajectories(seed=1, vocab=tcfg.vocab_size)])
    assert np.isfinite(met.loss) and all(np.isfinite(v) for v in met.diag.values())
    assert all(p.dtype == torch.bfloat16 and p.grad is None for p in model.parameters())
    assert all(m.dtype == torch.float32 for m in tt.opt_state["m"])
    assert all(np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0 for m in tt.opt_metrics)


# ---------------------------------------------------------------------------
# the engine's weight hand-off
# ---------------------------------------------------------------------------

def _engine_logits(engine):
    """Logits of a fixed prompt under the engine's current weights."""
    cache = engine.model.init_cache(1, 8)
    logits, _ = engine.model.prefill(torch.tensor([[5, 9, 13, 2]]), cache)
    return logits


def test_engine_copies_the_trainers_weights():
    _, _, tcfg, model = models()
    serving = build_model(tcfg, device="cpu")
    serving.load_state_dict(model.state_dict())
    engine = RolloutEngine(serving, EngineConfig(n_slots=2, prompt_len=8, max_gen_len=4),
                           device="cpu")
    tt = PPOTrainer(model, RLConfig(**RL))
    tt.train_step([Trajectory(**d) for d in trajectories(vocab=tcfg.vocab_size)])
    assert engine.update_weights(tt.params, 1)
    assert engine.model is serving and engine.version == 1
    for a, b in zip(engine.model.parameters(), model.parameters()):
        assert torch.equal(a, b.detach())
    handed = _engine_logits(engine)
    with torch.no_grad():                      # the trainer's next in-place step
        for p in model.parameters():
            p.mul_(1.5)
    assert torch.equal(_engine_logits(engine), handed)


def test_deferred_update_applies_the_weights_of_call_time():
    _, _, tcfg, model = models()
    serving = build_model(tcfg, device="cpu")
    serving.load_state_dict(model.state_dict())
    engine = RolloutEngine(serving, EngineConfig(n_slots=2, prompt_len=8, max_gen_len=4),
                           device="cpu")
    engine.admit([{"rid": 0, "prompt": [4, 5, 6], "answer": None}])
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.1)
    want = [p.detach().clone() for p in model.parameters()]
    assert not engine.update_weights(model, 1, interruptible=False)
    with torch.no_grad():                      # changed after the call: must not reach it
        for p in model.parameters():
            p.mul_(2.0)
    while engine.n_active:
        engine.step()
    assert engine.maybe_apply_pending() and engine.version == 1
    for a, b in zip(engine.model.parameters(), want):
        assert torch.equal(a, b)

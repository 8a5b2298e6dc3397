"""The RG-LRU hybrid's training path in the PyTorch port, against the live
JAX package.

The model is the reduced recurrentgemma-9b (pattern ``("rec", "local")``,
d 256, MQA at head_dim 64) with its local window set to 8 on both sides,
so that the window bites inside a 48-token micro-batch.  The reference
initialises the weights and ``params_from_jax`` loads them; inputs are
made with numpy.  f32 throughout; the CPU routes are the plain versions
(the scan's gradient by ``torch.autograd`` of ``ref.linear_scan``).

  * packed rows equal separate rows within 2e-3 (as
    ``tests/test_models.py::test_packed_equals_separate``: the conv's
    taps and the scan restart at each segment), and the port's packed
    hidden states equal the reference's within 1e-4;
  * one ``PPOTrainer.train_step`` against the JAX trainer, at the
    tolerances of ``tests/test_torch_trainer.py``'s dense test: metrics
    1e-5 relative, the first micro-batch's gradients 1e-5 of each
    tensor's largest entry, the updated weights 1e-3·lr (1e-2·lr for the
    few entries whose Adam step saw a gradient below Adam's eps);
  * the scan's gradient kernel's decomposition (``span_scan_bwd``, the
    kernel's order of operations) against ``torch.autograd`` of the plain
    scan: with h0, resets (a = 0) and masked (identity) steps, 1e-6 of
    each gradient's largest entry;
  * ``run_training("recurrentgemma-9b", cache="paged",
    fused_decode="fused", steps=2)`` against the reference's run from the
    same init under the reference's Gumbel noise: StepLog by StepLog,
    integer fields equal, the loss within 1e-5, the virtual clock within
    1e-9 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import RLConfig as JaxRLConfig
from repro.core.buffer import Trajectory as JaxTrajectory
from repro.core.trainer import PPOTrainer as JaxPPOTrainer
from repro.launch.train import run_training as jax_run_training
from repro.models.model import build_model as jax_build_model
from repro_torch import optim
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core.buffer import Trajectory
from repro_torch.core.trainer import PPOTrainer
from repro_torch.data import tokenizer
from repro_torch.kernels import ref
from repro_torch.kernels.linear_scan import span_scan_bwd
from repro_torch.launch.train import run_training
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import apply_updates

# test_torch_trainer.py's trainer step: two GRPO groups of 4, micro-batches
# of at most 48 tokens in two PPO minibatches, lr 1e-3
RL = dict(batch_size=8, answers_per_prompt=4, ppo_minibatches=2, microbatch_token_budget=48,
          lr=1e-3, warmup_proportion=0.0)
WINDOW = 8
INT_FIELDS = ("version", "n_tokens", "gen_tokens_total", "interruptions", "staleness_max")


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


def models(seed=3):
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE, local_window=WINDOW)
    jcfg = dataclasses.replace(jax_reduced(jax_config("recurrentgemma-9b")), **kw)
    tcfg = dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")), **kw)
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(seed))
    return jmodel, params, tcfg, params_from_jax(tcfg, flat_params(params), device="cpu")


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# the packed forward
# ---------------------------------------------------------------------------

def test_packed_equals_separate_and_the_reference():
    """Two sequences of 14 packed into one row score as two separate rows
    (2e-3, the reference's own test's tolerance), and the packed hidden
    states, with a -1 padding tail, equal the reference's (1e-4)."""
    jmodel, params, tcfg, model = models(seed=5)
    rng = np.random.default_rng(1)
    s1, s2 = (rng.integers(3, tcfg.vocab_size, (1, 14)) for _ in range(2))
    packed = np.concatenate([s1, s2, np.zeros((1, 4), np.int64)], axis=1)
    seg = np.array([[0] * 14 + [1] * 14 + [-1] * 4], np.int32)
    pos = np.array([list(range(14)) * 2 + [0] * 4], np.int32)
    with torch.no_grad():
        hp, _ = model.hidden_states(t(packed), positions=t(pos), segment_ids=t(seg))
        h1, _ = model.hidden_states(t(s1))
        h2, _ = model.hidden_states(t(s2))
    np.testing.assert_allclose(hp[:, :14].numpy(), h1.numpy(), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(hp[:, 14:28].numpy(), h2.numpy(), atol=2e-3, rtol=2e-3)
    jh, _ = jmodel.hidden_states(params, jnp.asarray(packed), positions=jnp.asarray(pos),
                                 segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(hp.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------

def trajectories(seed=0, n=8, group=4, vocab=tokenizer.VOCAB_SIZE):
    """``n`` trajectories in groups of ``group``, rewards 0/1 in each
    group, lengths that pack 2-4 to a 48-token micro-batch."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = i // group
        prompt = np.random.default_rng(100 + g).integers(3, vocab, 6 + g).tolist()
        resp = rng.integers(3, vocab, int(rng.integers(4, 14))).tolist()
        out.append(dict(rid=i, prompt_id=g, prompt_tokens=prompt, response_tokens=resp,
                        behav_logprobs=(-rng.uniform(0.5, 3.0, len(resp))).tolist(),
                        versions=[1] * len(resp), reward=float(i % 2), behavior_version=1))
    return out


@pytest.fixture(scope="module")
def one_step():
    """Both trainers from one init over the same trajectories: the first
    micro-batch's gradients before any update, then one train_step."""
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
    # where an Adam step's clipped gradient lies below its eps, the step
    # is about lr g / eps: the f32 rounding of g (which the gradient test
    # bounds) moves it by more than elsewhere
    small = [torch.zeros(p.shape, dtype=torch.bool) for p in model.parameters()]

    def recording(cfg, params, grads, state):
        clip = min(1.0, cfg.grad_clip / (optim.global_norm(grads).item() + 1e-12))
        for s, g in zip(small, grads):
            s |= g.float().abs() * clip < cfg.eps
        return apply_updates(cfg, params, grads, state)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optim, "apply_updates", recording)
        tmet = tt.train_step([Trajectory(**d) for d in data], current_version=2)
    return dict(tcfg=tcfg, jt=jt, tmet=tmet, jmet=jmet, model=model, mb=mb, grads=grads,
                small=small, jgrads=params_from_jax(tcfg, flat_params(jgrads), device="cpu"))


def test_train_step_metrics_match(one_step):
    """Loss and every diagnostic within 1e-5 relative; the counts
    exactly; the micro-batches hold packed rows past the window."""
    jmet, tmet = one_step["jmet"], one_step["tmet"]
    assert tmet.n_microbatches == jmet.n_microbatches > 2
    seg = one_step["mb"]["segment_ids"]
    assert seg.shape[1] == RL["microbatch_token_budget"] > WINDOW
    assert all(len(set(row.tolist()) - {-1}) > 1 for row in seg)
    for f in ("version", "n_tokens", "staleness_max", "reward_mean", "seq_len_mean",
              "staleness_mean"):
        assert getattr(tmet, f) == getattr(jmet, f), f
    np.testing.assert_allclose(tmet.loss, jmet.loss, rtol=1e-5, atol=1e-7)
    assert set(tmet.diag) == set(jmet.diag)
    for k in jmet.diag:
        np.testing.assert_allclose(tmet.diag[k], jmet.diag[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_train_step_gradients_match(one_step):
    """The first micro-batch's gradients, the RG-LRU's included (its
    gates, conv, ``lam`` and the scan's inputs), before Adam: 1e-5 of
    each tensor's largest entry."""
    want = dict(one_step["jgrads"].named_parameters())
    assert any(".rec." in name for name in one_step["grads"])
    for name, g in one_step["grads"].items():
        w = want[name].detach()
        scale = w.abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_train_step_updates_match(one_step):
    """Updated weights, mapped through ``params_from_jax``: 1e-3·lr, as
    the dense test, where every Adam step's clipped gradient exceeds
    Adam's eps (1e-5).  Where one does not (a gradient that cancels to
    ~1e-6 over a minibatch: a few embedding entries), the step is about
    lr g / eps, so a rounding difference of g of 1e-8 (1e-5 of the
    largest entry bounds it at ~6e-7) moves the weight by 1e-3·lr: those
    entries are held to 1e-2·lr (the embedding rows of tokens absent from
    the batch, whose gradient is 0, among them: they agree exactly)."""
    new = params_from_jax(one_step["tcfg"], flat_params(one_step["jt"].params), device="cpu")
    lr = RL["lr"]
    for (name, a), b, small in zip(one_step["model"].named_parameters(), new.parameters(),
                                   one_step["small"]):
        diff = (a.detach() - b).abs()
        assert diff[~small].max().item() <= 1e-3 * lr, name
        if small.any():
            assert diff[small].max().item() <= 1e-2 * lr, name


# ---------------------------------------------------------------------------
# the scan's gradient: the kernel's order of operations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("warps,steps", [(8, 4), (16, 8)], ids=["W8L4", "W16L8"])
@pytest.mark.parametrize("b,s,c", [(2, 1, 5), (1, 31, 8), (2, 70, 12), (1, 300, 6)])
def test_scan_reverse_decomposition_matches_autograd(b, s, c, warps, steps, with_h0):
    """``span_scan_bwd`` (reverse-time spans with the coefficients shifted
    by one step, then da = dh h_{t-1} and dh0 = a_0 dh_0) against
    autograd of ``ref.linear_scan``: resets at a slice's and a span's
    first step and mid-slice, masked steps (a = 1, x = 0) after them,
    upstream gradients on h and h_last; 1e-6 of each gradient's largest
    entry (f32, sums in another order)."""
    rng = np.random.default_rng(s + c)
    a = rng.uniform(0.5, 1.0, (b, s, c)).astype(np.float32)
    a[:, [i for i in (0, 3, 32, 41, 64, 130) if i < s]] = 0.0
    mask = rng.random((b, s)) < 0.2
    a[mask] = 1.0
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    x[mask] = 0.0
    h0 = rng.normal(size=(b, c)).astype(np.float32) if with_h0 else None
    g = rng.normal(size=(b, s, c)).astype(np.float32)
    g_last = rng.normal(size=(b, c)).astype(np.float32)
    ta, tx = t(a).requires_grad_(), t(x).requires_grad_()
    th0 = None if h0 is None else t(h0).requires_grad_()
    h, h_last = ref.linear_scan(ta, tx, th0)
    torch.autograd.backward((h, h_last), (t(g), t(g_last)))
    da, dx, dh0 = span_scan_bwd(t(a), h.detach(), None if h0 is None else t(h0), t(g),
                                t(g_last), warps=warps, steps=steps)
    want = [ta.grad, tx.grad] + ([] if th0 is None else [th0.grad])
    assert (dh0 is None) == (h0 is None)
    for name, got, w in zip(("da", "dx", "dh0"), (da, dx, dh0), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * max(1.0, w.abs().max().item()), err_msg=name)


# ---------------------------------------------------------------------------
# the loop: the paged engine with the fused tail, the hybrid's trainer
# ---------------------------------------------------------------------------

def gumbel_of(seed):
    """The reference engine's Gumbel noise: key fold_in(key(seed), step)
    per step, or fold_in(fold_in(key(seed), rid), draw) per request."""
    key = jax.random.key(seed)

    def noise(*args):
        *ids, shape = args
        k = key
        for i in ids:
            k = jax.random.fold_in(k, i)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    return noise


LOOP = dict(steps=2, batch_size=8, answers_per_prompt=4, n_slots=8, seed=1, log_every=1 << 30,
            final_eval=False, cache="paged", fused_decode="fused")


@pytest.fixture(scope="module")
def loops():
    ref_ctl, _, _ = jax_run_training("recurrentgemma-9b", **LOOP)
    jcfg = dataclasses.replace(jax_reduced(jax_config("recurrentgemma-9b")),
                               vocab_size=tokenizer.VOCAB_SIZE)
    jcfg = dataclasses.replace(jcfg, name=jcfg.name + "-math")
    tcfg = dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")),
                               vocab_size=tokenizer.VOCAB_SIZE)
    tcfg = dataclasses.replace(tcfg, name=tcfg.name + "-math")
    # the reference's run_training initialises its params this way
    params = jax_build_model(jcfg, remat=False).init(jax.random.key(LOOP["seed"]))
    model = params_from_jax(tcfg, flat_params(params), device="cpu")
    ctl, trainer, _ = run_training("recurrentgemma-9b", device="cpu", model=model,
                                   noise=gumbel_of(LOOP["seed"]), **LOOP)
    return ref_ctl, ctl, trainer


def test_run_training_hybrid_paged_fused_integer_fields_match(loops):
    ref_ctl, ctl, trainer = loops
    eng = ctl.engine
    assert (eng.cache_mode, eng.fused_decode) == ("paged", "fused")
    assert "rec" in eng.model.kinds and trainer.version == LOOP["steps"]
    got = [tuple(getattr(h, f) for f in INT_FIELDS) for h in ctl.history]
    want = [tuple(getattr(h, f) for f in INT_FIELDS) for h in ref_ctl.history]
    assert got == want and len(got) == LOOP["steps"]
    assert [(h.reward_mean, h.accuracy) for h in ctl.history] == \
        [(h.reward_mean, h.accuracy) for h in ref_ctl.history]


def test_run_training_hybrid_paged_fused_loss_and_clock_match(loops):
    ref_ctl, ctl, _ = loops
    np.testing.assert_allclose([h.loss for h in ctl.history],
                               [h.loss for h in ref_ctl.history], rtol=0, atol=1e-5)
    for got, want in zip(ctl.history, ref_ctl.history, strict=True):
        assert got.clock == pytest.approx(want.clock, rel=1e-9, abs=0)


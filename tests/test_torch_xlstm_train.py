"""The xLSTM's training path in the PyTorch port, against the live JAX
package.

The model is the reduced xlstm-1.3b (pattern ``("mlstm", "slstm")``, d
256, 4 heads: the mLSTM's head_dim 128) with the math task's vocabulary.
The reference initialises the weights and ``params_from_jax`` loads them;
inputs are made with numpy; f32 throughout.

  * the gradient of a packed row longer than ``MLSTM_CHUNK_THRESHOLD``
    (the chunkwise mLSTM with its closed forget gates at segment starts,
    the sLSTM's loop reset there; the training form of 6144-token rows)
    against ``jax.grad``, 1e-4 of each tensor's largest entry;
  * one ``PPOTrainer.train_step`` against the JAX trainer, at the
    tolerances of ``tests/test_torch_trainer.py``'s dense test: metrics
    1e-5 relative, the first micro-batch's gradients 1e-5 of each
    tensor's largest entry, the updated weights 1e-3·lr (1e-2·lr for the
    entries whose Adam step saw a gradient below Adam's eps);
  * ``run_training("xlstm-1.3b", steps=2)`` against the reference's run
    from the same init under the reference's Gumbel noise: StepLog by
    StepLog, integer fields equal, the loss within 1e-5, the virtual clock
    within 1e-9 relative.
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
from repro_torch.launch.train import run_training
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import MLSTM_CHUNK_THRESHOLD
from repro_torch.optim import apply_updates

RL = dict(batch_size=8, answers_per_prompt=4, ppo_minibatches=2, microbatch_token_budget=48,
          lr=1e-3, warmup_proportion=0.0)
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
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE)
    jcfg = dataclasses.replace(jax_reduced(jax_config("xlstm-1.3b")), **kw)
    tcfg = dataclasses.replace(reduced(get_model_config("xlstm-1.3b")), **kw)
    jmodel = jax_build_model(jcfg, remat=False)
    params = jmodel.init(jax.random.key(seed))
    return jmodel, params, tcfg, params_from_jax(tcfg, flat_params(params), device="cpu")


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_packed_long_row_gradients_match_jax_grad():
    """A packed row of three segments and a padding tail, past the
    chunkwise threshold: the gradient of sum(hidden * g), g a fixed
    random tensor, for every parameter (mean(hidden^2) of a LayerNorm's
    output hardly depends on its input: its gradient is rounding noise)."""
    jmodel, params, tcfg, model = models(seed=4)
    rng = np.random.default_rng(0)
    s = MLSTM_CHUNK_THRESHOLD + 24
    lens = [230, 170, 120]
    toks = np.zeros((1, s), np.int32)
    seg = np.full((1, s), -1, np.int32)
    pos = np.zeros((1, s), np.int32)
    o = 0
    for i, n in enumerate(lens):
        toks[0, o:o + n] = rng.integers(3, tcfg.vocab_size, n)
        seg[0, o:o + n], pos[0, o:o + n] = i, np.arange(n)
        o += n
    g = rng.normal(size=(1, s, tcfg.d_model)).astype(np.float32)

    def loss_fn(p):
        h, _ = jmodel.hidden_states(p, jnp.asarray(toks), positions=jnp.asarray(pos),
                                    segment_ids=jnp.asarray(seg))
        return jnp.sum(h.astype(jnp.float32) * jnp.asarray(g))
    jgrads = params_from_jax(tcfg, flat_params(jax.grad(loss_fn)(params)), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    h, _ = model.hidden_states(t(toks), positions=t(pos), segment_ids=t(seg))
    (h.float() * t(g)).sum().backward()
    want = dict(jgrads.named_parameters())
    for name, p in model.named_parameters():
        if name.startswith("head"):
            continue                # not on the hidden states' path
        w = want[name].detach()
        scale = w.abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


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
    jmet, tmet = one_step["jmet"], one_step["tmet"]
    assert tmet.n_microbatches == jmet.n_microbatches > 2
    seg = one_step["mb"]["segment_ids"]
    assert all(len(set(row.tolist()) - {-1}) > 1 for row in seg)
    for f in ("version", "n_tokens", "staleness_max", "reward_mean", "seq_len_mean",
              "staleness_mean"):
        assert getattr(tmet, f) == getattr(jmet, f), f
    np.testing.assert_allclose(tmet.loss, jmet.loss, rtol=1e-5, atol=1e-7)
    assert set(tmet.diag) == set(jmet.diag)
    for k in jmet.diag:
        np.testing.assert_allclose(tmet.diag[k], jmet.diag[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_train_step_gradients_match(one_step):
    """The first micro-batch's gradients, every mLSTM and sLSTM weight
    included, before Adam: 1e-5 of each tensor's largest entry."""
    want = dict(one_step["jgrads"].named_parameters())
    assert any(".cell.r_f" in name for name in one_step["grads"])
    assert any(".cell.wq" in name for name in one_step["grads"])
    for name, g in one_step["grads"].items():
        w = want[name].detach()
        scale = w.abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_train_step_updates_match(one_step):
    """Updated weights: 1e-3·lr where every Adam step's clipped gradient
    exceeds Adam's eps; 1e-2·lr where one does not (a step of about lr g /
    eps moves with the f32 rounding of g)."""
    new = params_from_jax(one_step["tcfg"], flat_params(one_step["jt"].params), device="cpu")
    lr = RL["lr"]
    for (name, a), b, small in zip(one_step["model"].named_parameters(), new.parameters(),
                                   one_step["small"]):
        diff = (a.detach() - b).abs()
        assert diff[~small].max().item() <= 1e-3 * lr, name
        if small.any():
            assert diff[small].max().item() <= 1e-2 * lr, name


def gumbel_of(seed):
    key = jax.random.key(seed)

    def noise(*args):
        *ids, shape = args
        k = key
        for i in ids:
            k = jax.random.fold_in(k, i)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    return noise


LOOP = dict(steps=2, batch_size=8, answers_per_prompt=4, n_slots=8, seed=1, log_every=1 << 30,
            final_eval=False)


@pytest.fixture(scope="module")
def loops():
    ref_ctl, _, _ = jax_run_training("xlstm-1.3b", **LOOP)
    kw = dict(vocab_size=tokenizer.VOCAB_SIZE)
    jcfg = dataclasses.replace(jax_reduced(jax_config("xlstm-1.3b")), **kw)
    jcfg = dataclasses.replace(jcfg, name=jcfg.name + "-math")
    tcfg = dataclasses.replace(reduced(get_model_config("xlstm-1.3b")), **kw)
    tcfg = dataclasses.replace(tcfg, name=tcfg.name + "-math")
    # the reference's run_training initialises its params this way
    params = jax_build_model(jcfg, remat=False).init(jax.random.key(LOOP["seed"]))
    model = params_from_jax(tcfg, flat_params(params), device="cpu")
    ctl, trainer, _ = run_training("xlstm-1.3b", device="cpu", model=model,
                                   noise=gumbel_of(LOOP["seed"]), **LOOP)
    return ref_ctl, ctl, trainer


def test_run_training_xlstm_integer_fields_match(loops):
    ref_ctl, ctl, trainer = loops
    assert {"mlstm", "slstm"} <= set(ctl.engine.model.kinds) and trainer.version == LOOP["steps"]
    got = [tuple(getattr(h, f) for f in INT_FIELDS) for h in ctl.history]
    want = [tuple(getattr(h, f) for f in INT_FIELDS) for h in ref_ctl.history]
    assert got == want and len(got) == LOOP["steps"]
    assert [(h.reward_mean, h.accuracy) for h in ctl.history] == \
        [(h.reward_mean, h.accuracy) for h in ref_ctl.history]


def test_run_training_xlstm_loss_and_clock_match(loops):
    ref_ctl, ctl, _ = loops
    np.testing.assert_allclose([h.loss for h in ctl.history],
                               [h.loss for h in ref_ctl.history], rtol=0, atol=1e-5)
    for got, want in zip(ctl.history, ref_ctl.history, strict=True):
        assert got.clock == pytest.approx(want.clock, rel=1e-9, abs=0)

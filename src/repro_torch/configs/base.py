"""Configuration dataclasses for the AReaL reproduction framework.

Every architecture in the assigned pool is described by a ``ModelConfig``;
the RL system (AReaL itself) by ``RLConfig``; input shapes by
``ShapeConfig``; and the device layout by ``MeshConfig``.  Configs are
frozen dataclasses so they can be hashed into jit static arguments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Block types understood by models/transformer.py
#   "attn"        global causal self-attention (+ MLP)
#   "swa"         sliding-window causal self-attention (+ MLP)
#   "local"       local (windowed) attention used by recurrentgemma (+ MLP)
#   "rec"         RG-LRU recurrent block (+ MLP)
#   "mlstm"       xLSTM matrix-memory block (self-contained, no separate MLP)
#   "slstm"       xLSTM scalar-memory block (self-contained, no separate MLP)
VALID_BLOCKS = ("attn", "swa", "local", "rec", "mlstm", "slstm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 -> full attention (for "swa" blocks)
    local_window: int = 2048          # window for "local" blocks
    qk_norm: bool = False

    # --- normalization / activation ---
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    parametric_norm: bool = True      # False -> OLMo non-parametric LN
    act: str = "swiglu"               # swiglu | geglu | gelu | relu2

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- layer pattern (ssm / hybrid); empty -> homogeneous from family ---
    block_pattern: Tuple[str, ...] = ()

    # --- recurrent (RG-LRU / xLSTM) ---
    lru_width: int = 0                # 0 -> d_model
    conv1d_width: int = 4             # temporal conv in recurrent blocks

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq_len: int = 1500       # post-conv audio frames

    # --- multimodal prefix (vlm / audio stub frontends) ---
    n_prefix_tokens: int = 0          # visual/audio embeddings prepended
    prefix_dim: int = 0               # raw embedding dim before projector

    # --- embeddings ---
    tie_embeddings: bool = False
    max_position_embeddings: int = 524_288

    # --- citation for the assigned pool ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        if not self.block_pattern:
            if self.family in ("dense", "moe", "vlm", "audio"):
                bt = "swa" if self.sliding_window else "attn"
                object.__setattr__(self, "block_pattern", (bt,))
        for b in self.block_pattern:
            assert b in VALID_BLOCKS, f"unknown block type {b}"
        assert self.n_heads % self.n_kv_heads == 0, "GQA requires heads % kv == 0"

    # ---- derived quantities -------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded for clean vocab-parallel sharding (multiple of 512)."""
        return round_up(self.vocab_size, 512)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def pattern_counts(self):
        """(units, remainder) decomposition of n_layers over block_pattern."""
        p = len(self.block_pattern)
        return self.n_layers // p, self.n_layers % p

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_decode(self) -> bool:
        """True when decode state is sub-linear in context (O(1) state or
        bounded attention window) -> eligible for long_500k."""
        blocks = set(self.block_pattern)
        if blocks <= {"mlstm", "slstm", "rec"}:
            return True
        if "attn" in blocks:
            return False
        # windowed-only attention (swa/local, possibly mixed with recurrent)
        return blocks <= {"swa", "local", "rec", "mlstm", "slstm"}

    def param_count(self) -> int:
        """Analytic parameter count (matches init to within norm params)."""
        c = self
        n = 0
        n += c.padded_vocab * c.d_model            # embedding
        if not c.tie_embeddings:
            n += c.padded_vocab * c.d_model        # lm head
        units, rem = self.pattern_counts
        seq = list(self.block_pattern) * units + list(self.block_pattern[:rem])
        for bt in seq:
            n += self._block_params(bt)
        if c.encoder_layers:
            n += c.encoder_layers * self._block_params("attn", causal=False)
            n += c.encoder_layers * self._cross_attn_params()
        if c.n_prefix_tokens and c.prefix_dim:
            n += c.prefix_dim * c.d_model          # projector
        return n

    def _block_params(self, bt: str, causal: bool = True) -> int:
        c = self
        d, q, kv = c.d_model, c.q_dim, c.kv_dim
        n = 0
        if bt in ("attn", "swa", "local"):
            n += d * q + 2 * d * kv + q * d        # qkvo
            n += self._mlp_params()
        elif bt == "rec":
            w = c.lru_width
            n += 2 * d * w + w * d                 # x/gate in, out
            n += c.conv1d_width * w                # temporal conv
            n += 2 * w                             # lru gate params (a, input gate)
            n += 2 * w * w // 8                    # low-rank gate projections
            n += self._mlp_params()
        elif bt == "mlstm":
            pf_inner = 2 * d
            n += 2 * d * pf_inner                  # up (x and gate branches)
            n += pf_inner * d                      # down
            n += 3 * pf_inner * pf_inner // c.n_heads  # q,k,v per-head proj (block diag)
            n += 3 * pf_inner                      # i,f,o gates (per-channel)
            n += c.conv1d_width * pf_inner
        elif bt == "slstm":
            pf = 4 * d // 3
            n += 4 * d * d                         # recurrent gates (i,f,z,o)
            n += d * pf + pf * d                   # ffn up/down
        if c.is_moe and bt in ("attn", "swa", "local"):
            # replace dense MLP with router + experts
            n -= self._mlp_params()
            n += d * c.n_experts                   # router
            n += c.n_experts * self._mlp_params(c.d_ff)
        return n

    def _mlp_params(self, ff: Optional[int] = None) -> int:
        ff = ff or self.d_ff
        if self.act in ("swiglu", "geglu"):
            return 3 * self.d_model * ff
        return 2 * self.d_model * ff

    def _cross_attn_params(self) -> int:
        return self.d_model * self.q_dim + 2 * self.d_model * self.kv_dim + self.q_dim * self.d_model


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_size(self) -> int:
        return self.shape[self.axes.index("model")]

    @property
    def data_size(self) -> int:
        n = 1
        for a, s in zip(self.axes, self.shape):
            if a in ("pod", "data"):
                n *= s
        return n


# ---------------------------------------------------------------------------
# RL (AReaL) configuration — defaults follow paper Table 3
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RLConfig:
    # batching
    batch_size: int = 512             # prompts per PPO step (global batch B)
    answers_per_prompt: int = 16      # group size for GRPO-style baseline
    ppo_minibatches: int = 4

    # staleness-aware training (Section 5.1)
    max_staleness: int = 8            # eta; 0 -> synchronous oracle
    decoupled_objective: bool = True  # Eq. 5 vs naive PPO Eq. 2

    # PPO (Table 3)
    clip_eps: float = 0.2
    gamma: float = 1.0
    gae_lambda: float = 1.0
    advantage_norm: bool = True
    adv_estimator: str = "grpo"       # grpo | gae | rloo
    reward_correct: float = 5.0
    reward_incorrect: float = -5.0

    # optimizer (Table 3)
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    adam_eps: float = 1e-5
    grad_clip: float = 1.0
    warmup_proportion: float = 0.001
    total_steps: int = 250

    # generation
    temperature: float = 1.0
    max_prompt_len: int = 1024
    max_gen_len: int = 27_648

    # system
    train_device_fraction: float = 0.25   # 75/25 rollout/train split (Sec 7.1)
    dynamic_batching: bool = True
    microbatch_token_budget: int = 32_768  # Alg. 1 capacity C
    min_microbatches: int = 1
    interruptible: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig
    rl: RLConfig = field(default_factory=RLConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 1                      # paper Appendix A: fixed seed 1

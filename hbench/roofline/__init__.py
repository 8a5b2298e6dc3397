"""The H100's peaks and the least work each measured call needs.

Peaks: NVIDIA H100 SXM data sheet, dense bfloat16 without sparsity, and
its HBM3 bandwidth (the port's ``launch/roofline.py`` uses the same two
numbers).  A bound counts the operations and bytes that the inputs need,
whatever the kernel does: every input byte read once and every output
byte written once, and the operations of visible (query, key) pairs
only, as the port's kernel table counts them.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

PEAK_FLOPS = 989e12          # bf16 dense, FLOP/s
PEAK_BYTES = 3.35e12         # HBM3, B/s
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(lengths: Iterable[int]) -> int:
    """Visible (query, key) pairs of causal attention within each segment."""
    return sum(n * (n + 1) // 2 for n in lengths)


def flash_forward(cfg: Dict, lengths: Sequence[int]) -> float:
    """One layer's forward over one packed row whose segments have
    ``lengths``: q, k, v read, the output and its log-sum-exp written;
    QK^T and PV over the visible pairs."""
    h, hkv, hd = int(cfg["n_heads"]), int(cfg["n_kv_heads"]), int(cfg["head_dim"])
    t = sum(lengths)
    flops = 4.0 * h * hd * causal_pairs(lengths)
    nbytes = t * hd * (2 * h + 2 * hkv) * BF16 + 4.0 * t * h
    return bound_s(flops, nbytes)


def flash_backward(cfg: Dict, lengths: Sequence[int]) -> float:
    """One layer's backward: q, k, v, out, dout and the log-sum-exp read;
    dq, dk, dv written; five products (S, dP, dV, dQ, dK) over the visible
    pairs."""
    h, hkv, hd = int(cfg["n_heads"]), int(cfg["n_kv_heads"]), int(cfg["head_dim"])
    t = sum(lengths)
    flops = 10.0 * h * hd * causal_pairs(lengths)
    nbytes = t * hd * (4 * h + 4 * hkv) * BF16 + 4.0 * t * h
    return bound_s(flops, nbytes)


def paged_decode(cfg: Dict, contexts: Sequence[int], unique_blocks: int,
                 block_size: int) -> float:
    """One layer's decode attention for slots whose contexts (keys) are
    ``contexts``: each pool block that any of them reads, read once (k and
    v), each query read and each output written once; QK^T and PV over
    every visible key."""
    h, hkv, hd = int(cfg["n_heads"]), int(cfg["n_kv_heads"]), int(cfg["head_dim"])
    b = len(contexts)
    flops = 4.0 * h * hd * sum(contexts)
    nbytes = unique_blocks * block_size * hkv * hd * 2 * BF16 + 2 * b * h * hd * BF16 + 4.0 * b
    return bound_s(flops, nbytes)


def matmul_params(cfg: Dict) -> int:
    """Weights a token multiplies by in one forward pass: every projection,
    the experts it is routed to, and the logits over the real vocabulary."""
    d, hd = int(cfg["d_model"]), int(cfg["head_dim"])
    q, kv, ff = int(cfg["n_heads"]) * hd, int(cfg["n_kv_heads"]) * hd, int(cfg["d_ff"])
    attn = 2 * d * q + 2 * d * kv
    e = int(cfg["n_experts"])
    ffn = (d * e + int(cfg["experts_per_token"]) * 3 * d * ff) if e else 3 * d * ff
    return int(cfg["n_layers"]) * (attn + ffn) + d * int(cfg["vocab_size"])


def attention_flops_per_key(cfg: Dict) -> float:
    """Forward FLOPs of one (query, key) pair over every layer."""
    return 4.0 * int(cfg["n_layers"]) * int(cfg["n_heads"]) * int(cfg["head_dim"])

"""Model weights made from the seed, the same for the program and for the
plain reference.

A configuration's leaves (named as the port's ``LM.named_parameters()``)
take consecutive stretches of one stream of standard normals, drawn on
the device in chunks of ``CHUNK`` values, chunk c from a generator seeded
by (seed, c): a few large calls, and any leaf can be drawn again alone.
Each leaf is its stretch times its scale (normal / sqrt(fan_in); the
embedding 0.02; the experts' down projection 1 / sqrt(d_ff)), cast to the
configuration's dtype; norm scales are ones and take no stretch.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 27


def padded_vocab(cfg: Dict) -> int:
    return -(-int(cfg["vocab_size"]) // 512) * 512


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every weight; scale 0 marks a norm's ones."""
    d, hd = int(cfg["d_model"]), int(cfg["head_dim"])
    q, kv, ff = int(cfg["n_heads"]) * hd, int(cfg["n_kv_heads"]) * hd, int(cfg["d_ff"])
    vp = padded_vocab(cfg)
    out = [("embed.table", (vp, d), 0.02)]
    for i in range(int(cfg["n_layers"])):
        b = f"blocks.{i}."
        out += [(b + "attn_norm.scale", (d,), 0.0),
                (b + "attn.wq", (d, q), d ** -0.5), (b + "attn.wk", (d, kv), d ** -0.5),
                (b + "attn.wv", (d, kv), d ** -0.5), (b + "attn.wo", (q, d), q ** -0.5)]
        if cfg["qk_norm"]:
            out += [(b + "attn.q_norm.scale", (hd,), 0.0), (b + "attn.k_norm.scale", (hd,), 0.0)]
        out.append((b + "mlp_norm.scale", (d,), 0.0))
        e = int(cfg["n_experts"])
        if e:
            out += [(b + "moe.router", (d, e), d ** -0.5),
                    (b + "moe.w_up", (e, d, ff), d ** -0.5),
                    (b + "moe.w_down", (e, ff, d), ff ** -0.5),
                    (b + "moe.w_gate", (e, d, ff), d ** -0.5)]
        else:
            out += [(b + "mlp.w_up", (d, ff), d ** -0.5), (b + "mlp.w_down", (ff, d), ff ** -0.5),
                    (b + "mlp.w_gate", (d, ff), d ** -0.5)]
    out.append(("final_norm.scale", (d,), 0.0))
    if not cfg["tie_embeddings"]:
        out.append(("head.w", (d, vp), d ** -0.5))
    return out


def n_params(cfg: Dict) -> int:
    return sum(math.prod(s) for _, s, _ in leaves(cfg))


def _chunk(seed: int, c: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + c) % (2 ** 63))
    return torch.randn(CHUNK, generator=g, device=device, dtype=torch.float32)


def iter_leaves(cfg: Dict, seed: int, device, dtype) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, value) of every leaf in ``leaves`` order, on ``device`` in
    ``dtype``; one chunk of the stream is held at a time."""
    off, c, buf = 0, -1, None
    for name, shape, scale in leaves(cfg):
        if scale == 0.0:
            yield name, torch.ones(shape, device=device, dtype=dtype)
            continue
        n = math.prod(shape)
        parts = []
        while n:
            if off // CHUNK != c:
                c = off // CHUNK
                buf = _chunk(seed, c, device)
            lo = off - c * CHUNK
            take = min(n, CHUNK - lo)
            parts.append(buf[lo:lo + take])
            off += take
            n -= take
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        yield name, (flat * scale).to(dtype).reshape(shape)


def load_into(model: torch.nn.Module, cfg: Dict, seed: int) -> None:
    """Fill ``model``'s parameters (the port's names) in place."""
    params = dict(model.named_parameters())
    want = {n for n, _, _ in leaves(cfg)}
    if set(params) != want:
        raise RuntimeError(f"the model's parameters differ from the harness's leaves: "
                           f"{sorted(set(params) ^ want)[:8]}")
    with torch.no_grad():
        for name, val in iter_leaves(cfg, seed, params["embed.table"].device,
                                     params["embed.table"].dtype):
            params[name].copy_(val)


def reference_leaves(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The same weights for the reference: the configuration's dtype's
    values, held in float32."""
    dt = getattr(torch, cfg["dtype"])
    return {n: v.float() for n, v in iter_leaves(cfg, seed, device, dt)}

"""Kernel entry points, with the signatures of ``repro/kernels/ops.py``.

Dispatch is by the device of the tensors, not by a global switch: a CPU
tensor goes to the plain PyTorch version in ``ref.py``; a CUDA tensor
goes to the Hopper kernel, or the wrapper raises.  There is no fallback
from the kernel to the plain version.

``LAUNCHES`` counts kernel launches by name, one per call that reached
the kernel, so a run can show that its path went through the kernels.
Two threads launch kernels at once in the threaded runtime (the rollout
thread decodes while the trainer thread trains), so a count is raised
under a lock (``count_launch``): ``+= 1`` on a dict entry is a read and
a write, and two threads between them would lose a count.

``flash_attention`` and ``linear_scan`` are differentiable.  On the CPU
autograd goes through the plain versions; on the card, when an input
needs a gradient, the backward pass launches the backward kernel,
counted as ``"flash_attention_bwd"`` or ``"linear_scan_bwd"``, one per
backward call (the attention forward then also writes each row's
log-sum-exp).

On the ``meta`` device (the dry run, ``launch/dryrun.py``) each op takes
its kernel's meta route (``kernels/meta.py``): the CUDA wrapper's
outputs and scratch, no arithmetic, the kernel's operations and bytes
recorded in the active analysis, and no count in ``LAUNCHES``.  Meta
never takes the plain versions, whose score matrices the kernels never
allocate.

``flash_attention`` and ``linear_scan`` also take DTensors (the sharded
steps under ``launch.mesh.use_mesh``): through ``local_map`` each rank
runs the kernel, or on the CPU the plain version, on its own local
tensors ((B_local, S, H_local, hd); (B_local, S, C_local)), and the
output carries the input's placements (``_sharded_flash``,
``_sharded_scan``).  ``_route`` reads the local tensor's device.

A query row that sees no key (a padded row of a chunked span, a free
slot's decode row) has an output the reference calls unspecified: its
jnp oracle, and so the plain version, averages V over every row the
slot's table gathers, while the paged kernels, as the TPU ones, write 0.
A mixture of experts routes every row, so such a row's value takes
expert capacity from the others.  ``mean_empty_rows=True`` (the MoE
model's calls) gives those rows the plain version's value on the card
too (``_empty_rows``, ``_gathered_mean``), so the card drops what the
CPU drops.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.constraints import on_mesh, reshard
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.fused_decode_tail import fused_decode_tail_cuda
from repro_torch.kernels.linear_scan import linear_scan_bwd_cuda, linear_scan_cuda
from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "paged_prefill_attention": 0, "fused_decode_tail": 0,
            "linear_scan": 0, "linear_scan_bwd": 0}
# (q heads, kv heads) of every local call a sharded route made, by kernel
KERNEL_HEADS = {name: set() for name in LAUNCHES}
# the CPU route switches to the query-chunked oracle above ~1024 x 1024
# scores per (batch, head), as the reference's ops.flash_attention does
_CHUNKED_THRESHOLD = 1024 * 1024


_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            KERNEL_HEADS[name].clear()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``LAUNCHES``."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _route(x) -> str:
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


def _launched(x, name: str) -> None:
    """Count a launch of kernel ``name``, made on ``x``'s device unless
    that is meta."""
    if x.device.type == "cuda":
        count_launch(name)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp saved, and the backward
    kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window, softmax_scale):
        fwd = _meta.flash_attention if q.is_meta else flash_attention_cuda
        out, lse = fwd(q, k, v, segment_ids, causal=causal, window=window,
                       softmax_scale=softmax_scale, return_lse=True)
        _launched(q, "flash_attention")
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.opts = dict(causal=causal, window=window, softmax_scale=softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        bwd = _meta.flash_attention_bwd if q.is_meta else flash_attention_bwd_cuda
        grads = bwd(q, k, v, out, lse, dout.contiguous(), segment_ids, **ctx.opts)
        _launched(q, "flash_attention_bwd")
        return (*grads, None, None, None, None)


def _empty_rows(block_tables, q_pos, block_size: int, window: int = 0):
    """(B, C) bool: the query rows at positions q_pos (B, C) (-1 = padded)
    that see no key through their slot's table (B, E) (-1 = unbound): no
    bound entry holds a position in [q_pos - window + 1, q_pos], or in
    [0, q_pos] without a window."""
    e = block_tables.shape[1]
    first = torch.arange(e, device=q_pos.device) * block_size        # (E,)
    qp = q_pos.long()[..., None]                                     # (B, C, 1)
    seen = (block_tables >= 0)[:, None, :] & (first <= qp) & (qp >= 0)
    if window and window > 0:
        seen &= first + block_size - 1 > qp - window
    return ~seen.any(dim=-1)


def _gathered_mean(v_pool, block_tables, n_heads: int, dtype) -> torch.Tensor:
    """(B, H, hd) in ``dtype``: the plain version's output for a row that
    sees no key.  Its softmax over all-masked scores is uniform, so it is
    V averaged over every row the table gathers (an unbound entry reads
    block 0), each weight 1 / (E bs) rounded to ``dtype`` as the plain
    version rounds its probabilities."""
    n, bs, hkv, _ = v_pool.shape
    e = block_tables.shape[1]
    block_sum = v_pool.sum(dim=1, dtype=torch.float32)               # (N, Hkv, hd)
    total = block_sum[block_tables.clamp(0, n - 1).long()].sum(dim=1)
    w = torch.tensor(1.0 / (e * bs), dtype=torch.float32).to(dtype).float()
    return (total * w).repeat_interleave(n_heads // hkv, dim=1).to(dtype)


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = True,
                    window: int = 0, softmax_scale: Optional[float] = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd); segment_ids: (B, S)
    int32.  Cross-attention (Sq != Sk, the enc-dec decoder over its
    frames) takes the plain route on every device, as the reference keeps
    it on its jnp oracle on every backend (``repro/kernels/ops.py:65-73``):
    there is no TPU kernel of it to port, autograd goes through the plain
    version and nothing is counted in ``LAUNCHES``.  DTensor inputs run
    sharded (``_sharded_flash``)."""
    if isinstance(q, DTensor):
        return _sharded_flash(q, k, v, segment_ids, causal=causal, window=window,
                              softmax_scale=softmax_scale)
    if _route(q) == "cpu" or q.shape[1] != k.shape[1]:
        fn = (_ref.flash_attention_chunked if q.shape[1] * k.shape[1] > _CHUNKED_THRESHOLD
              else _ref.flash_attention)
        return fn(q, k, v, segment_ids=segment_ids, causal=causal, window=window,
                  softmax_scale=softmax_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return _FlashAttention.apply(q, k, v, segment_ids, causal, window, softmax_scale)
    fwd = _meta.flash_attention if q.is_meta else flash_attention_cuda
    out = fwd(q, k, v, segment_ids, causal=causal, window=window, softmax_scale=softmax_scale)
    _launched(q, "flash_attention")
    return out


def head_runs(h0: int, n: int, group: int):
    """The calls of a shard that holds q heads [h0, h0 + n) of a GQA layer
    whose kv heads serve ``group`` q heads each, as (local q lo, local q
    hi, kv lo, kv hi): whole groups in one call; where the shard's range
    starts or ends inside a group (it straddles a kv head) that part is a
    call of its own, so every call has a uniform group and no head is
    reordered."""
    runs, j = [], 0
    while j < n:
        h = h0 + j
        kv = h // group
        if h % group == 0 and n - j >= group:
            m = (n - j) // group
            runs.append((j, j + m * group, kv, kv + m))
            j += m * group
        else:
            end = min(n, (kv + 1) * group - h0)
            runs.append((j, end, kv, kv + 1))
            j = end
    return runs


def _sharded_flash(q, k, v, segment_ids, **opts):
    """``flash_attention`` of DTensors.  The batch stays split where q's
    is; q's heads stay split on one mesh dim where they divide it, and k/v
    follow when their kv heads divide it too, else each rank keeps every
    kv head and hands its kernel only those its q heads use
    (``head_runs``): the kv gradients are then partial sums, reduced as
    ``Partial`` placements.  Any other split (sequence, head_dim, a
    pending ``Partial``) is gathered first."""
    from torch.distributed.tensor.experimental import local_map
    dm = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    qp, kvp, kvg, segp = [], [], [], []
    head_axis = None
    for i, p in enumerate(q.placements):
        n = dm.size(i)
        if isinstance(p, Shard) and p.dim == 0:
            qp.append(p), kvp.append(p), kvg.append(p), segp.append(p)
        elif (isinstance(p, Shard) and p.dim == 2 and hq % n == 0 and head_axis is None):
            head_axis = i
            kv = p if hkv % n == 0 else Replicate()
            qp.append(p), kvp.append(kv), segp.append(Replicate())
            kvg.append(p if hkv % n == 0 else Partial())
        else:
            r = Replicate()
            qp.append(r), kvp.append(r), kvg.append(r), segp.append(r)
    q, k, v = reshard(q, dm, qp), reshard(k, dm, kvp), reshard(v, dm, kvp)
    if segment_ids is not None:
        if not isinstance(segment_ids, DTensor):
            segment_ids = DTensor.from_local(segment_ids, dm, [Replicate()] * dm.ndim,
                                             run_check=False)
        segment_ids = reshard(segment_ids, dm, segp)
    runs = None
    if head_axis is not None and hkv % dm.size(head_axis):
        n = hq // dm.size(head_axis)
        runs = head_runs(dm.get_local_rank(head_axis) * n, n, hq // hkv)

    def local(ql, kl, vl, sl):
        calls = ([(ql, kl, vl)] if runs is None else
                 [(ql[:, :, a:b].contiguous(), kl[:, :, c:d].contiguous(),
                   vl[:, :, c:d].contiguous()) for a, b, c, d in runs])
        with _LAUNCHES_LOCK:
            KERNEL_HEADS["flash_attention"].update((x.shape[2], y.shape[2]) for x, y, _ in calls)
        outs = [flash_attention(x, y, z, sl, **opts) for x, y, z in calls]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)

    segs = None if segment_ids is None else segp
    return local_map(local, out_placements=qp, in_placements=(qp, kvp, kvp, segs),
                     in_grad_placements=(qp, kvg, kvg, segs),
                     device_mesh=dm)(q, k, v, segment_ids)


def decode_attention(q, k_cache, v_cache, cache_pos, t, *, window: int = 0,
                     softmax_scale: Optional[float] = None):
    """q: (B, H, hd); caches: (B, W, Hkv, hd); cache_pos: (B, W) int32
    (-1 = empty); t: (B,) int32.  DTensor inputs run on each rank's rows
    and heads (``_sharded_decode``)."""
    if isinstance(q, DTensor):
        return _sharded_decode("decode_attention", q, (k_cache, v_cache), (cache_pos, t),
                               dict(window=window, softmax_scale=softmax_scale))
    if _route(q) == "cpu":
        return _ref.decode_attention(q, k_cache, v_cache, cache_pos, t, window=window,
                                     softmax_scale=softmax_scale)
    fn = _meta.decode_attention if q.is_meta else decode_attention_cuda
    out = fn(q, k_cache, v_cache, cache_pos, t, window=window, softmax_scale=softmax_scale)
    _launched(q, "decode_attention")
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, t, *, window: int = 0,
                           softmax_scale: Optional[float] = None,
                           mean_empty_rows: bool = False):
    """q: (B, H, hd); pools: (N, bs, Hkv, hd); block_tables: (B, E) int32
    (-1 = unbound); t: (B,) int32.  ``mean_empty_rows``: see the module
    docstring.  DTensor inputs run sharded (``_sharded_decode``)."""
    if isinstance(q, DTensor):
        return _sharded_decode("paged_decode_attention", q, (k_pool, v_pool), (block_tables, t),
                               dict(window=window, softmax_scale=softmax_scale,
                                    mean_empty_rows=mean_empty_rows))
    if _route(q) == "cpu":
        return _ref.paged_decode_attention(q, k_pool, v_pool, block_tables, t, window=window,
                                           softmax_scale=softmax_scale)
    fn = _meta.paged_decode_attention if q.is_meta else paged_decode_attention_cuda
    out = fn(q, k_pool, v_pool, block_tables, t, window=window, softmax_scale=softmax_scale)
    _launched(q, "paged_decode_attention")
    if mean_empty_rows:
        empty = _empty_rows(block_tables, t[:, None], k_pool.shape[1], window)[:, 0]
        fill = _gathered_mean(v_pool, block_tables, q.shape[1], q.dtype)
        out = torch.where(empty[:, None, None], fill, out)
    return out


def fused_decode_tail(q, k_pool, v_pool, wo, block_tables, t, *, window: int = 0,
                      softmax_scale: Optional[float] = None, mean_empty_rows: bool = False):
    """Paged decode attention fused with the output projection: q (B, H,
    hd) against pools (N, bs, Hkv, hd) through block_tables (B, E),
    projected by wo (H*hd, D); returns (B, D).  ``mean_empty_rows``: see
    the module docstring (the mean contexts are projected by ``wo``).
    DTensor inputs run sharded (``_sharded_decode``): ``wo`` row-parallel,
    the output a ``Partial`` sum over the heads' mesh dim."""
    if isinstance(q, DTensor):
        return _sharded_decode("fused_decode_tail", q, (k_pool, v_pool), (block_tables, t),
                               dict(window=window, softmax_scale=softmax_scale,
                                    mean_empty_rows=mean_empty_rows), wo=wo)
    if _route(q) == "cpu":
        return _ref.fused_decode_tail(q, k_pool, v_pool, wo, block_tables, t, window=window,
                                      softmax_scale=softmax_scale)
    fn = _meta.fused_decode_tail if q.is_meta else fused_decode_tail_cuda
    out = fn(q, k_pool, v_pool, wo, block_tables, t, window=window, softmax_scale=softmax_scale)
    _launched(q, "fused_decode_tail")
    if mean_empty_rows:
        b, h, hd = q.shape
        empty = _empty_rows(block_tables, t[:, None], k_pool.shape[1], window)[:, 0]
        fill = torch.matmul(_gathered_mean(v_pool, block_tables, h, q.dtype).reshape(b, h * hd),
                            wo)
        out = torch.where(empty[:, None], fill, out)
    return out


def chunked_prefill_attention(q, k, v, key_pos, q_pos, *, window: int = 0,
                              softmax_scale: Optional[float] = None):
    """q: (B, C, H, hd) at absolute positions q_pos (B, C) (-1 = padded
    row); k, v: (B, S, Hkv, hd) at key_pos (B, S) (-1 = invalid).  The
    ring cache's chunked-prefill attention.  It has no kernel: on every
    device it is the plain version, as the reference keeps it on its jnp
    oracle on every backend (``repro/kernels/ops.py:185-197``), so there
    is no TPU kernel of it to port and nothing is counted in
    ``LAUNCHES``."""
    _route(q)
    return _ref.chunked_prefill_attention(q, k, v, key_pos, q_pos, window=window,
                                          softmax_scale=softmax_scale)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos, *, window: int = 0,
                            softmax_scale: Optional[float] = None,
                            mean_empty_rows: bool = False):
    """q: (B, C, H, hd) at absolute positions q_pos (B, C) (-1 = padded
    row); pools: (N, bs, Hkv, hd); block_tables: (B, E) int32 (-1 =
    unbound).  The chunk's own K/V must already be in the pool.
    ``mean_empty_rows``: see the module docstring.  DTensor inputs run
    sharded (``_sharded_decode``)."""
    if isinstance(q, DTensor):
        return _sharded_decode("paged_prefill_attention", q, (k_pool, v_pool),
                               (block_tables, q_pos),
                               dict(window=window, softmax_scale=softmax_scale,
                                    mean_empty_rows=mean_empty_rows))
    if _route(q) == "cpu":
        return _ref.paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos,
                                            window=window, softmax_scale=softmax_scale)
    fn = _meta.paged_prefill_attention if q.is_meta else paged_prefill_attention_cuda
    out = fn(q, k_pool, v_pool, block_tables, q_pos, window=window, softmax_scale=softmax_scale)
    _launched(q, "paged_prefill_attention")
    if mean_empty_rows:
        empty = _empty_rows(block_tables, q_pos, k_pool.shape[1], window)
        fill = _gathered_mean(v_pool, block_tables, q.shape[2], q.dtype)
        out = torch.where(empty[..., None, None], fill[:, None], out)
    return out


# kernel -> (the plain-tensor entry point, q's head dim, whether the cache
# has the batch's rows as its first dim: the ring cache does, a pool not)
_DECODE_ROUTES = {"decode_attention": ("decode_attention", 1, True),
                  "paged_decode_attention": ("paged_decode_attention", 1, False),
                  "fused_decode_tail": ("fused_decode_tail", 1, False),
                  "paged_prefill_attention": ("paged_prefill_attention", 2, False)}


def _sharded_decode(name: str, q, kv, rows, opts, wo=None):
    """One of the four decode-side kernels on DTensors, through
    ``local_map``: each rank runs the kernel (on the CPU the plain
    version) on its own tensors.  On each mesh dim: where the batch's rows
    are split (q's, or the ring cache's), q, the ring cache and the row
    arguments ``rows`` (positions, tables, t, each (B, ...)) keep that
    split and a pool stays whole (any slot may name any block); where q's
    heads are split, or the cache's kv heads are and q's heads divide
    there, q's heads split and the cache's kv heads follow when the kv
    head count divides too, else each rank keeps every kv head and calls
    the kernel once for each run of its q heads on one group
    (``head_runs``) on a view of those kv heads, which the kernels read in
    place at the cache's row stride (no copy); anything else (a pending
    ``Partial``, a split of time or head_dim) is gathered first.  The
    fused tail's ``wo`` (H * hd, D) is row-parallel there, each run
    projecting by its own rows, and its output a ``Partial`` sum over the
    heads' dim (reduced at the caller's next ``constrain``).  The row
    arguments are the caller's; a plain tensor counts as replicated."""
    from torch.distributed.tensor.experimental import local_map
    dm = q.device_mesh
    fn_name, hdim, kv_rows = _DECODE_ROUTES[name]
    fn = globals()[fn_name]
    cache = kv[0]
    if not isinstance(cache, DTensor):
        kv = tuple(on_mesh(x, dm) for x in kv)
        cache = kv[0]
    hq, hkv = q.shape[hdim], cache.shape[-2]
    qp, kvp, rp, op, wp = [], [], [], [], []
    head_axis = None
    for i, (pq, pk) in enumerate(zip(q.placements, cache.placements)):
        n = dm.size(i)
        if (isinstance(pq, Shard) and pq.dim == 0) or (kv_rows and isinstance(pk, Shard)
                                                       and pk.dim == 0):
            r = Replicate()
            qp.append(Shard(0)), kvp.append(Shard(0) if kv_rows else r), rp.append(Shard(0))
            op.append(Shard(0)), wp.append(r)
        elif head_axis is None and hq % n == 0 and (
                (isinstance(pq, Shard) and pq.dim == hdim)
                or (isinstance(pk, Shard) and pk.dim == cache.dim() - 2)):
            head_axis = i
            qp.append(Shard(hdim)), rp.append(Replicate()), wp.append(Shard(0))
            kvp.append(Shard(cache.dim() - 2) if hkv % n == 0 else Replicate())
            op.append(Partial() if wo is not None else Shard(hdim))
        else:
            r = Replicate()
            qp.append(r), kvp.append(r), rp.append(r), op.append(r), wp.append(r)
    q = reshard(q, dm, qp)
    kv = tuple(reshard(x, dm, kvp) for x in kv)
    rows = tuple(reshard(on_mesh(x, dm), dm, rp) for x in rows)
    runs = None
    if head_axis is not None and hkv % dm.size(head_axis):
        n = hq // dm.size(head_axis)
        runs = head_runs(dm.get_local_rank(head_axis) * n, n, hq // hkv)
    args, places = (q, *kv, *rows), (qp, kvp, kvp, rp, rp)
    if wo is not None:
        args, places = args + (reshard(on_mesh(wo, dm), dm, wp),), places + (wp,)

    def local(ql, kl, vl, r0, r1, wl=None):
        if runs is None:
            calls = [(ql, kl, vl, wl)]
        else:
            hd = ql.shape[-1]
            calls = [(ql.narrow(hdim, a, b - a).contiguous(), kl[..., c:d, :], vl[..., c:d, :],
                      None if wl is None else wl[a * hd:b * hd]) for a, b, c, d in runs]
        with _LAUNCHES_LOCK:
            KERNEL_HEADS[name].update((x.shape[hdim], y.shape[-2]) for x, y, _, _ in calls)
        if wl is not None:
            outs = [fn(x, y, z, w, r0, r1, **opts) for x, y, z, w in calls]
            return outs[0] if len(outs) == 1 else torch.stack(outs).sum(dim=0)
        outs = [fn(x, y, z, r0, r1, **opts) for x, y, z, _ in calls]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=hdim)

    return local_map(local, out_placements=op, in_placements=places, device_mesh=dm)(*args)


class _LinearScan(torch.autograd.Function):
    """The scan kernel, and its reverse-time kernel as its gradient."""

    @staticmethod
    def forward(ctx, a, x, h0):
        h, h_last = (_meta.linear_scan if x.is_meta else linear_scan_cuda)(a, x, h0)
        _launched(x, "linear_scan")
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h, h0 = ctx.saved_tensors
        bwd = _meta.linear_scan_bwd if g.is_meta else linear_scan_bwd_cuda
        da, dx, dh0 = bwd(a, h, h0, g.contiguous(), g_last)
        _launched(g, "linear_scan_bwd")
        return da, dx, None if dh0 is None else dh0.to(h0.dtype)


def linear_scan(a, x, h0=None):
    """h_t = a_t * h_{t-1} + x_t over a, x: (B, S, C) with h0: (B, C) or
    None; returns (h (B, S, C), h_last (B, C)) in x's dtype.  DTensor
    inputs run on each rank's local rows and channels (``_sharded_scan``)."""
    if isinstance(x, DTensor):
        return _sharded_scan(a, x, h0)
    if _route(x) == "cpu":
        return _ref.linear_scan(a, x, h0)
    if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad
                                    or (h0 is not None and h0.requires_grad)):
        return _LinearScan.apply(a.contiguous(), x.contiguous(), h0)
    out = (_meta.linear_scan if x.is_meta else linear_scan_cuda)(a, x, h0)
    _launched(x, "linear_scan")
    return out


def _sharded_scan(a, x, h0):
    """``linear_scan`` of DTensors: the recurrence is independent per row
    and per channel, so each rank runs the kernel (or on the CPU the plain
    version) on its local (B_local, S, C_local) tensors where x is split on
    its batch or channel dim; a split of the time axis, or a pending
    ``Partial``, is gathered first."""
    from torch.distributed.tensor.experimental import local_map
    dm = x.device_mesh
    xp, hp = [], []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim in (0, 2):
            xp.append(p), hp.append(Shard(0 if p.dim == 0 else 1))
        else:
            xp.append(Replicate()), hp.append(Replicate())
    a, x = reshard(a, dm, xp), reshard(x, dm, xp)
    if h0 is None:
        return local_map(lambda a_, x_: linear_scan(a_, x_), out_placements=(xp, hp),
                         in_placements=(xp, xp), in_grad_placements=(xp, xp),
                         device_mesh=dm)(a, x)
    if not isinstance(h0, DTensor):
        h0 = DTensor.from_local(h0, dm, [Replicate()] * dm.ndim, run_check=False)
    return local_map(linear_scan, out_placements=(xp, hp), in_placements=(xp, xp, hp),
                     in_grad_placements=(xp, xp, hp), device_mesh=dm)(a, x, reshard(h0, dm, hp))

"""The dry run's sharded programs (``launch/dryrun.py::traced_on_mesh``):
rank 0's program of a step distributed over a mesh, traced on the meta
device under a ``fake`` process group, the counterpart of
``tests/test_sharding.py::test_dryrun_reduced_mesh_smoke``.

Reduced olmo-1b's train step on the pod-style (2, 2, 2) mesh at
accum_steps 2 traces with a temporary peak and FSDP's collectives.  On
(1, 2), tensor parallelism alone, a dense config's collectives equal
the count written out below from the layout (Megatron's: a row-parallel
``wo`` and ``w_down`` give partial sums, reduced once each in the
forward; their column-parallel counterparts' input gradients, once each
in the backward), bytes and counts, and each device's FLOPs are half of
the one-card trace's.  The dry run builds with remat, as the reference's:
the train step's backward replays each unit's forward, and with it the
row-parallel ``wo``'s reduction (not ``w_down``'s: it is the unit's last
op, after the last tensor the recompute must refill, where
``torch.utils.checkpoint`` stops).  A one-card record has no
collectives."""
import pytest

from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

B, S, D, V = 4, 16, 256, 512
BF16, F32 = 2, 4
TP = Mesh(("data", "model"), (1, 2))
# a device's FLOPs over half the one-card trace's: every product is split
# over "model" (heads, d_ff, the vocab), and nothing else is counted
FLOPS_BAND = (0.98, 1.02)


def dense(n_layers):
    return ModelConfig(name="t", family="dense", n_layers=n_layers, d_model=D, n_heads=4,
                       n_kv_heads=2, d_ff=2 * D, vocab_size=V)


def analytic_collectives(kind, n_layers):
    """The collectives of rank 0 on (1, 2): bf16 activations, f32 logits."""
    act = B * S * D * BF16
    # forward: the vocab-parallel embedding's partial rows, then per layer
    # the row-parallel wo and w_down
    n_act = 1 + 2 * n_layers
    out = {}
    if kind == "train":
        # backward: the head's input gradient, then per layer the summed
        # input gradients of the column-parallel q/k/v and of up/gate, and
        # the recompute's reduction of wo's partial rows (remat: a unit a
        # layer)
        n_act += 1 + 2 * n_layers + n_layers
        # each norm scale's gradient, a partial sum over the model axis
        n_norm = 2 * n_layers + 1
        # AdamW's global norm: one scalar a model-split parameter (wq, wk,
        # wv, wo, w_up, w_gate, w_down a layer; the embedding and the head)
        n_scalar = 7 * n_layers + 2
        out["all-reduce"] = n_act * act + n_norm * D * BF16 + n_scalar * F32
        out["all-reduce_count"] = n_act + n_norm + n_scalar
    else:
        out["all-reduce"] = n_act * act
        out["all-reduce_count"] = n_act
    if kind in ("train", "prox"):
        # the plain loss: the vocab-split logits gathered for the log-softmax,
        # and the chosen token's logit, a masked partial sum, reduced
        out["all-gather"] = B * (S - 1) * V * F32
        out["all-gather_count"] = 1
        out["all-reduce"] += B * (S - 1) * F32
        out["all-reduce_count"] += 1
    return out


def shape_of(kind):
    return ShapeConfig("t", seq_len=S, global_batch=B,
                       kind="prefill" if kind == "prefill" else "train")


CASES = [(kind, n) for kind in ("train", "prox", "prefill") for n in (1, 2)]


@pytest.mark.parametrize("kind,n_layers", CASES, ids=[f"{k}-{n}L" for k, n in CASES])
def test_tensor_parallel_collectives_match_the_analytic_count(kind, n_layers):
    rec = dryrun.traced_on_mesh(dense(n_layers), shape_of(kind), TP, kind, fsdp=False,
                                accum_steps=1)
    assert rec["program"] == "traced"
    assert rec["collectives"] == analytic_collectives(kind, n_layers)


@pytest.mark.parametrize("kind", ["train", "prox", "prefill"])
def test_tensor_parallel_flops_are_half_the_one_card_trace(kind):
    cfg, shape = dense(2), shape_of(kind)
    tp = dryrun.traced_on_mesh(cfg, shape, TP, kind, fsdp=False, accum_steps=1)
    if kind == "prox":
        one = dryrun.prox_dryrun(cfg, shape)["meshes"]["1x1"]
    else:
        one = dryrun.build_dryrun("t", "t", cfg=cfg, shape=shape, accum_steps=1)["meshes"]["1x1"]
    assert one["collectives"] == {}
    lo, hi = FLOPS_BAND
    assert lo <= tp["flops"] / (0.5 * one["flops"]) <= hi


def test_reduced_olmo_train_step_traces_on_a_pod_mesh():
    """(2, 2, 2) over ("pod", "data", "model"), FSDP on the data axis,
    accum_steps 2: the parameters' all-gathers and the gradients'
    reduce-scatters appear, and the step holds temporaries."""
    cfg = reduced(get_model_config("olmo-1b"))
    shape = ShapeConfig("t", seq_len=64, global_batch=8, kind="train")
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    rec = dryrun.traced_on_mesh(cfg, shape, mesh, "train", accum_steps=2)
    assert rec["program"] == "traced" and rec["temp_bytes"] > 0 and rec["flops"] > 0
    coll = rec["collectives"]
    assert coll.get("all-gather_count", 0) > 0 and coll.get("reduce-scatter_count", 0) > 0


def test_one_card_record_has_no_collectives():
    rec = dryrun.build_dryrun("t", "t", cfg=dense(1), shape=shape_of("train"), accum_steps=1)
    assert rec["meshes"]["1x1"]["collectives"] == {}
    assert rec["meshes"]["32x8"]["program"] == "traced"


def test_roofline_takes_each_axis_over_its_link():
    """The "model" axis over NVLink, the data axes over InfiniBand; a
    record without the split takes NVLink for all."""
    from repro_torch.launch import roofline
    m = {"n_devices": 256, "program": "traced", "flops": 0.0, "bytes": 0.0,
         "memory": {"argument_bytes": 1.0, "temp_bytes": 0.0},
         "collectives": {"all-reduce": 3e9, "all-reduce_count": 2, "all-gather": 1e9},
         "collectives_by_axis": {"model": {"all-reduce": 3e9, "all-reduce_count": 2},
                                 "data": {"all-gather": 1e9, "all-gather_count": 1}}}
    rec = {"arch": "a", "shape": "s", "status": "ok", "model_flops": 1.0, "meshes": {"32x8": m}}
    row = roofline.row_from_record(rec, "32x8")
    assert row.collective_s == pytest.approx(3e9 / 450e9 + 1e9 / (400e9 / 8))
    del m["collectives_by_axis"]
    assert roofline.row_from_record(rec, "32x8").collective_s == pytest.approx(4e9 / 450e9)


# ---------------------------------------------------------------------------
# the serving steps on a mesh
# ---------------------------------------------------------------------------

DP_TP = Mesh(("data", "model"), (2, 2))
DEC_B, DEC_S, CHUNK = 4, 64, 8


def decode_shape():
    return ShapeConfig("t", seq_len=DEC_S, global_batch=DEC_B, kind="decode")


def analytic_decode_collectives(n_layers, paged):
    """Rank 0's collectives of one decode step of ``dense(n_layers)`` on
    (2, 2) without FSDP: the slots split over "data", the heads over
    "model" (2 of 4 q heads, 1 of 2 kv heads a rank).  Over "model": the
    vocab-parallel embedding's partial rows, then per layer the
    row-parallel ``wo`` (or the fused tail) and ``w_down``, each a partial
    sum reduced once.  Over "data", paged only: the pool is whole on every
    data replica, so the step's destinations and positions (int32, one a
    slot) and per layer the new K and V rows of every slot (1 kv head of
    64, bf16) are gathered, and every replica applies every write."""
    rows = DEC_B // 2
    n_red = 1 + 2 * n_layers
    out = {"model": {"all-reduce": n_red * rows * D * BF16, "all-reduce_count": n_red}}
    if paged:
        out["data"] = {"all-gather": 2 * DEC_B * 4 + 2 * n_layers * DEC_B * 64 * BF16,
                       "all-gather_count": 2 + 2 * n_layers}
    return out


DECODE_CASES = [(kind, n) for kind in ("ring", "paged", "fused") for n in (1, 2)]


@pytest.mark.parametrize("kind,n_layers", DECODE_CASES,
                         ids=[f"{k}-{n}L" for k, n in DECODE_CASES])
def test_decode_collectives_match_the_analytic_count(kind, n_layers):
    rec = dryrun.traced_on_mesh(dense(n_layers), decode_shape(), DP_TP, "decode", fsdp=False,
                                paged_cache=kind != "ring", fused_decode=kind == "fused",
                                block_size=16, prefill_chunk=CHUNK if kind == "paged" else 0)
    assert rec["program"] == "traced"
    assert rec["collectives_by_axis"] == analytic_decode_collectives(n_layers, kind != "ring")
    if kind == "paged":
        # the chunk step takes its span whole on every rank (the
        # reference's replicated in_shardings): only the model axis'
        # reductions, over the span's C rows
        n_red = 1 + 2 * n_layers
        assert rec["chunk"]["collectives_by_axis"] == {
            "model": {"all-reduce": n_red * CHUNK * D * BF16, "all-reduce_count": n_red}}


def test_no_record_is_left_untraced_for_decode():
    """Every mesh of a decode record is traced (the ring, paged, fused and
    chunk steps); no reason for a decode shape remains."""
    assert not hasattr(dryrun, "DECODE_REASON")
    cfg = dense(1)
    for kw in (dict(), dict(paged_cache=True, fused_decode=True, prefill_chunk=CHUNK)):
        rec = dryrun.build_dryrun("t", "t", cfg=cfg, shape=decode_shape(), **kw)
        assert rec["status"] == "ok"
        for name, m in rec["meshes"].items():
            assert m["program"] == "traced" and "reason" not in m, name
            if name != "1x1" and kw:
                assert m["chunk"]["program"] == "traced"


def test_decode_kernels_read_a_shards_kv_heads_in_place(monkeypatch):
    """6 q heads on 2 kv heads over "model" 3: rank 0's q heads 0 and 1
    use kv head 0, and each kernel is handed a view of that kv head of the
    cache or pool it keeps whole, at the row stride of both kv heads: no
    copy of a cache or pool slice."""
    from repro_torch.kernels import meta
    seen = {}

    def spy(name):
        real = getattr(meta, name)

        def call(q, k, *args, **kw):
            seen[name] = (tuple(k.shape), k.stride(), k.is_contiguous())
            return real(q, k, *args, **kw)
        return call

    for name in ("decode_attention", "paged_decode_attention", "fused_decode_tail",
                 "paged_prefill_attention"):
        monkeypatch.setattr(meta, name, spy(name))
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=192, n_heads=6,
                      n_kv_heads=2, d_ff=128, vocab_size=V)
    mesh, hd = Mesh(("data", "model"), (1, 3)), 32
    for kw in (dict(), dict(paged_cache=True, prefill_chunk=CHUNK),
               dict(paged_cache=True, fused_decode=True)):
        dryrun.traced_on_mesh(cfg, decode_shape(), mesh, "decode", fsdp=False, block_size=16,
                              **kw)
    for name, (shape, stride, contiguous) in seen.items():
        assert shape[-2:] == (1, hd) and stride[-3] == 2 * hd and not contiguous, name
    assert len(seen) == 4

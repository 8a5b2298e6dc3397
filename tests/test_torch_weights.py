"""The port's weight publication against the JAX reference
(``tests/test_weights.py``'s battery, on the port's state dicts).

* codecs: XOR deltas bit-exact for every dtype, q8 within its declared
  tolerance, nothing on the wire for an identical publication, the full
  fallbacks; bf16 (kept as its ``uint16`` bits on the host) goes by the
  exact ``xor`` rule under ``delta-q``, as the reference's opaque bf16
  does;
* the same host trees encoded by the reference's ``encode_stream`` and
  by the port's give the same chunks, and the reference's messages
  decoded by the port's ``StreamDecoder`` give the reference's leaves;
* the decoder's fence: torn, superseded, base-mismatched and orphan
  messages;
* ``ParameterStore``: eviction, subscribers, and the checkpoint spill on
  its background writer;
* the engine's streamed pickup against one monolithic ``update_weights``
  (ring, and paged with and without chunked prefill), torn streams and
  base mismatches;
* checkpoints: round trips, and ``load_reference`` of a file that
  ``repro.checkpoint.save`` wrote.
"""
import dataclasses
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs import get_model_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.core import weights as jw
from repro.models.model import build_model as jax_build_model
from repro_torch import checkpoint
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core import weights as tw
from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.core.weights import (ENCODINGS, ParameterStore, StreamBegin, StreamDecoder,
                                      StreamEnd, VersionEvicted, WeightChunk, device_leaf,
                                      encode_stream, host_weights)
from repro_torch.data import tokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

_DTYPES = ["float32", "float16", "int32", "int8", "uint16", "bool"]


def _array(dtype: str, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=size).astype(bool)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        a = rng.standard_normal(size).astype(dt)
        if size >= 3:                      # non-finite bit patterns
            a[0], a[1], a[2] = np.inf, -np.inf, np.nan
        return a
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, size=size, dtype=np.int64).astype(dt)


def _decode(stream, base_tree, base_version, decoder=StreamDecoder):
    dec = decoder(base_tree, base_version)
    out = None
    for msg in stream:
        got = dec.feed(msg)
        if got is not None:
            out = got
    return out, dec


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        bool(np.array_equal(a.view(np.uint8), b.view(np.uint8)))


# ---- codecs -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("seed,size,chunk", [(0, 1, 1), (3, 57, 8), (11, 300, 64)])
def test_xor_delta_roundtrip_is_bit_exact(dtype, seed, size, chunk):
    base = {"w": _array(dtype, size, seed), "b": _array(dtype, 7, seed + 1)}
    new = {"w": _array(dtype, size, seed + 2), "b": base["b"].copy()}
    stream = encode_stream(new, version=1, base=base, base_version=0, encoding="delta",
                           chunk_elems=chunk)
    out, dec = _decode(stream, {k: v.copy() for k, v in base.items()}, 0)
    assert out is not None and out[0] == 1
    assert _bits_equal(out[1]["w"], new["w"]) and _bits_equal(out[1]["b"], new["b"])
    assert dec.torn == 0 and dec.completed == 1
    assert not any(isinstance(m, WeightChunk) and m.path == "b" for m in stream)


@pytest.mark.parametrize("seed,size,chunk", [(0, 1, 1), (5, 100, 7), (9, 300, 64)])
def test_q8_decodes_within_declared_tolerance(seed, size, chunk):
    rng = np.random.default_rng(seed)
    base = {"w": rng.standard_normal(size).astype(np.float32)}
    new = {"w": (base["w"] + 1e-3 * rng.standard_normal(size)).astype(np.float32)}
    stream = encode_stream(new, version=1, base=base, base_version=0, encoding="delta-q",
                           chunk_elems=chunk)
    out, _ = _decode(stream, {"w": base["w"].copy()}, 0)
    err = float(np.max(np.abs(out[1]["w"].astype(np.float64) - new["w"].astype(np.float64))))
    assert err <= stream.tolerance() + 1e-6


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_identical_publication_sends_zero_chunks(encoding):
    rng = np.random.default_rng(4)
    base = {"a": rng.standard_normal(40).astype(np.float32), "b": _array("int32", 9, 4)}
    new = {k: v.copy() for k, v in base.items()}
    stream = encode_stream(new, version=3, base=base, base_version=2, encoding=encoding)
    if encoding != "full":
        assert stream.n_chunks == 0
    out, _ = _decode(stream, base, 2)
    assert out is not None and out[0] == 3 and _bits_equal(out[1]["a"], base["a"])


def test_first_publish_without_base_is_full_and_base_free():
    new = {"layer.w": _array("float32", 33, 0), "layer.b": _array("int8", 5, 1)}
    stream = encode_stream(new, version=1, base=None, encoding="delta", chunk_elems=16)
    begin = stream.messages[0]
    assert begin.encoding == "full" and begin.base_version is None
    assert all(m.kind == "full" for m in stream.messages[1:-1])
    out, _ = _decode(stream, None, None)
    for path, leaf in new.items():
        assert _bits_equal(out[1][path], leaf)


def test_shape_and_dtype_mismatch_fall_back_to_full_chunks():
    base = {"w": _array("float32", 20, 0), "b": _array("float32", 6, 1)}
    new = {"w": _array("float32", 24, 2), "b": _array("float16", 6, 3)}
    stream = encode_stream(new, version=1, base=base, base_version=0, encoding="delta",
                           chunk_elems=8)
    assert {m.path: m.kind for m in stream.messages if isinstance(m, WeightChunk)} == \
        {"w": "full", "b": "full"}
    out, _ = _decode(stream, base, 0)
    assert _bits_equal(out[1]["w"], new["w"]) and _bits_equal(out[1]["b"], new["b"])


def test_nonfinite_delta_under_q8_falls_back_to_exact_full():
    base = {"w": np.zeros(10, np.float32)}
    new = {"w": np.full(10, np.inf, np.float32)}
    stream = encode_stream(new, version=1, base=base, base_version=0, encoding="delta-q")
    assert all(m.kind == "full" for m in stream.messages if isinstance(m, WeightChunk))
    out, _ = _decode(stream, base, 0)
    assert _bits_equal(out[1]["w"], new["w"]) and stream.tolerance() == 0.0


@pytest.mark.parametrize("encoding", ["delta", "delta-q"])
def test_bf16_goes_by_exact_xor_and_comes_back_bitwise(encoding):
    """A bf16 state dict: its host form is uint16 bits, so even delta-q
    sends xor chunks, and ``device_leaf`` rebuilds the very bf16 bits."""
    g = torch.Generator().manual_seed(0)
    old = {"w": torch.randn(300, generator=g).bfloat16(), "s": torch.randn(5, generator=g).bfloat16()}
    new = {"w": (old["w"].float() + 0.01 * torch.randn(300, generator=g)).bfloat16(),
           "s": old["s"].clone()}
    base_host, new_host = host_weights(old), host_weights(new)
    assert new_host["w"].dtype == np.uint16
    stream = encode_stream(new_host, version=1, base=base_host, base_version=0,
                           encoding=encoding, chunk_elems=64)
    assert {m.kind for m in stream if isinstance(m, WeightChunk)} == {"xor"}
    assert stream.tolerance() == 0.0
    out, _ = _decode(stream, {k: v.copy() for k, v in base_host.items()}, 0)
    for name, t in new.items():
        back = device_leaf(out[1][name], old[name])
        assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16),
                                                            t.view(torch.int16))


# ---- against the reference's encoder -----------------------------------------

def _tree(seed: int):
    """A host tree of every dtype the codecs meet, bf16 among them, its
    keys in sorted order (the reference's tree flattening sorts a dict's
    keys; the port keeps a state dict's order)."""
    rng = np.random.default_rng(seed)
    return {"bf": rng.standard_normal(130).astype(ml_dtypes.bfloat16),
            "h": _array("float16", 70, seed), "i": _array("int32", 40, seed),
            "m": _array("bool", 33, seed), "w": rng.standard_normal(300).astype(np.float32)}


def _moved(tree, seed: int):
    rng = np.random.default_rng(seed)
    out = dict(tree)
    out["w"] = (tree["w"] + 1e-2 * rng.standard_normal(300)).astype(np.float32)
    out["bf"] = (tree["bf"].astype(np.float32) + 0.05 * rng.standard_normal(130)).astype(
        ml_dtypes.bfloat16)
    out["i"] = tree["i"] + np.int32(1)
    return out


def _port_host(tree):
    """The port's host form of a tree: bf16 as its uint16 bits."""
    return {k: (v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v)
            for k, v in tree.items()}


def _to_port(msg):
    """A reference message as the port's: bf16 payloads as their bits."""
    cls = {"StreamBegin": StreamBegin, "StreamEnd": StreamEnd, "WeightChunk": WeightChunk}
    fields = {f.name: getattr(msg, f.name) for f in dataclasses.fields(msg)}
    if fields.get("dtype") == "bfloat16":
        fields["dtype"] = "uint16"
        fields["payload"] = fields["payload"].view(np.uint16)
    return cls[type(msg).__name__](**fields)


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("with_base", [True, False])
def test_reference_and_port_encoders_emit_the_same_chunks(encoding, with_base):
    base = _tree(1)
    new = _moved(base, 2)
    kw = dict(version=5, base_version=4 if with_base else None, encoding=encoding,
              chunk_elems=32)
    ref = jw.encode_stream(new, base=base if with_base else None, **kw)
    port = encode_stream(_port_host(new), base=_port_host(base) if with_base else None, **kw)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        a = _to_port(a)
        assert type(a) is type(b)
        if isinstance(a, WeightChunk):
            assert (a.path, a.seq, a.offset, a.size, a.shape, a.kind, a.last_of_leaf, a.dtype) \
                == (b.path, b.seq, b.offset, b.size, b.shape, b.kind, b.last_of_leaf, b.dtype)
            assert a.scale == b.scale and _bits_equal(a.payload, b.payload)
        else:
            assert a == b


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_port_decoder_reads_the_reference_stream(encoding):
    base = _tree(3)
    new = _moved(base, 4)
    ref_stream = jw.encode_stream(new, version=1, base=base, base_version=0,
                                  encoding=encoding, chunk_elems=32)
    want, _ = _decode(ref_stream, {k: v.copy() for k, v in base.items()}, 0,
                      decoder=jw.StreamDecoder)
    got, dec = _decode([_to_port(m) for m in ref_stream],
                       {k: v.copy() for k, v in _port_host(base).items()}, 0)
    assert got[0] == want[0] == 1 and dec.completed == 1
    for name, leaf in _port_host(want[1]).items():
        assert _bits_equal(got[1][name], leaf), name


# ---- the decoder's fence -------------------------------------------------------

def _two_versions(seed=0, size=50, chunk_elems=8):
    base = {"w": _array("float32", size, seed)}
    new = {"w": _array("float32", size, seed + 1)}
    stream = encode_stream(new, version=1, base=base, base_version=0, encoding="delta",
                           chunk_elems=chunk_elems)
    assert stream.n_chunks >= 2
    return base, new, stream


def test_torn_stream_missing_chunk_keeps_last_complete_version():
    base, _new, stream = _two_versions()
    msgs = list(stream)
    del msgs[2]
    dec = StreamDecoder({"w": base["w"].copy()}, 0)
    assert all(dec.feed(m) is None for m in msgs)
    assert dec.torn == 1 and dec.completed == 0 and dec.version == 0
    assert _bits_equal(dec.params["w"], base["w"])


def test_superseding_begin_tears_the_open_stream():
    base, _new, stream = _two_versions()
    newer = {"w": _array("float32", 50, 7)}
    stream2 = encode_stream(newer, version=2, base=base, base_version=0, encoding="delta",
                            chunk_elems=8)
    dec = StreamDecoder({"w": base["w"].copy()}, 0)
    for m in list(stream)[:-1]:
        dec.feed(m)
    out = None
    for m in stream2:
        out = dec.feed(m) or out
    assert dec.torn == 1 and dec.completed == 1 and out[0] == 2
    assert _bits_equal(dec.params["w"], newer["w"])


def test_base_version_mismatch_ignored_whole_and_requests_full():
    base, _new, stream = _two_versions()
    dec = StreamDecoder({"w": base["w"].copy()}, 99)
    assert all(dec.feed(m) is None for m in stream)
    assert dec.base_mismatches == 1 and dec.need_full
    assert dec.completed == 0 and dec.version == 99
    assert _bits_equal(dec.params["w"], base["w"])
    assert dec.orphans == stream.n_chunks + 1


def test_orphan_messages_before_any_begin_are_counted_and_ignored():
    base, _new, stream = _two_versions()
    dec = StreamDecoder({"w": base["w"].copy()}, 0)
    assert dec.feed(stream.messages[1]) is None
    assert dec.feed(StreamEnd(version=1, n_chunks=3)) is None
    assert dec.orphans == 2 and dec.torn == 0
    with pytest.raises(TypeError):
        dec.feed(("weights", 1, base))


@pytest.mark.parametrize("seed,size", [(0, 2), (1, 17), (2, 120)])
def test_stream_framing_accounts_every_chunk(seed, size):
    base = {"w": _array("float32", size, seed)}
    new = {"w": _array("float32", size, seed + 5)}
    stream = encode_stream(new, version=4, base=base, base_version=3, encoding="delta",
                           chunk_elems=16)
    chunks = [m for m in stream.messages if isinstance(m, WeightChunk)]
    assert stream.messages[0].n_chunks == stream.messages[-1].n_chunks == len(chunks)
    assert [c.seq for c in chunks] == list(range(len(chunks)))
    assert stream.nbytes() == sum(c.payload.nbytes for c in chunks)


# ---- ParameterStore -----------------------------------------------------------

def _w(v):
    return {"w": torch.full((3,), float(v))}


def test_store_eviction_raises_versioned_error_not_none():
    store = ParameterStore(keep=2)
    for v in (1, 2, 3, 4):
        store.publish(v, _w(v))
    assert store.latest()[0] == 4 and store.get(3)["w"][0].item() == 3.0
    with pytest.raises(VersionEvicted):
        store.get(1)
    assert store.get(99) is None


def test_store_publishes_a_dict_as_given_and_a_model_as_a_copy():
    weights = _w(1)
    store = ParameterStore()
    store.publish(1, weights)
    assert store.get(1)["w"] is weights["w"] and store.get(1).ready is None
    model = torch.nn.Linear(2, 2)
    store.publish(2, model)
    snap = store.get(2)
    assert isinstance(snap, tw.Published) and set(snap) == {"weight", "bias"}
    assert snap["weight"].data_ptr() != model.weight.data_ptr()
    assert tw.acquire(snap) is snap            # nothing to wait for on the CPU


def test_store_subscribers_fire_in_registration_order_outside_lock():
    store = ParameterStore(keep=2)
    order = []
    store.subscribe(lambda v, p: order.append(("a", v)))
    store.subscribe(lambda v, p: order.append(("b", store.latest()[0])))
    t = threading.Thread(target=store.publish, args=(1, _w(0)))
    t.start()
    t.join(10.0)
    assert not t.is_alive(), "publish deadlocked inside a subscriber"
    assert order == [("a", 1), ("b", 1)]


def test_store_spills_off_the_publishing_thread(tmp_path, monkeypatch):
    disk = threading.Event()
    written = []

    def blocked_save(path, host, meta=None):
        assert disk.wait(10.0), "flush never released the fake disk"
        written.append((path, meta["version"], host["w"].copy()))

    monkeypatch.setattr(checkpoint, "save", blocked_save)
    store = ParameterStore(keep=2, ckpt_dir=str(tmp_path), ckpt_every=1)
    heard = []
    store.subscribe(lambda v, p: heard.append(v))
    store.publish(1, _w(1))
    store.publish(2, _w(2))
    assert heard == [1, 2] and store.spills == 0
    disk.set()
    store.flush()
    assert store.spills == 2
    assert sorted(v for _, v, _ in written) == [1, 2]
    assert all(p.startswith(str(tmp_path)) for p, _, _ in written)
    # the writer got a host copy taken at publication
    assert all(isinstance(h, np.ndarray) and h[0] == v for _, v, h in written)
    store.close()


def test_store_close_surfaces_spill_errors(tmp_path, monkeypatch):
    def broken_save(path, host, meta=None):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "save", broken_save)
    store = ParameterStore(keep=2, ckpt_dir=str(tmp_path), ckpt_every=1)
    store.publish(1, _w(1))
    with pytest.raises(OSError, match="disk full"):
        store.close()


def test_store_respects_ckpt_every_stride_and_files_load_back(tmp_path):
    model = torch.nn.Linear(3, 2)
    store = ParameterStore(keep=4, ckpt_dir=str(tmp_path), ckpt_every=2)
    published = {}
    for v in (1, 2, 3, 4):
        with torch.no_grad():
            model.weight.add_(1.0)
        store.publish(v, model, {"step": v})
        published[v] = {n: t.clone() for n, t in model.state_dict().items()}
    store.close()
    assert store.spills == 2
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == ["v000002.npz", "v000004.npz"]
    for v in (2, 4):
        got, _, meta = checkpoint.load(str(tmp_path / f"v{v:06d}.npz"), model)
        assert meta == {"version": v, "step": v}
        for n, t in got.items():
            assert torch.equal(t, published[v][n])


# ---- the engine's streamed pickup -------------------------------------------------

def _engine_pair(cache, prefill_chunk, dtype=torch.float32):
    cfg = ModelConfig(name="wtest", family="dense", n_layers=1, d_model=32, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab_size=tokenizer.VOCAB_SIZE)
    model = build_model(cfg, device="cpu", dtype=dtype).init(torch.Generator().manual_seed(7))

    def make():
        m = build_model(cfg, device="cpu", dtype=dtype)
        m.load_state_dict(model.state_dict())
        return RolloutEngine(m, EngineConfig(
            n_slots=3, prompt_len=8, max_gen_len=6, seed=11, cache=cache, block_size=4,
            prefill_chunk=prefill_chunk, rng="request", eos_id=-1), device="cpu")

    return model, make


def _perturbed(model, seed=5):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, (name, t) in enumerate(model.state_dict().items()):
        if i % 2 == 0:
            t = (t.float() + 1e-2 * torch.randn(t.shape, generator=g)).to(t.dtype)
        out[name] = t.clone()
    return out


def _reqs(n):
    return [{"rid": i, "prompt_id": i, "prompt": [1, 4 + i, 5, 6], "answer": None}
            for i in range(n)]


def _finished(f):
    return tuple(f.prompt), tuple(f.response), tuple(np.asarray(f.logprobs).tolist())


def _run(engine, reqs, *, flip_at, apply_fn, steps=40):
    done, pending = {}, list(reqs)
    for step in range(steps):
        n = engine.admit(pending)
        pending = pending[n:]
        if step == flip_at:
            apply_fn(engine)
        for f in engine.step():
            assert f.rid not in done
            done[f.rid] = _finished(f)
        if not pending and engine.n_active == 0:
            break
    assert not pending and engine.n_active == 0
    return done


@pytest.mark.parametrize("cache,prefill_chunk", [("ring", 0), ("paged", 0), ("paged", 4)])
def test_streamed_pickup_identical_to_monolithic_update(cache, prefill_chunk):
    """Feeding a delta stream, its body spread over the steps before K and
    its end at K, gives the trajectories of one ``update_weights`` at K,
    and the engine does not flip before the end (the version fence)."""
    model, make = _engine_pair(cache, prefill_chunk)
    new = _perturbed(model)
    stream = encode_stream(host_weights(new), version=1, base=host_weights(model),
                           base_version=0, encoding="delta", chunk_elems=64)
    msgs = list(stream)
    assert len(msgs) > 6
    flip_at = 4
    baseline = _run(make(), _reqs(5), flip_at=flip_at,
                    apply_fn=lambda e: e.update_weights(new, 1))

    engine = make()
    body, end = msgs[:-1], msgs[-1]
    fed, done, pending = 0, {}, _reqs(5)
    per_step = max(1, (len(body) + flip_at - 1) // flip_at)
    for step in range(40):
        n = engine.admit(pending)
        pending = pending[n:]
        if step < flip_at:
            for _ in range(per_step):
                if fed < len(body):
                    assert not engine.feed_weight_message(body[fed])
                    fed += 1
            assert engine.version == 0
        elif step == flip_at:
            while fed < len(body):
                assert not engine.feed_weight_message(body[fed])
                fed += 1
            assert engine.feed_weight_message(end) and engine.version == 1
        for f in engine.step():
            done[f.rid] = _finished(f)
        if not pending and engine.n_active == 0:
            break
    assert engine.stream_stats()["streams_completed"] == 1
    assert done == baseline
    for name, t in engine.model.state_dict().items():
        assert torch.equal(t, new[name]), name


def test_streamed_pickup_of_a_bf16_engine_under_delta_q_is_bitwise():
    model, make = _engine_pair("ring", 0, dtype=torch.bfloat16)
    engine = make()
    new = _perturbed(model)
    stream = encode_stream(host_weights(new), version=1, base=host_weights(model),
                           base_version=0, encoding="delta-q", chunk_elems=64)
    assert {m.kind for m in stream if isinstance(m, WeightChunk)} == {"xor"}
    assert [engine.feed_weight_message(m) for m in stream][-1]
    for name, t in engine.model.state_dict().items():
        assert torch.equal(t.view(torch.int16), new[name].view(torch.int16)), name


def test_engine_discards_torn_stream_and_keeps_serving():
    model, make = _engine_pair("ring", 0)
    engine = make()
    params2, params3 = _perturbed(model, seed=5), _perturbed(model, seed=9)
    stream = list(encode_stream(host_weights(params2), version=1, base=host_weights(model),
                                base_version=0, encoding="delta", chunk_elems=64))
    for msg in stream[:3]:
        assert not engine.feed_weight_message(msg)
    engine.update_weights(params2, 1)          # supersedes the open stream
    assert engine.stream_stats()["streams_torn"] == 1 and engine.version == 1
    stream2 = encode_stream(host_weights(params3), version=2, base=host_weights(params2),
                            base_version=1, encoding="delta", chunk_elems=64)
    flipped = [engine.feed_weight_message(m) for m in stream2]
    assert flipped[-1] and engine.version == 2
    assert engine.stream_stats()["streams_completed"] == 1
    for name, t in engine.model.state_dict().items():
        assert torch.equal(t, params3[name]), name


def test_engine_base_mismatch_requests_full_retransmit():
    model, make = _engine_pair("ring", 0)
    engine = make()
    params2 = _perturbed(model)
    stream = encode_stream(host_weights(params2), version=7, base=host_weights(params2),
                           base_version=6, encoding="delta", chunk_elems=64)
    for msg in stream:
        assert not engine.feed_weight_message(msg)
    assert engine.version == 0
    assert engine.consume_stream_need_full() and not engine.consume_stream_need_full()


def test_update_weights_takes_a_published_dict_and_refuses_a_misfit():
    model, make = _engine_pair("ring", 0)
    engine = make()
    store = ParameterStore()
    store.publish(1, model)
    version, weights = store.latest()
    assert engine.update_weights(tw.acquire(weights), version)
    bad = dict(weights)
    bad.pop("embed.table")
    with pytest.raises(ValueError, match="do not fit"):
        engine.update_weights(bad, 2)


# ---- checkpoints ------------------------------------------------------------------

def _laptop_cfg():
    return reduced(get_model_config("areal-qwen-1.5b"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_with_optimizer_state(tmp_path, dtype):
    from repro_torch import optim
    model = build_model(_laptop_cfg(), device="cpu", dtype=dtype).init(
        torch.Generator().manual_seed(3))
    state = optim.init_state(list(model.parameters()))
    state["step"] = 7
    state["m"][0].add_(0.5)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, model, opt_state=state, meta={"version": 3})
    with np.load(path) as data:
        assert "p:blocks.0.attn.wq" in data.files and "o:m/0" in data.files
        assert data["p:embed.table"].dtype == np.float32      # bf16 written as f32
    got, opt, meta = checkpoint.load(path, model, state)
    assert meta == {"version": 3} and opt["step"] == 7
    assert torch.equal(opt["m"][0], state["m"][0])
    for name, t in model.state_dict().items():
        assert got[name].dtype == dtype and torch.equal(got[name], t), name


def test_load_reference_reads_a_checkpoint_the_reference_wrote(tmp_path):
    jcfg = jax_reduced(jax_config("areal-qwen-1.5b"))
    params = jax_build_model(jcfg, remat=False).init(jax.random.key(2))
    path = str(tmp_path / "ref.npz")
    jax_checkpoint.save(path, params, meta={"version": 4})
    model, meta = checkpoint.load_reference(path, _laptop_cfg(), device="cpu")
    assert meta == {"version": 4}
    flat = {k[2:]: v for k, v in np.load(path).items() if k.startswith("p:")}
    want = params_from_jax(_laptop_cfg(), flat, device="cpu")
    for (name, t), u in zip(model.state_dict().items(), want.state_dict().values()):
        assert torch.equal(t, u), name
    # and the stacked leaves land layer by layer
    assert np.array_equal(model.blocks[1].attn.wq.detach().numpy(),
                          np.asarray(params["units"][0]["attn"]["wq"])[1])

"""The port's msgpack reader and writer (monolith_tpu_torch/serialization.py)
against flax.serialization, and the serving codec and record framing
against the JAX package's copies.

`to_bytes` must equal flax's bytes for the same tree byte for byte (a
params tree, an optax.adagrad state, every integer width, every header
width); `from_bytes` / `msgpack_restore` of flax's bytes must give equal
arrays; a wrong key or shape, trailing bytes, an unknown ext type and the
chunked form must raise.
"""

import io

import jax
import numpy as np
import optax
import pytest
from flax import serialization as fser

from monolith_tpu.data import framing as jframing
from monolith_tpu.serving import codec as jcodec
from monolith_tpu_torch import serialization as pser
from monolith_tpu_torch.data import framing as pframing
from monolith_tpu_torch.serving import codec as pcodec


def _params(seed=0, wide=300):
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.normal(size=(i, o)).astype(np.float32),
                "bias": rng.normal(size=(o,)).astype(np.float32)}
    return {"deep": {"dense_0": dense(24, wide), "dense_1": dense(wide, 8),
                     "dense_2": dense(8, 1)},
            "din": {"dense_tower": {"dense_0": dense(4, 3)}}}


def _flax_bytes(tree):
    # what the JAX package's checkpoint writes
    return fser.to_bytes(jax.device_get(tree))


def _assert_trees_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_to_bytes_equals_flax_on_a_params_tree():
    tree = _params()
    assert pser.to_bytes(tree) == _flax_bytes(tree)


def test_to_bytes_equals_flax_on_an_adagrad_state():
    params = _params(1)
    state = optax.adagrad(0.01).init(jax.tree.map(jax.numpy.asarray, params))
    sos = jax.tree.map(lambda p: np.full_like(p, 0.1), params)
    port = pser.to_bytes({"0": {"sum_of_squares": sos}, "1": {}})
    assert port == _flax_bytes(state)


@pytest.mark.parametrize("leaf", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    1.5, -0.0, True, False, None, "s" * 31, "s" * 32, "s" * 300,
    np.float32(2.5), np.int64(-7), np.zeros((), np.float32),
    np.zeros((0, 4), np.float32), np.arange(6, dtype=np.int64).reshape(2, 3),
    np.arange(2, dtype=np.uint8), np.arange(20000, dtype=np.float64),
    np.zeros((1, 2, 3, 4, 5), np.int32), np.zeros(70000, np.uint8)],
    ids=lambda v: (f"{type(v).__name__}-{np.shape(v)}" if isinstance(
        v, (np.ndarray, np.generic)) else repr(v)[:12]))
def test_leaf_encodings_equal_msgpack(leaf):
    """Every width of int, str, bin and ext header, as the msgpack package
    picks it (flax given the tree as it is, no device_get: that would turn
    a numpy scalar into an array)."""
    tree = {"k": leaf, "m": {"inner": leaf}}
    data = pser.to_bytes(tree)
    assert data == fser.to_bytes(tree)
    back = pser.msgpack_restore(data)
    ref = fser.msgpack_restore(data)
    _assert_trees_equal(back, ref)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 70000])
def test_map_header_widths_equal_msgpack(n):
    tree = {f"key{i:06d}": i for i in range(n)}
    data = pser.to_bytes(tree)
    assert data == fser.to_bytes(tree)
    assert pser.msgpack_restore(data) == tree


def test_keys_are_written_sorted_whatever_the_insertion_order():
    a = {"b": np.ones(2, np.float32), "a": {"z": 1, "y": 2}}
    b = {"a": {"y": 2, "z": 1}, "b": np.ones(2, np.float32)}
    assert pser.to_bytes(a) == pser.to_bytes(b) == _flax_bytes(a)


def test_from_bytes_reads_flax_bytes():
    tree = _params(2)
    template = jax.tree.map(np.zeros_like, tree)
    out = pser.from_bytes(template, _flax_bytes(tree))
    _assert_trees_equal(out, tree)
    # and flax reads the port's bytes
    back = fser.from_bytes(template, pser.to_bytes(tree))
    _assert_trees_equal(jax.device_get(back), tree)


def test_from_bytes_is_structural():
    tree = _params(3, wide=16)
    data = pser.to_bytes(tree)
    missing = jax.tree.map(np.zeros_like, tree)
    del missing["deep"]["dense_2"]
    with pytest.raises(ValueError, match="keys differ"):
        pser.from_bytes(missing, data)
    extra = jax.tree.map(np.zeros_like, tree)
    extra["deep"]["dense_9"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="keys differ"):
        pser.from_bytes(extra, data)
    shape = jax.tree.map(np.zeros_like, tree)
    shape["deep"]["dense_1"]["kernel"] = np.zeros((16, 9), np.float32)
    with pytest.raises(ValueError, match="shape"):
        pser.from_bytes(shape, data)
    leaf = jax.tree.map(np.zeros_like, tree)
    leaf["din"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="expected an array"):
        pser.from_bytes(leaf, data)
    node = jax.tree.map(np.zeros_like, tree)
    node["deep"]["dense_0"]["bias"] = {"x": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="expected a map"):
        pser.from_bytes(node, data)


def test_reader_refuses_what_it_does_not_know():
    data = pser.to_bytes({"a": 1})
    with pytest.raises(ValueError, match="bytes follow"):
        pser.msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        pser.msgpack_restore(pser.to_bytes({"a": np.ones(8)})[:-3])
    import msgpack
    with pytest.raises(ValueError, match="ext type 2"):
        pser.msgpack_restore(fser.to_bytes({"c": complex(1, 2)}))
    with pytest.raises(ValueError, match="map keys must be str"):
        pser.msgpack_restore(msgpack.packb({1: 2}))
    with pytest.raises(TypeError, match="map keys must be str"):
        pser.to_bytes({1: 2})
    with pytest.raises(TypeError, match="cannot serialize"):
        pser.to_bytes({"a": [1, 2]})


def test_chunked_arrays_are_refused_both_ways(monkeypatch):
    """flax splits a leaf above 2^30 bytes into chunks; the port neither
    reads nor writes that form (no dense parameter is that large). The
    limit is lowered here so that a small array stands for a giant."""
    arr = np.arange(64, dtype=np.float32)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    chunked = fser.to_bytes({"w": arr})
    with pytest.raises(ValueError, match="chunked"):
        pser.msgpack_restore(chunked)
    monkeypatch.setattr(pser, "_MAX_LEAF_BYTES", 64)
    with pytest.raises(ValueError, match="chunked"):
        pser.to_bytes({"w": arr})


# ----------------------------------------------------------------------
# codec and framing: the port's copies against the JAX package's
# ----------------------------------------------------------------------

PAYLOAD = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
           "v": np.linspace(0, 1, 5, dtype=np.float32), "s": "hello",
           "i": 42, "f": 2.5, "b": b"\x00\x01", "t": True,
           "n": np.int32(-3), "e": np.zeros((0, 2), np.float16)}


def test_codec_round_trip_and_bytes_equal_jax():
    data = pcodec.pack(PAYLOAD)
    assert data == jcodec.pack(PAYLOAD)
    for unpack in (pcodec.unpack, jcodec.unpack):
        out = unpack(data)
        assert sorted(out) == sorted(PAYLOAD)
        np.testing.assert_array_equal(out["a"], PAYLOAD["a"])
        np.testing.assert_array_equal(out["v"], PAYLOAD["v"])
        assert out["e"].shape == (0, 2) and out["e"].dtype == np.float16
        assert out["s"] == "hello" and out["i"] == 42 and out["t"] == 1
        assert out["f"] == 2.5 and out["b"] == b"\x00\x01" and out["n"] == -3


def test_codec_rejects_an_unknown_type():
    with pytest.raises(TypeError, match="unsupported payload type"):
        pcodec.pack({"x": [1, 2]})
    with pytest.raises(ValueError, match="bad type tag"):
        pcodec.unpack(b"\x01\x00\x00\x00\x01\x00k\x09")


@pytest.mark.parametrize("has_sort_id", [False, True])
def test_framing_round_trip_and_bytes_equal_jax(has_sort_id):
    records = [(b"id%d" % i if has_sort_id else b"", bytes([i]) * (i * 7))
               for i in range(5)]
    bufs = []
    for mod in (pframing, jframing):
        f = io.BytesIO()
        w = mod.RecordWriter(f, has_sort_id=has_sort_id)
        for sid, payload in records:
            w.write(payload, sort_id=sid)
        w.flush()
        bufs.append(f.getvalue())
    assert bufs[0] == bufs[1]
    for mod in (pframing, jframing):
        got = list(mod.RecordReader(io.BytesIO(bufs[0]),
                                    has_sort_id=has_sort_id))
        assert got == records
    # a truncated tail is dropped, not raised
    cut = list(pframing.RecordReader(io.BytesIO(bufs[0][:-3]),
                                     has_sort_id=has_sort_id))
    assert cut == records[:-1]


def test_framing_reads_the_kafka_headers():
    f = io.BytesIO()
    f.write((0).to_bytes(8, "little"))           # kafka_dump_prefix header
    for payload in (b"abc", b"defg"):
        f.write((1).to_bytes(8, "little"))       # kafka_dump record header
        f.write(len(payload).to_bytes(8, "little"))
        f.write(payload)
    for mod in (pframing, jframing):
        got = list(mod.RecordReader(io.BytesIO(f.getvalue()), kafka_dump=True,
                                    kafka_dump_prefix=True))
        assert got == [(b"", b"abc"), (b"", b"defg")]

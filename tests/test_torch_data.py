"""The port's data pipeline against the JAX package's, on the CPU: the
`Example` codec, framed files, the reference's protobuf formats, the
sources (files with resume, Parquet, Kafka through a fake consumer, the
queue), flow control, prefetch, batching and MovieLens ingestion.

Every module here is a copy (numpy and stdlib only), so every comparison is
exact: the same seeded inputs go through both packages, and bytes, arrays
and positions must be equal. Bytes written by either package are decoded
by the other.
"""

import dataclasses
import io
import os

import numpy as np
import pytest

from monolith_tpu.data import datasets as jds
from monolith_tpu.data import example as jex
from monolith_tpu.data import framing as jfr
from monolith_tpu.data import movielens as jml
from monolith_tpu.data import pb_compat as jpb
from monolith_tpu.data import prefetch as jpf
from monolith_tpu_torch.data import datasets as pds
from monolith_tpu_torch.data import example as pex
from monolith_tpu_torch.data import framing as pfr
from monolith_tpu_torch.data import movielens as pml
from monolith_tpu_torch.data import pb_compat as ppb
from monolith_tpu_torch.data import prefetch as ppf


def fid_arr(fids):
    # v2 fids set bit 63; route through uint64 to the int64 bit pattern
    return np.array(fids, np.uint64).astype(np.int64)


def make_examples(mod, n, seed=0, v1_slots=False):
    """n seeded Examples of package `mod` (its example module): ragged fid
    lists (some empty), dense features, two labels, weights and LineIds.
    With v1_slots the fid features are "slot_<k>" with v1 fids of slot k
    (the Instance format's top-level fids)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if v1_slots:
            feats = {f"slot_{k}": np.array(
                [mod.make_fid_v1(k, int(s)) for s in
                 rng.integers(0, 1 << 40, rng.integers(1, 4))], np.int64)
                for k in (3, 7)}
        else:
            feats = {"user_id": fid_arr([mod.make_fid_v2(1, int(
                         rng.integers(0, 1 << 40)))]),
                     "hist": fid_arr([mod.make_fid_v2(2, int(s)) for s in
                                      rng.integers(0, 1000,
                                                   rng.integers(0, 5))])}
        out.append(mod.Example(
            features=feats,
            dense={"ctx": rng.normal(size=2).astype(np.float32)},
            labels=rng.integers(0, 2, 2).astype(np.float32),
            instance_weight=float(np.float32(rng.uniform(0.5, 2.0))),
            line_id=mod.LineId(uid=int(rng.integers(0, 1 << 62)),
                               item_id=int(rng.integers(0, 1 << 62)),
                               req_time=int(rng.integers(0, 1 << 40)),
                               sample_rate=0.5, chnid=int(i % 3),
                               actions=[int(a) for a in
                                        rng.integers(0, 9, i % 3)],
                               user_id=f"u{i}", data_source_name="ds")))
    return out


def assert_examples_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x.features) == sorted(y.features)
        for k in x.features:
            np.testing.assert_array_equal(x.features[k], y.features[k])
            assert x.features[k].dtype == y.features[k].dtype
        assert sorted(x.dense) == sorted(y.dense)
        for k in x.dense:
            np.testing.assert_array_equal(x.dense[k], y.dense[k])
        np.testing.assert_array_equal(x.labels, y.labels)
        assert x.instance_weight == y.instance_weight
        assert dataclasses.asdict(x.line_id) == dataclasses.asdict(y.line_id)


def batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (fa, ba), (fb, bb) in zip(a, b):
        assert sorted(fa) == sorted(fb) and sorted(ba) == sorted(bb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
            assert fa[k].dtype == fb[k].dtype
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])
            assert ba[k].dtype == bb[k].dtype


# ----------------------------------------------------------------------
# Example codec and fid encoding
# ----------------------------------------------------------------------

def test_example_bytes_equal_and_cross_decode():
    je, pe = make_examples(jex, 12), make_examples(pex, 12)
    for a, b in zip(je, pe):
        assert a.to_bytes() == b.to_bytes()
    assert_examples_equal([pex.Example.from_bytes(e.to_bytes()) for e in je],
                          je)
    assert_examples_equal([jex.Example.from_bytes(e.to_bytes()) for e in pe],
                          pe)


def test_example_bad_magic_raises():
    with pytest.raises(ValueError):
        pex.Example.from_bytes(b"XXXX" + b"\x00" * 10)


def test_fid_encoding_equal():
    rng = np.random.default_rng(1)
    for slot, sig in zip(rng.integers(0, 1 << 10, 64),
                         rng.integers(0, 1 << 62, 64)):
        slot, sig = int(slot), int(sig)
        assert pex.make_fid_v1(slot, sig) == jex.make_fid_v1(slot, sig)
        assert pex.slot_of_fid_v1(pex.make_fid_v1(slot, sig)) == slot
        v2 = pex.make_fid_v2(slot, sig)
        assert v2 == jex.make_fid_v2(slot, sig)
        assert pex.slot_of_fid_v2(v2) == jex.slot_of_fid_v2(v2) == slot


def test_batch_examples_equal():
    je, pe = make_examples(jex, 9, seed=2), make_examples(pex, 9, seed=2)
    lengths = {"user_id": 1, "hist": 3, "absent": 2}
    batches_equal([jex.batch_examples(je, lengths, dense_keys=["ctx"])],
                  [pex.batch_examples(pe, lengths, dense_keys=["ctx"])])


# ----------------------------------------------------------------------
# framed files
# ----------------------------------------------------------------------

@pytest.mark.parametrize("has_sort_id", [False, True])
def test_framed_files_byte_equal_and_cross_read(tmp_path, has_sort_id):
    jp, pp = str(tmp_path / "j.rec"), str(tmp_path / "p.rec")
    assert jfr.write_example_file(jp, make_examples(jex, 10, seed=3),
                                  has_sort_id=has_sort_id) == 10
    assert pfr.write_example_file(pp, make_examples(pex, 10, seed=3),
                                  has_sort_id=has_sort_id) == 10
    with open(jp, "rb") as f, open(pp, "rb") as g:
        assert f.read() == g.read()
    assert_examples_equal(
        list(pfr.read_example_file(jp, has_sort_id=has_sort_id)),
        list(jfr.read_example_file(pp, has_sort_id=has_sort_id)))


def test_record_reader_drops_a_truncated_tail():
    for mod in (jfr, pfr):
        buf = io.BytesIO()
        w = mod.RecordWriter(buf)
        w.write(b"abc")
        w.write(b"defgh")
        data = buf.getvalue()[:-2]
        assert list(mod.RecordReader(io.BytesIO(data))) == [(b"", b"abc")]


def _pb_batch_file(path, pkg, n_records=5, per_record=7):
    """A framed file of `pb_example_batch` records written by one package
    (`pkg` = (example, framing, pb_compat) modules)."""
    ex_mod, fr_mod, pb_mod = pkg
    exs = make_examples(ex_mod, n_records * per_record, seed=4)
    with open(path, "wb") as f:
        w = fr_mod.RecordWriter(f)
        for r in range(n_records):
            w.write(pb_mod.encode_example_batch(
                exs[r * per_record:(r + 1) * per_record]))


PORT, JAX = (pex, pfr, ppb), (jex, jfr, jpb)


@pytest.mark.parametrize("skip", [(0, 0), (2, 0), (2, 3), (4, 6)])
def test_read_example_records_frame_skips(tmp_path, skip):
    jp, pp = str(tmp_path / "j.rec"), str(tmp_path / "p.rec")
    _pb_batch_file(jp, JAX)
    _pb_batch_file(pp, PORT)
    with open(jp, "rb") as f, open(pp, "rb") as g:
        assert f.read() == g.read()
    rec, ex = skip
    got = list(pfr.read_example_records(pp, fmt="pb_example_batch",
                                        skip_records=rec, skip_examples=ex))
    ref = list(jfr.read_example_records(jp, fmt="pb_example_batch",
                                        skip_records=rec, skip_examples=ex))
    assert [(r, e) for r, e, _ in got] == [(r, e) for r, e, _ in ref]
    assert_examples_equal([x for _, _, x in got], [x for _, _, x in ref])
    assert got[0][:2] == (rec, ex)


def test_records_before_the_skip_are_never_decoded(tmp_path, monkeypatch):
    path = str(tmp_path / "p.rec")
    _pb_batch_file(path, PORT)
    calls = []
    real = ppb.parse_example_batch
    monkeypatch.setattr(ppb, "parse_example_batch",
                        lambda b: calls.append(1) or real(b))
    out = list(pfr.read_example_records(path, fmt="pb_example_batch",
                                        skip_records=3))
    assert len(calls) == 2 and len(out) == 14


# ----------------------------------------------------------------------
# the reference's protobuf formats
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["example", "instance", "example_batch"])
def test_pb_encode_equal_and_parse_both_ways(fmt):
    v1 = fmt == "instance"
    je = make_examples(jex, 6, seed=5, v1_slots=v1)
    pe = make_examples(pex, 6, seed=5, v1_slots=v1)
    if fmt == "example_batch":
        jb, pb_ = jpb.encode_example_batch(je), ppb.encode_example_batch(pe)
        assert jb == pb_
        assert_examples_equal(ppb.parse_example_batch(jb),
                              jpb.parse_example_batch(pb_))
        return
    enc, parse = f"encode_{fmt}", f"parse_{fmt}"
    for a, b in zip(je, pe):
        jb, pb_ = getattr(jpb, enc)(a), getattr(ppb, enc)(b)
        assert jb == pb_
        assert_examples_equal([getattr(ppb, parse)(jb)],
                              [getattr(jpb, parse)(pb_)])


def test_pb_line_id_both_ways():
    for a, b in zip(make_examples(jex, 5, seed=6), make_examples(pex, 5,
                                                               seed=6)):
        jb, pb_ = jpb.encode_line_id(a.line_id), ppb.encode_line_id(b.line_id)
        assert jb == pb_
        assert (dataclasses.asdict(ppb.parse_line_id(jb))
                == dataclasses.asdict(jpb.parse_line_id(pb_)))


def test_pb_instance_slot_selection_equal():
    pe = make_examples(pex, 4, seed=7, v1_slots=True)
    for b in pe:
        data = ppb.encode_instance(b)
        kw = dict(fidv1_features=[7], fidv1_feature_names=["seven"])
        assert_examples_equal([ppb.parse_instance(data, **kw)],
                              [jpb.parse_instance(data, **kw)])


# ----------------------------------------------------------------------
# sources
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt,take", [("mtex", 9), ("pb_example_batch", 9),
                                      ("pb_example_batch", 14)])
def test_file_source_state_and_resume_equal(tmp_path, fmt, take):
    """Two files; stop after `take` examples (mid-record for the batch
    format), resume a fresh source from state(): the positions and the
    rest of the stream equal the JAX package's, and the union is the
    whole stream."""
    for k in range(2):
        path = str(tmp_path / f"part-{k}.rec")
        if fmt == "mtex":
            pfr.write_example_file(path, make_examples(pex, 10, seed=10 + k))
        else:
            _pb_batch_file(path, PORT, n_records=2, per_record=5)
    pattern = str(tmp_path / "part-*.rec")
    srcs = {"p": pds.FileSource(pattern, fmt=fmt),
            "j": jds.FileSource(pattern, fmt=fmt)}
    heads, states = {}, {}
    for k, src in srcs.items():
        it = iter(src)
        heads[k] = [next(it) for _ in range(take)]
        states[k] = src.state()
    assert states["p"] == states["j"]
    assert_examples_equal(heads["p"], heads["j"])
    rest = {}
    for k, cls in (("p", pds.FileSource), ("j", jds.FileSource)):
        src = cls(pattern, fmt=fmt)
        src.set_state(states[k])
        rest[k] = list(src)
    assert_examples_equal(rest["p"], rest["j"])
    assert_examples_equal(heads["p"] + rest["p"],
                          list(pds.FileSource(pattern, fmt=fmt)))
    assert srcs["p"].state() == srcs["j"].state()


def test_file_source_repeat_and_legacy_state(tmp_path):
    pfr.write_example_file(str(tmp_path / "a.rec"), make_examples(pex, 3))
    for cls in (pds.FileSource, jds.FileSource):
        it = iter(cls(str(tmp_path / "a.rec"), repeat=True))
        assert len([next(it) for _ in range(7)]) == 7
    legacy = {"epoch": 0, "file_idx": 0, "record_idx": 2}
    out = {}
    for k, cls in (("p", pds.FileSource), ("j", jds.FileSource)):
        src = cls(str(tmp_path / "a.rec"))
        src.set_state(dict(legacy))
        out[k] = list(src)
    assert len(out["p"]) == 1
    assert_examples_equal(out["p"], out["j"])


def test_parquet_source_equal(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(8)
    n = 23
    items = [[int(x) for x in rng.integers(0, 1 << 50, rng.integers(0, 4))]
             for _ in range(n)]
    items[3] = None
    t = pa.table({"uid": pa.array(rng.integers(0, 1 << 60, n), pa.int64()),
                  "items": pa.array(items, pa.list_(pa.int64())),
                  "price": pa.array(rng.normal(size=n), pa.float32()),
                  "label": pa.array(rng.integers(0, 2, n).astype(np.float32),
                                    pa.float32())})
    path = str(tmp_path / "d.parquet")
    pq.write_table(t, path, row_group_size=8)
    kw = dict(fid_columns={"user_id": "uid", "items": "items"},
              label_column="label", dense_columns={"price": "price"},
              batch_rows=5)
    got = list(pds.ParquetSource(path, **kw))
    assert len(got) == n and got[3].features["items"].size == 0
    assert_examples_equal(got, list(jds.ParquetSource(path, **kw)))


class _FakeMessage:
    def __init__(self, value=None, error=None):
        self._value, self._error = value, error

    def value(self):
        return self._value

    def error(self):
        return self._error


class _FakeConsumer:
    """Stands in for confluent_kafka.Consumer (not installed here)."""

    def __init__(self, conf, messages):
        self.conf, self.messages = conf, list(messages)
        self.subscribed, self.closed = None, False

    def subscribe(self, topics):
        self.subscribed = topics

    def poll(self, timeout):
        return self.messages.pop(0) if self.messages else None

    def close(self):
        self.closed = True


@pytest.mark.parametrize("fmt", ["mtex", "pb_example", "pb_instance",
                                 "pb_example_batch"])
def test_kafka_source_through_a_fake_consumer(fmt):
    exs = make_examples(pex, 6, seed=9, v1_slots=fmt == "pb_instance")
    encode = {"mtex": lambda e: e.to_bytes(),
              "pb_example": ppb.encode_example,
              "pb_instance": ppb.encode_instance}
    if fmt == "pb_example_batch":
        payloads = [ppb.encode_example_batch(exs[:4]),
                    ppb.encode_example_batch(exs[4:])]
    else:
        payloads = [encode[fmt](e) for e in exs]
    msgs = [_FakeMessage(value=p) for p in payloads]
    msgs.insert(1, _FakeMessage(error="broker hiccup"))  # skipped
    out, consumers = {}, {}
    for k, cls in (("p", pds.KafkaSource), ("j", jds.KafkaSource)):
        def factory(conf, k=k):
            consumers[k] = _FakeConsumer(conf, msgs)
            return consumers[k]
        out[k] = list(cls(["topic-a"], group_id="g", brokers="b:9092",
                          poll_timeout_s=0.001, stop_on_idle_s=0.002,
                          fmt=fmt, consumer_factory=factory))
    assert len(out["p"]) == 6
    assert_examples_equal(out["p"], out["j"])
    c = consumers["p"]
    assert c.subscribed == ["topic-a"] and c.closed
    assert c.conf == consumers["j"].conf


def test_kafka_source_without_confluent_kafka_raises():
    try:
        import confluent_kafka  # noqa: F401
        pytest.skip("confluent_kafka is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="consumer_factory"):
        pds.KafkaSource(["t"], group_id="g", brokers="b")


def test_queue_source():
    q = pds.QueueSource()
    exs = make_examples(pex, 3)
    for e in exs:
        q.push(e)
    q.close()
    assert_examples_equal(list(q), exs)


def test_split_and_merge_flow_equal():
    out = {}
    for k, mod, ds in (("p", pex, pds), ("j", jex, jds)):
        exs = make_examples(mod, 17, seed=11)
        flows = ds.split_flow(exs, 3, lambda e: int(e.line_id.chnid))
        first = [next(flows[1]) for _ in range(2)]
        out[k] = first + list(ds.merge_flow(flows))
    assert len(out["p"]) == 17
    assert_examples_equal(out["p"], out["j"])
    assert [e.line_id.chnid for e in out["p"][:2]] == [1, 1]


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batched_dataset_equal(drop_remainder):
    lengths = {"user_id": 1, "hist": 2}
    got = list(pds.BatchedDataset(make_examples(pex, 10, seed=12), 4, lengths,
                                  dense_keys=["ctx"],
                                  drop_remainder=drop_remainder))
    assert len(got) == (2 if drop_remainder else 3)
    batches_equal(got, jds.BatchedDataset(make_examples(jex, 10, seed=12), 4,
                                          lengths, dense_keys=["ctx"],
                                          drop_remainder=drop_remainder))


def test_prefetch_equal_and_reraises():
    assert list(ppf.prefetch(range(50), size=3)) == list(
        jpf.prefetch(range(50), size=3))

    def failing():
        yield 1
        raise KeyError("worker failed")

    it = ppf.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="worker failed"):
        next(it)


# ----------------------------------------------------------------------
# MovieLens
# ----------------------------------------------------------------------

def test_generate_sample_bytes_equal(tmp_path):
    jp = jml.generate_sample(str(tmp_path / "j" / "ratings.dat"),
                             num_users=40, num_items=30, num_ratings=900,
                             seed=3)
    pp = pml.generate_sample(str(tmp_path / "p" / "ratings.dat"),
                             num_users=40, num_items=30, num_ratings=900,
                             seed=3)
    with open(jp, "rb") as f, open(pp, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("split,threshold", [("train", 4.0), ("eval", 4.0),
                                             ("all", 0.0)])
def test_movielens_batches_equal(tmp_path, split, threshold):
    path = pml.generate_sample(str(tmp_path / "ratings.dat"), num_users=40,
                               num_items=30, num_ratings=1000, seed=4)
    kw = dict(path=path, batch_size=32, label_threshold=threshold,
              split=split, eval_fraction=0.2, seed=5, epochs=2)
    got = list(pml.MovieLensRatings(**kw))
    assert len(got) == 2 * ({"train": 800, "eval": 200, "all": 1000}[split]
                            // 32)
    batches_equal(got, jml.MovieLensRatings(**kw))
    assert len(pml.MovieLensRatings(**kw)) == len(jml.MovieLensRatings(**kw))


def test_load_ratings_formats(tmp_path):
    ml100k = tmp_path / "u.data"
    ml100k.write_text("userId\titemId\trating\tts\n"  # header skipped
                      "1\t10\t5\t881250949\n2\t20\t2\t891717742\n")
    a, b = pml.load_ratings(str(ml100k)), jml.load_ratings(str(ml100k))
    for k in ("user", "item", "rating", "ts"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    vendored = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "movielens", "ratings.dat")
    assert len(pml.load_ratings(vendored)["user"]) == 80_000


def test_parity_configuration_and_frozen_batches_equal_jax():
    """The port's side of the AUC head-to-head reads the same frozen
    configuration and batches as the JAX package's."""
    from monolith_tpu import parity as jparity
    from monolith_tpu_torch import parity as pparity
    assert {k: v for k, v in pparity.PARITY.items() if k != "caps"} == \
        jparity.PARITY
    assert pparity.PARITY_BAND == jparity.PARITY_BAND
    cfg = {**pparity.PARITY, "steps": 3, "eval_steps": 2}
    (pt, pe), (jt, je) = pparity.frozen_data(cfg), jparity.frozen_data(cfg)
    batches_equal(pt, jt)
    batches_equal(pe, je)

"""The rest of the port's data utilities against the JAX package's on the
same inputs (the inputs of tests/test_data.py and tests/test_infra.py, and
seeded streams beside them): every transform, the item pool and negative
generation, the feature list, cap tuning and alerts, bit for bit."""

import dataclasses
import json

import numpy as np
import pytest

from monolith_tpu.data import example as jexample
from monolith_tpu.data import feature_list as jfl
from monolith_tpu.data import item_pool as jpool
from monolith_tpu.data import transforms as jtransforms
from monolith_tpu.utils import alerts as jalerts
from monolith_tpu.utils import tuning as jtuning
from monolith_tpu_torch import data as pdata
from monolith_tpu_torch.data import example as pexample
from monolith_tpu_torch.data import feature_list as pfl
from monolith_tpu_torch.data import item_pool as ppool
from monolith_tpu_torch.data import transforms as ptransforms
from monolith_tpu_torch.utils import alerts as palerts
from monolith_tpu_torch.utils import tuning as ptuning

PACKAGES = {"jax": (jexample, jtransforms, jpool),
            "port": (pexample, ptransforms, ppool)}


def stream(package, n=240, seed=0):
    """`n` Examples of one seeded stream in `package`: 1-4 v1 fids of
    slot 3 in "f", an "item" fid, labels in {0, 0.5, 1, 1.5}, 0-2 actions
    of 1-9, a channel of 0-3, a dense "x" on most and a "rating" on some."""
    ex_mod = PACKAGES[package][0]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 5))
        fids = np.asarray([ex_mod.make_fid_v1(3, int(s))
                           for s in rng.integers(1, 12, size=k)], np.int64)
        dense = {}
        if rng.random() < 0.8:
            dense["x"] = rng.normal(size=2).astype(np.float32)
        if rng.random() < 0.5:
            dense["rating"] = np.asarray([rng.integers(1, 6)], np.float32)
        out.append(ex_mod.Example(
            features={"f": fids,
                      "item": np.asarray([rng.integers(100, 120)], np.int64)},
            dense=dense,
            labels=np.asarray([rng.integers(0, 4) * 0.5], np.float32),
            instance_weight=float(rng.integers(1, 3)),
            line_id=ex_mod.LineId(
                chnid=int(rng.integers(0, 4)),
                actions=[int(a) for a in rng.integers(
                    1, 10, size=int(rng.integers(0, 3)))],
                uid=int(rng.integers(0, 1000)))))
    return out


def dump(ex):
    """Everything an Example holds, with each array's dtype and bytes."""
    def arrays(d):
        return sorted((k, np.asarray(v).dtype.str, np.asarray(v).tobytes())
                      for k, v in d.items())
    lid = dataclasses.asdict(ex.line_id)
    lid["actions"] = [int(a) for a in lid["actions"]]
    return (arrays(ex.features), arrays(ex.dense),
            np.asarray(ex.labels).dtype.str, np.asarray(ex.labels).tobytes(),
            repr(ex.instance_weight), sorted(lid.items()))


#: (id, the transform applied to a stream with that package's module)
CASES = [
    ("filter_by_fids_has", lambda T, s: T.filter_by_fids(
        s, has_fids=[int(pexample.make_fid_v1(3, 1))])),
    ("filter_by_fids_filter", lambda T, s: T.filter_by_fids(
        s, filter_fids=[int(pexample.make_fid_v1(3, 2))])),
    ("filter_by_fids_select", lambda T, s: T.filter_by_fids(
        s, select_fids=[int(pexample.make_fid_v1(3, 4)),
                        int(pexample.make_fid_v1(3, 5))])),
    *[(f"filter_by_feature_value_{op}",
       lambda T, s, op=op: T.filter_by_feature_value(s, "rating", op,
                                                     3.0))
      for op in ("gt", "ge", "lt", "le", "eq", "neq")],
    ("filter_by_label", lambda T, s: T.filter_by_label(s, [0.75])),
    ("negative_sample", lambda T, s: T.negative_sample(s, drop_rate=0.75,
                                                       seed=1)),
    ("negative_sample_no_reweight", lambda T, s: T.negative_sample(
        s, drop_rate=0.5, seed=2, reweight_dropped=False)),
    ("special_strategy", lambda T, s: T.special_strategy(
        s, {0: 0.5, 2: 0.1}, seed=3)),
    ("add_label", lambda T, s: T.add_label(
        s, ["2|3:5", "7:1|4"], negative_value=-1.0, sample_rate=0.5,
        seed=4)),
    ("scatter_label", lambda T, s: T.scatter_label(s, {7: 0, 8: 2},
                                                   num_heads=3)),
    ("label_upper_bound", lambda T, s: T.label_upper_bound(s, [0.7])),
    ("label_normalization", lambda T, s: T.label_normalization(s,
                                                               np.log1p)),
    ("use_field_as_label", lambda T, s: T.use_field_as_label(s, "rating")),
    ("use_field_as_label_overwrite", lambda T, s: T.use_field_as_label(
        s, "rating", overwrite_invalid=True, label_threshold=0.25)),
    ("switch_slot", lambda T, s: T.switch_slot(s, "f", slot=9)),
    ("feature_combine", lambda T, s: T.feature_combine(s, "f", "item",
                                                       "fi", slot=7)),
    ("feature_combine_missing", lambda T, s: T.feature_combine(
        s, "f", "nope", "fi", slot=7)),
    ("map_id", lambda T, s: T.map_id(
        s, "item", {100 + i: 1000 + i for i in range(0, 20, 2)}, default=-7)),
    ("instance_reweight", lambda T, s: T.instance_reweight(
        s, {1: 3, 2: 0}, default_weight=2)),
    *[(f"add_action_{op}",
       lambda T, s, op=op, arg=arg: T.add_action(s, "chnid", op, arg, 77))
      for op, arg in (("gt", 1), ("ge", 2), ("eq", 1), ("lt", 2), ("le", 1),
                      ("neq", 0), ("between", [1, 3]), ("in", [0, 3]))],
    ("multi_label_gen", lambda T, s: T.multi_label_gen(
        s, {1: 0, 2: 1}, pos_actions=[3, 4], neg_actions=[5])),
    ("multi_label_gen_no_neg", lambda T, s: T.multi_label_gen(
        s, {0: 0, 3: 2}, pos_actions=[1], pos_label=2.0, neg_label=-0.5,
        task_num=4)),
    ("multi_label_gen_origin", lambda T, s: T.multi_label_gen(
        s, {1: 0, 3: 1}, use_origin_label=True)),
]


@pytest.mark.parametrize("case", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_transform_equals_jax(case):
    theirs = [dump(e) for e in case(jtransforms, iter(stream("jax")))]
    mine = [dump(e) for e in case(ptransforms, iter(stream("port")))]
    assert mine == theirs and mine


def test_transform_arguments_refused_alike():
    for T in (jtransforms, ptransforms):
        with pytest.raises(ValueError):
            list(T.add_action(iter([]), "chnid", "like", 1, 2))
        with pytest.raises(ValueError):
            list(T.multi_label_gen(iter([]), {1: 0}))
        with pytest.raises(ValueError):
            list(T.multi_label_gen(iter([]), {1: 0}, pos_actions=[1],
                                   use_origin_label=True))


def test_gen_fid_mask_equals_jax():
    fids = np.array([[1, 2, -1], [3, 4, -1], [2, 2, 2]], np.int64)
    for fid in (2, 3, 9):
        a = jtransforms.gen_fid_mask(fids, fid)
        b = ptransforms.gen_fid_mask(fids, fid)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_the_jax_data_tests_inputs():
    """tests/test_data.py's own inputs through the port: the same
    answers."""
    E, L = pexample.Example, pexample.LineId

    def ex(fids=(1, 2), label=1.0, actions=(), dense=None):
        return E(features={"f": np.asarray(fids, np.int64)},
                 dense={k: np.asarray(v, np.float32)
                        for k, v in (dense or {}).items()},
                 labels=np.asarray([label], np.float32),
                 line_id=L(actions=list(actions)))
    T = ptransforms
    assert len(list(T.filter_by_fids([ex([1, 2]), ex([3])],
                                     has_fids=[1]))) == 1
    out = list(T.add_label([ex(actions=[2]), ex(actions=[5]),
                            ex(actions=[9])], ["2|3:5"], sample_rate=1.0))
    assert [e.labels[0] for e in out] == [1.0, 0.0, 0.0]
    out = list(T.map_id([ex(fids=[1, 2, 3])], "f", {1: 100, 2: 200}))
    np.testing.assert_array_equal(out[0].features["f"], [100, 200, -1])
    assert len(list(T.instance_reweight(
        [ex(actions=[1]), ex(actions=[2]), ex(actions=[])],
        {1: 3, 2: 0}))) == 4
    out = list(T.switch_slot([ex(fids=[pexample.make_fid_v1(3, 100)])],
                             "f", slot=9))
    assert pexample.slot_of_fid_v1(int(out[0].features["f"][0])) == 9


# ----------------------------------------------------------------------
# item pool and negative generation
# ----------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("positives_only", [True, False])
def test_negative_gen_equals_jax(per_channel, positives_only):
    outs = []
    for package in ("jax", "port"):
        mod = PACKAGES[package][2]
        pool = mod.ItemPool(max_items_per_channel=6, seed=5)
        out = list(mod.negative_gen(
            iter(stream(package, n=120, seed=8)), pool, ["item"], neg_num=2,
            per_channel=per_channel, negative_label=-1.0,
            pool_add_positives_only=positives_only, seed=0))
        outs.append(([dump(e) for e in out], pool.size(),
                     [pool.size(c) for c in range(4)]))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_item_pool_files_cross_the_packages(tmp_path, writer):
    """A pool saved by either package restores in the other; reservoir
    contents and later samples agree."""
    w = PACKAGES[writer][2]
    r = PACKAGES["port" if writer == "jax" else "jax"][2]
    pool = w.ItemPool(max_items_per_channel=4, seed=0)
    for i in range(100):
        pool.add(i % 3, {"item": np.array([i], np.int64),
                         "cat": np.array([i % 7, i % 5], np.int64)})
    pool.save(str(tmp_path / "pool"))
    back, again = r.ItemPool(seed=9), w.ItemPool(seed=9)
    back.restore(str(tmp_path / "pool"))
    again.restore(str(tmp_path / "pool"))
    assert back.max_items == 4 and back.size() == 12
    for ch in range(3):
        assert back.size(ch) == 4
        a, b = back.sample(ch, 5), again.sample(ch, 5)
        assert [sorted((k, v.tobytes()) for k, v in d.items()) for d in a] \
            == [sorted((k, v.tobytes()) for k, v in d.items()) for d in b]
    assert back.sample(7, 3) == [] and again.sample(7, 3) == []


def test_reservoir_equals_jax():
    pools = [PACKAGES[p][2].ItemPool(max_items_per_channel=4, seed=0)
             for p in ("jax", "port")]
    for pool in pools:
        for i in range(100):
            pool.add(1, {"item": np.array([i], np.int64)})
    assert [int(d["item"][0]) for d in pools[0]._pools[1]] == \
        [int(d["item"][0]) for d in pools[1]._pools[1]]
    assert pools[1].size(1) == 4 and pools[1]._seen == {1: 100}


# ----------------------------------------------------------------------
# the feature list
# ----------------------------------------------------------------------

FEATURE_LIST = """\
# demo feature list
column_name: user, item, context
cache_column: uid_cache
cache_column: second
feature_name=f_uid slot=1 method=DirectString depend=user occurrence_threshold=3
feature_name=fc_clicks slot=200 method=Seq depend=user,item max_seq_len=20 shared=true
feature_name=fc_a-fc_b slot=201 method=Combine depend=a,b args=x, y
feature_name=f_plain slot=1 need_raw=yes expire_time=7 custom=abc feature_version=2

no_feature_name=1 slot=9
"""


def test_feature_list_equals_jax(tmp_path):
    p = tmp_path / "fl.conf"
    p.write_text(FEATURE_LIST)
    mine, theirs = pfl.FeatureList.parse(str(p)), jfl.FeatureList.parse(str(p))
    assert len(mine) == len(theirs) == 4
    assert mine.column_name == theirs.column_name
    assert mine.cache_columns == theirs.cache_columns == ["uid_cache",
                                                          "second"]
    assert {k: dataclasses.asdict(v) for k, v in mine.features.items()} == \
        {k: dataclasses.asdict(v) for k, v in theirs.features.items()}
    for key in ("uid", "f_uid", "clicks", "a-b", "fc_a-fc_b", 200, 1, 201,
                "plain"):
        assert dataclasses.asdict(mine[key]) == \
            dataclasses.asdict(theirs[key]), key
        assert key in mine
    for key in ("nope", 5):
        assert key not in mine and mine.get(key) is None
        with pytest.raises(KeyError):
            mine[key]
    assert [f.feature_name for f in mine.get_with_slot(1)] == \
        [f.feature_name for f in theirs.get_with_slot(1)] == ["f_uid",
                                                              "f_plain"]
    assert [f.name for f in mine] == [f.name for f in theirs]
    for kw in ({}, {"table": "t", "default_max_length": 3,
                    "combiner": "mean"}):
        a = mine.to_feature_configs(**kw)
        b = theirs.to_feature_configs(**kw)
        fields = [f.name for f in dataclasses.fields(a[0])]
        assert [dataclasses.asdict(c) for c in a] == \
            [{k: getattr(c, k) for k in fields} for c in b]
    assert mine["clicks"].shared is True and mine["plain"].need_raw is True
    assert mine["plain"].extra == {"custom": "abc"}


# ----------------------------------------------------------------------
# cap tuning
# ----------------------------------------------------------------------

def _batches(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [{"a": rng.integers(-1, 500, size=(64, 3)).astype(np.int64),
             "b": rng.integers(0, 200, size=(64, 1)).astype(np.int64),
             "c": rng.integers(-1, 3000, size=(256, 5)).astype(np.int64)}
            for _ in range(n)]


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_tuning_equals_jax(num_shards):
    tf = {"t1": ["a"], "t2": ["b"], "t3": ["a", "c"], "none": ["zz"]}
    m = ptuning.measure_unique_counts(_batches(), tf, num_shards)
    assert m == jtuning.measure_unique_counts(_batches(), tf, num_shards)
    assert "none" not in m and 0 < m["t2"] <= 64
    for headroom in (1.0, 1.25, 2.0):
        caps = ptuning.suggest_caps(_batches(), tf, num_shards, headroom)
        assert caps == jtuning.suggest_caps(_batches(), tf, num_shards,
                                            headroom)
        assert all(c % 128 == 0 and c >= m[t] for t, c in caps.items())


def test_tuning_flags_the_compact_wire_alike():
    big = {"a": np.arange(70000, dtype=np.int64).reshape(-1, 1)}
    for tuning in (ptuning, jtuning):
        with pytest.raises(ValueError, match="compact-wire"):
            tuning.suggest_caps([big], {"t": ["a"]})
    assert ptuning.suggest_caps([big], {"t": ["a"]}, compact_wire_limit=None) \
        == jtuning.suggest_caps([big], {"t": ["a"]}, compact_wire_limit=None) \
        == {"t": 87552}


# ----------------------------------------------------------------------
# alerts
# ----------------------------------------------------------------------

def _alerts_run(alerts, path):
    """tests/test_infra.py's scenario: a progress check and a lag check
    through a file emitter, and a check that raises."""
    class FakeTrainer:
        step = 5

    class Boom:
        name = "boom"

        def __call__(self):
            raise RuntimeError("nope")

    t = FakeTrainer()
    lag = {"v": 0.0}
    mgr = alerts.AlertManager(emitter=alerts.FileEmitter(path))
    mgr.add_check(alerts.TrainingProgressCheck(t))
    mgr.add_check(alerts.SourceLagCheck(lambda: lag["v"], max_lag=100))
    fired = [mgr.run_checks_once()]
    lag["v"] = 500
    fired.append(mgr.run_checks_once())
    t.step, lag["v"] = 6, 0
    fired.append(mgr.run_checks_once())
    mgr.add_check(Boom())
    fired.append(mgr.run_checks_once())
    lines = [json.loads(line) for line in open(path)]
    return ([[(a.name, a.message) for a in f] for f in fired],
            [(d["name"], d["message"]) for d in lines], sorted(lines[0]))


def test_alerts_equal_jax(tmp_path):
    mine = _alerts_run(palerts, str(tmp_path / "port.jsonl"))
    theirs = _alerts_run(jalerts, str(tmp_path / "jax.jsonl"))
    assert mine == theirs
    assert [len(f) for f in mine[0]] == [0, 2, 0, 2]
    assert mine[0][3][1] == ("boom", "check raised: RuntimeError('nope')")


def test_alert_thread_starts_and_stops():
    hits = []

    class C:
        name = "c"

        def __call__(self):
            hits.append(1)
            return "always"

    mgr = palerts.get_default_alert_manager(check_interval_sec=0.05)
    assert mgr.checks == [] and isinstance(mgr.emitter, palerts.LogEmitter)
    mgr.add_check(C())
    mgr.start()
    mgr.start()             # a second start is a no-op
    import time
    time.sleep(0.3)
    mgr.stop()
    assert len(hits) >= 2 and mgr._thread is None
    assert all(a.message == "always" for a in mgr.alerts)

    class T:
        step = 1
    assert [type(c).__name__ for c in palerts.get_default_alert_manager(
        T()).checks] == ["TrainingProgressCheck"]


def test_the_data_package_exports_the_jax_names():
    import monolith_tpu.data as jdata
    theirs = {n for n in dir(jdata) if not n.startswith("_")}
    mine = {n for n in dir(pdata) if not n.startswith("_")}
    assert theirs <= mine, sorted(theirs - mine)

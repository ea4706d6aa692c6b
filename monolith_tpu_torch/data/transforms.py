"""Example-stream transforms.

The port's copy (numpy and stdlib) of the JAX package's rebuild of the
reference's pre-parse transform library (data/feature_utils.py:34-1015:
there they run as TF ops over tf.variant records so filters run before
parsing; here they are generator stages over `Example` streams, which
plays the same role before host batching).

Implemented transforms mirror the reference set: filter_by_fids,
filter_by_feature_value, filter_by_label, add_action/add_label from LineId
actions, scatter_label, negative_sample, special_strategy sampling,
feature_combine, switch_slot, label_upper_bound, label_normalization,
use_field_as_label, map_id.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np

from monolith_tpu_torch.data.example import Example, slot_of_fid_v1


def _stream(fn):
    """Lift a per-example fn (returning Example|None|list) to a stream stage."""
    def stage(source: Iterable[Example], *args, **kwargs) -> Iterator[Example]:
        for ex in source:
            out = fn(ex, *args, **kwargs)
            if out is None:
                continue
            if isinstance(out, list):
                yield from out
            else:
                yield out
    return stage


# --- filters ---

def filter_by_fids(source, has_fids: Sequence[int] = (),
                   filter_fids: Sequence[int] = (),
                   select_fids: Sequence[int] = ()):
    """Keep examples that contain ANY of has_fids, NONE of filter_fids, and
    ALL of select_fids (ref feature_utils.py:34)."""
    has, filt, sel = set(has_fids), set(filter_fids), set(select_fids)
    for ex in source:
        fids = set()
        for v in ex.features.values():
            fids.update(int(x) for x in v)
        if has and not (fids & has):
            continue
        if filt and (fids & filt):
            continue
        if sel and not sel.issubset(fids):
            continue
        yield ex


def filter_by_feature_value(source, field: str, op: str, operand: float):
    """Keep examples whose dense `field` first value satisfies op
    (ref feature_utils.py:81). op in {gt, ge, lt, le, eq, neq}."""
    import operator
    ops = {"gt": operator.gt, "ge": operator.ge, "lt": operator.lt,
           "le": operator.le, "eq": operator.eq, "neq": operator.ne}[op]
    for ex in source:
        v = ex.dense.get(field)
        if v is not None and len(v) and ops(float(v[0]), operand):
            yield ex


def filter_by_label(source, thresholds: Sequence[float]):
    """Keep examples where any label >= its threshold (ref :433)."""
    th = np.asarray(thresholds, dtype=np.float32)
    for ex in source:
        k = min(len(ex.labels), len(th))
        if k and (ex.labels[:k] >= th[:k]).any():
            yield ex


def negative_sample(source, drop_rate: float, label_index: int = 0,
                    seed: int = 0, reweight_dropped: bool = True):
    """Drop negatives (label <= 0) with probability drop_rate; surviving
    negatives get weight scaled by 1/(1-drop_rate) (ref :518)."""
    rng = np.random.default_rng(seed)
    keep = 1.0 - drop_rate
    for ex in source:
        if ex.labels[label_index] <= 0:
            if rng.random() < drop_rate:
                continue
            if reweight_dropped:
                ex.instance_weight = ex.instance_weight / keep
        yield ex


def special_strategy(source, strategy_keep_prob: Dict[int, float], seed: int = 0):
    """Sample examples by LineId.special-strategy-style channel id
    (ref :468; we key on line_id.chnid)."""
    rng = np.random.default_rng(seed)
    for ex in source:
        p = strategy_keep_prob.get(int(ex.line_id.chnid), 1.0)
        if rng.random() < p:
            yield ex


# --- label derivation ---

def add_label(source, configs: Sequence[str], negative_value: float = 0.0,
              sample_rate: float = 1.0, seed: int = 0):
    """Derive task labels from LineId.actions (ref :331). Each config is
    "pos_a|pos_b:neg_a|neg_b" — label k is 1.0 if any positive action
    matched, negative_value if any negative matched, else the example is
    dropped for that head (label = negative_value). Examples with no match
    in ANY head are sampled at `sample_rate`."""
    rng = np.random.default_rng(seed)
    parsed = []
    for cfg in configs:
        pos_s, _, neg_s = cfg.partition(":")
        pos = {int(x) for x in pos_s.split("|") if x}
        neg = {int(x) for x in neg_s.split("|") if x}
        parsed.append((pos, neg))
    for ex in source:
        actions = set(int(a) for a in ex.line_id.actions)
        labels = np.full(len(parsed), negative_value, dtype=np.float32)
        matched = False
        for k, (pos, neg) in enumerate(parsed):
            if actions & pos:
                labels[k] = 1.0
                matched = True
            elif neg and (actions & neg):
                labels[k] = negative_value
                matched = True
        if not matched and rng.random() >= sample_rate:
            continue
        ex.labels = labels
        yield ex


def scatter_label(source, action_to_index: Dict[int, int], num_heads: int):
    """One label head per action id (ref :396)."""
    for ex in source:
        labels = np.zeros(num_heads, dtype=np.float32)
        for a in ex.line_id.actions:
            idx = action_to_index.get(int(a))
            if idx is not None:
                labels[idx] = 1.0
        ex.labels = labels
        yield ex


def label_upper_bound(source, bounds: Sequence[float]):
    """Clip labels from above (ref :664)."""
    b = np.asarray(bounds, dtype=np.float32)
    for ex in source:
        k = min(len(ex.labels), len(b))
        ex.labels[:k] = np.minimum(ex.labels[:k], b[:k])
        yield ex


def label_normalization(source, norm_fn: Callable[[np.ndarray], np.ndarray]):
    """Apply a normalization fn to labels (ref :686 supports log/scale etc.)."""
    for ex in source:
        ex.labels = np.asarray(norm_fn(ex.labels), dtype=np.float32)
        yield ex


def use_field_as_label(source, field: str, overwrite_invalid: bool = False,
                       label_threshold: float = 0.0):
    """Replace labels with a dense field's value (ref :711)."""
    for ex in source:
        v = ex.dense.get(field)
        if v is not None and len(v):
            ex.labels = np.asarray(v, dtype=np.float32)
        elif overwrite_invalid:
            ex.labels = np.asarray([label_threshold], dtype=np.float32)
        yield ex


# --- fid surgery ---

def switch_slot(source, feature: str, slot: int):
    """Re-slot a feature's fids (v1 encoding, ref :602)."""
    mask = (1 << 54) - 1
    for ex in source:
        v = ex.features.get(feature)
        if v is not None:
            ex.features[feature] = ((np.asarray(v, np.int64) & mask)
                                    | (np.int64(slot) << 54))
        yield ex


def feature_combine(source, src1: str, src2: str, dst: str, slot: int):
    """Cross two fid lists into a new feature (ref :566): pairwise hash
    combine re-slotted to `slot`."""
    mask = (1 << 54) - 1
    for ex in source:
        a = ex.features.get(src1)
        b = ex.features.get(src2)
        if a is not None and b is not None and len(a) and len(b):
            aa, bb = np.meshgrid(np.asarray(a, np.uint64), np.asarray(b, np.uint64),
                                 indexing="ij")
            h = (aa * np.uint64(0x9E3779B97F4A7C15)) ^ (bb + np.uint64(0x85EBCA77))
            combined = (h.ravel().astype(np.int64) & mask) | (np.int64(slot) << 54)
            ex.features[dst] = combined
        else:
            ex.features[dst] = np.empty(0, np.int64)
        yield ex


def map_id(source, feature: str, map_dict: Dict[int, int], default: int = -1):
    """Remap raw ids through a dict (ref :826)."""
    for ex in source:
        v = ex.features.get(feature)
        if v is not None:
            ex.features[feature] = np.asarray(
                [map_dict.get(int(x), default) for x in v], dtype=np.int64)
        yield ex


def instance_reweight(source, action_weights: Dict[int, int],
                      default_weight: int = 1):
    """Duplicate/weight examples by action priority (ref data/datasets.py:685
    InstanceReweightDataset): weight n>1 emits the example n times, n==0
    drops it."""
    for ex in source:
        w = default_weight
        for a in ex.line_id.actions:
            if int(a) in action_weights:
                w = action_weights[int(a)]
                break
        for _ in range(int(w)):
            yield ex


_OPS = {
    "gt": lambda v, o: v > o[0],
    "ge": lambda v, o: v >= o[0],
    "eq": lambda v, o: v == o[0],
    "lt": lambda v, o: v < o[0],
    "le": lambda v, o: v <= o[0],
    "neq": lambda v, o: v != o[0],
    "between": lambda v, o: o[0] <= v < o[1],
    "in": lambda v, o: v in o,
}


def add_action(source, field_name: str, op: str, operand, action: int):
    """Append `action` to LineId.actions when a LineId field satisfies a
    comparison (ref feature_utils.py:261 add_action; ops gt/ge/eq/lt/le/
    neq/between/in)."""
    if op not in _OPS:
        raise ValueError(f"unknown op '{op}'")
    ops = operand if isinstance(operand, (list, tuple)) else [operand]
    test = _OPS[op]
    for ex in source:
        v = getattr(ex.line_id, field_name)
        if test(v, ops):
            ex.line_id.actions = list(ex.line_id.actions) + [int(action)]
        yield ex


def multi_label_gen(source, head_to_index: Dict[int, int],
                    head_field: str = "chnid",
                    pos_actions: Sequence[int] = (),
                    neg_actions: Sequence[int] = (),
                    use_origin_label: bool = False,
                    pos_label: float = 1.0, neg_label: float = 0.0,
                    task_num: Optional[int] = None,
                    invalid_label: float = -1.0):
    """Multi-head label generation (ref feature_utils.py:836): the head is
    picked by a LineId field through `head_to_index`; that head's label is
    pos_label if any positive action matched (or the origin label when
    use_origin_label), neg_label on a negative match, all other heads get
    `invalid_label` so their losses mask out."""
    if task_num is None:
        task_num = max(head_to_index.values()) + 1
    pos, neg = set(map(int, pos_actions)), set(map(int, neg_actions))
    if use_origin_label:
        if pos or neg:
            raise ValueError("use_origin_label excludes pos/neg_actions")
    elif not pos:
        raise ValueError("pos_actions required unless use_origin_label")
    for ex in source:
        head = head_to_index.get(int(getattr(ex.line_id, head_field)))
        labels = np.full(task_num, invalid_label, dtype=np.float32)
        if head is not None:
            if use_origin_label:
                labels[head] = ex.labels[0] if len(ex.labels) else neg_label
            else:
                actions = set(int(a) for a in ex.line_id.actions)
                if actions & pos:
                    labels[head] = pos_label
                elif not neg or (actions & neg):
                    labels[head] = neg_label
        ex.labels = labels
        yield ex


def gen_fid_mask(fids: np.ndarray, fid: int) -> np.ndarray:
    """1.0 where a row of a padded fid matrix contains `fid`
    (ref feature_utils.py:1007 gen_fid_mask)."""
    fids = np.asarray(fids)
    return (fids == fid).any(axis=-1).astype(np.float32)

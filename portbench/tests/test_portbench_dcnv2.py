"""The DLRM-DCNv2 cell on the CPU at a small size: correct against its
reference with each number far under its limit, its traced line with the
program's per-layer metrics, the run's steps in blocks on the fused wire,
and a state left unchanged (the rows, or everything) caught."""

import pytest

from portbench import run
from portbench.tests import small_dcnv2 as small


def test_cell_matches_the_reference():
    r = small.execute()
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"] / 10, (name, c)
    assert set(r["metrics"]) == {"train_examples_per_s", "setup_s"}


def test_traced_line_reads_the_programs_spans():
    r = small.execute(seconds=2.0, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    # CPU steps: the host numbers are read, the device ones are not
    assert 0 < m["prepare_ms_per_step.dcnv2"]["value"]
    assert 0 <= m["stage_hit_share.dcnv2"]["value"] <= 100
    assert {"dispatch_ms_per_step.train", "stage_ms_per_step.train"} <= set(m)
    names = {x["name"] for x in run.cell_files(small.CELL)["per_layer"]}
    assert set(m) <= names


def test_a_parent_without_blocks_is_refused_before_any_pool(monkeypatch):
    """An engine that would not take the fused wire at these caps (the
    16-bit wire alone) stops the run in set-up, before the trainer."""
    from monolith_tpu_torch.embedding.engine import EmbeddingEngine
    from monolith_tpu_torch.training import trainer
    monkeypatch.setattr(EmbeddingEngine, "fuse_wire",
                        property(lambda self: self.config.max_ucap <= 65535))
    made = []
    monkeypatch.setattr(trainer.Trainer, "__init__",
                        lambda *a, **k: made.append(1))
    with pytest.raises(RuntimeError, match="fused wire"):
        small.execute()
    assert made == []


@pytest.mark.parametrize("rows_only", [False, True])
def test_state_left_unchanged_is_caught(monkeypatch, rows_only):
    from monolith_tpu_torch.embedding.engine import EmbeddingEngine
    from monolith_tpu_torch.optimizers.dense import Adagrad
    monkeypatch.setattr(EmbeddingEngine, "fused_apply",
                        lambda self, states, *a, **k: states)
    if not rows_only:
        monkeypatch.setattr(Adagrad, "update_", lambda self, *a, **k: None)
    r = small.execute()
    assert not r["correct"]
    names = ("rows_gap",) if rows_only else ("change_gap", "accum_gap",
                                             "rows_gap")
    for name in names:
        c = r["checks"][name]
        assert c["value"] > 0.5 > c["limit"], (name, c)

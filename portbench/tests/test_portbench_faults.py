"""A run with its timed path broken underneath comes out not correct: a
step that returns its state unchanged (everywhere, or in the rows alone),
and a loss over half of the batch. (The cell runs on one card: there is
no exchange between cards to leave out, and no answer is served.)"""

from portbench.tests import small


def test_state_left_unchanged(monkeypatch):
    from monolith_tpu_torch.embedding.engine import EmbeddingEngine
    from monolith_tpu_torch.optimizers.dense import Adagrad
    monkeypatch.setattr(EmbeddingEngine, "fused_apply",
                        lambda self, states, *a, **k: states)
    monkeypatch.setattr(Adagrad, "update_", lambda self, *a, **k: None)
    r = small.execute()
    assert not r["correct"]
    for name in ("change_gap", "accum_gap", "rows_gap"):
        c = r["checks"][name]
        assert c["value"] > 0.5 > c["limit"], (name, c)


def test_rows_left_unchanged(monkeypatch):
    """The row optimizers and K2's write-back skipped, the dense tower
    still trained: only the rows' own number sees it."""
    from monolith_tpu_torch.embedding.engine import EmbeddingEngine
    monkeypatch.setattr(EmbeddingEngine, "fused_apply",
                        lambda self, states, *a, **k: states)
    r = small.execute()
    assert not r["correct"]
    c = r["checks"]["rows_gap"]
    assert c["value"] > 0.5 > c["limit"], c


def test_half_of_the_batch_left_out(monkeypatch):
    from monolith_tpu_torch.training.task import RecTask
    from monolith_tpu_torch.losses.losses import bce_with_logits

    def half(self, outputs, batch):
        n = outputs["logits"].shape[0] // 2
        return bce_with_logits(outputs["logits"][:n], batch["label"][:n]), {}
    monkeypatch.setattr(RecTask, "loss", half)
    r = small.execute()
    assert not r["correct"]

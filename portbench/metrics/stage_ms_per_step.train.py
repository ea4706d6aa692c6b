"""Host ms per training step in `Trainer.stage_block` (dedup, id -> row
map, admission, the pack into the pinned wire, the start of its upload),
from the benchmark's span around it, over the traced run's unprofiled
part."""


def read(rec):
    if rec.get("kind") != "train" or "stage" not in rec["span_s"]:
        return None
    return rec["span_s"]["stage"] / rec["steps"] * 1e3

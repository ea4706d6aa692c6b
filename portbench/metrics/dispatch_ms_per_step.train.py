"""Host ms per training step in `Trainer.train_step_block` (the Python and
autograd issue of the block's launches), from the benchmark's span around
it, over the traced run's unprofiled part."""


def read(rec):
    if rec.get("kind") != "train" or "dispatch" not in rec["span_s"]:
        return None
    return rec["span_s"]["dispatch"] / rec["steps"] * 1e3

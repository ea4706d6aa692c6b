"""% of the card's float32 peak that the whole training step reaches: the
model's FLOPs per step (portbench/reference/<model>.py, from the
configuration's widths) / (unprofiled ms per step x the peak of
portbench/flops.py)."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("peak") \
            or not rec.get("prof"):
        return None
    seconds = rec["ms_per_step"] / 1e3
    return 100.0 * rec["flops_per_step"] / (seconds
                                            * rec["peak"]["f32_flops"])

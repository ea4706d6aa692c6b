"""% of the card's float32 peak that the low-rank cross layers reach in
the forward: their products' FLOPs per step (the reference's count from
the configuration's widths) over the device time of the kernels launched
inside the program's `step.cross` span (the concatenation and the cross
layers, `mt.step.cross` in the profiler window) per step, times the peak
of portbench/flops.py."""


def read(rec):
    prof = rec.get("prof")
    seconds = (rec.get("under") or {}).get("mt.step.cross")
    if rec.get("kind") != "train" or not prof or not rec.get("peak") \
            or not seconds:
        return None
    per_step = seconds / prof["steps"]
    return 100.0 * rec["cross_flops_per_step"] / (
        per_step * rec["peak"]["f32_flops"])

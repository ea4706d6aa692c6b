"""% of a training step in which the device runs nothing: 1 - (device
busy ms per step, the union of device intervals in the profiler window) /
(ms per step of the traced run's unprofiled part)."""


def read(rec):
    prof = rec.get("prof")
    if rec.get("kind") != "train" or not prof or prof["busy_s"] <= 0:
        return None
    busy_ms = prof["busy_s"] / prof["steps"] * 1e3
    return 100.0 * (1.0 - busy_ms / rec["ms_per_step"])

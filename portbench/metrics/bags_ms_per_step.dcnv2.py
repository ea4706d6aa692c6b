"""Device ms per training step of the kernels launched inside the
program's `step.pool` span (the forward's gather and sum of every bag,
`mt.step.pool` in the profiler window)."""


def read(rec):
    prof = rec.get("prof")
    seconds = (rec.get("under") or {}).get("mt.step.pool")
    if rec.get("kind") != "train" or not prof or seconds is None:
        return None
    return seconds / prof["steps"] * 1e3

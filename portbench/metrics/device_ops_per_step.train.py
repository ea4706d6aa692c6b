"""Device operations (kernels and copies) per training step, counted in
the profiler window."""


def read(rec):
    prof = rec.get("prof")
    if rec.get("kind") != "train" or not prof:
        return None
    return prof["device_ops"] / prof["steps"]

"""% of its roofline that K1 (`ops/scatter.py::gather_rows`, kernel
`gather_rows_kernel`) reaches inside the real steps: the least time, the
bytes its work needs (portbench/flops.py: each of the step's unique ids'
state read once and written once) over the card's HBM peak, divided by
its device time per step in the profiler window."""


def read(rec):
    prof = rec.get("prof")
    if rec.get("kind") != "train" or not prof or not rec.get("peak"):
        return None
    hits = [s for k, s in prof["kernel_s"].items()
            if "gather_rows_kernel" in k]
    if not hits:
        return None
    least = rec["row_bytes_per_step"] / rec["peak"]["bytes_per_s"]
    return 100.0 * least / (sum(hits) / prof["steps"])

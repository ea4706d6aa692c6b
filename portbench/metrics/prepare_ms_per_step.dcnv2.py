"""Host ms of one step's prepare on the trainer's stage worker (the native
dedup, id map and wide wire pack of every table, `stage.prepare` on the
worker's thread), over the traced run's unprofiled part of the window:
the worker's `stage.prepare` seconds over their count."""


def read(rec):
    worker = (rec.get("program") or {}).get("worker", {})
    n, seconds = worker.get("stage.prepare", (0, 0.0))
    if rec.get("kind") != "train" or n == 0:
        return None
    return seconds / n * 1e3

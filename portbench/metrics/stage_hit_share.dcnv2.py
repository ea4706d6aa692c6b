"""% of the stage worker's prepares whose wire was packed when its step
took it: 100 x (1 - `stage.wire_wait` spans of the dispatching thread /
`stage.prepare` spans of the worker), over the traced run's unprofiled
part of the window."""


def read(rec):
    prog = rec.get("program") or {}
    n = prog.get("worker", {}).get("stage.prepare", (0, 0.0))[0]
    if rec.get("kind") != "train" or n == 0:
        return None
    waits = prog.get("main", {}).get("stage.wire_wait", (0, 0.0))[0]
    return 100.0 * (1.0 - waits / n)

"""Training alerting: periodic health checks with pluggable emitters.

The port's copy (stdlib) of the JAX package's rebuild of ref alert/
(alert.proto:19 AlertProto with kafka_alert/training_alert/
check_interval_sec; alert_manager.py, whose open-source build is a stub
returning None). Here the manager is functional:
it runs registered checks every `check_interval_sec` after `start_delay_sec`
and routes failures to an emitter (log/file/custom callable).

Built-in checks mirror the reference's two monitors:
  - TrainingProgressCheck: alert when the global step stops advancing
    (ref TrainingAlertProto — training-progress watchdog).
  - SourceLagCheck: alert when a streaming source's consumer lag exceeds a
    threshold (ref KafkaAlertProto — consumer-group lag watchdog).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, List, Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Alert:
    name: str
    message: str
    ts: float


class LogEmitter:
    def __call__(self, alert: Alert) -> None:
        log.error("ALERT [%s] %s", alert.name, alert.message)


class FileEmitter:
    """Append alerts as JSON lines (the file plays the reference's
    message-pusher role in environments with no paging system)."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self, alert: Alert) -> None:
        import json
        with open(self.path, "a") as f:
            f.write(json.dumps(dataclasses.asdict(alert)) + "\n")


class TrainingProgressCheck:
    """Fires when trainer.step hasn't advanced since the last check."""

    def __init__(self, trainer, name: str = "training_progress"):
        self.trainer = trainer
        self.name = name
        self._last_step = None

    def __call__(self) -> Optional[str]:
        step = self.trainer.step
        stalled = self._last_step is not None and step <= self._last_step
        self._last_step = step
        if stalled:
            return f"global step stalled at {step}"
        return None


class SourceLagCheck:
    """Fires when a streaming source reports lag above the threshold.
    `lag_fn` returns the current consumer lag (messages or seconds)."""

    def __init__(self, lag_fn: Callable[[], float], max_lag: float,
                 name: str = "source_lag"):
        self.lag_fn = lag_fn
        self.max_lag = max_lag
        self.name = name

    def __call__(self) -> Optional[str]:
        lag = self.lag_fn()
        if lag > self.max_lag:
            return f"consumer lag {lag} exceeds {self.max_lag}"
        return None


class AlertManager:
    """Periodic checker thread (ref alert_manager.py AlertManager).

    checks: objects with `.name` and `__call__() -> Optional[str]` (a
    failure message, or None when healthy).
    """

    def __init__(self, checks: Optional[List] = None, emitter=None,
                 check_interval_sec: float = 1800.0,
                 start_delay_sec: float = 0.0):
        self.checks = list(checks or [])
        self.emitter = emitter or LogEmitter()
        self.check_interval_sec = check_interval_sec
        self.start_delay_sec = start_delay_sec
        self.alerts: List[Alert] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_check(self, check) -> None:
        self.checks.append(check)

    def run_checks_once(self) -> List[Alert]:
        """Run every check now; emit and record failures."""
        fired = []
        for check in self.checks:
            try:
                msg = check()
            except Exception as e:  # checks must never kill training
                msg = f"check raised: {e!r}"
            if msg:
                alert = Alert(name=getattr(check, "name", type(check).__name__),
                              message=msg, ts=time.time())
                fired.append(alert)
                self.alerts.append(alert)
                try:
                    self.emitter(alert)
                except Exception:
                    log.exception("alert emitter failed")
        return fired

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            if self._stop.wait(self.start_delay_sec):
                return
            while not self._stop.wait(self.check_interval_sec):
                self.run_checks_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="alert-manager")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def get_default_alert_manager(trainer=None, **kwargs) -> AlertManager:
    """Ready-to-start manager with the training-progress watchdog attached
    (the reference's OSS build returns None here; ours works)."""
    mgr = AlertManager(**kwargs)
    if trainer is not None:
        mgr.add_check(TrainingProgressCheck(trainer))
    return mgr

"""Failure recovery for training loops.

The port's copy of the JAX package's training/recovery.py: the reference's
worker failover loop
(cpu_training.py:2092-2129: on UnavailableError re-query the cluster, restore
from the latest checkpoint, retry with a bounded count) adapted to a
single-controller world: retry the training fn, restoring trainer state from
the newest checkpoint between attempts, and count failovers in metrics.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Tuple, Type

from monolith_tpu_torch.training import checkpoint as ckpt_lib
from monolith_tpu_torch.utils.metrics_client import get_metric_client

log = logging.getLogger(__name__)


def run_with_recovery(train_fn: Callable[[], dict],
                      trainer=None,
                      ckpt_dir: Optional[str] = None,
                      max_retries: int = 3,
                      retry_exceptions: Tuple[Type[BaseException], ...] = (Exception,),
                      backoff_s: float = 1.0) -> dict:
    """Run train_fn, restoring from the latest checkpoint and retrying on
    failure (ref worker_failover_cnt metric, partial_recovery)."""
    metric = get_metric_client()
    attempt = 0
    while True:
        try:
            return train_fn()
        except retry_exceptions as e:  # noqa: PERF203
            attempt += 1
            metric.emit_counter("worker_failover_cnt", 1)
            log.warning("training attempt %d failed: %s", attempt, e)
            if attempt > max_retries:
                raise
            if trainer is not None and ckpt_dir is not None and \
                    ckpt_lib.latest_step(ckpt_dir) is not None:
                ckpt_lib.restore(trainer, ckpt_dir)
                log.info("restored trainer from %s at step %d",
                         ckpt_dir, trainer.step)
            time.sleep(backoff_s * attempt)

"""Elastic / fault-tolerant launcher: bounded-retry supervision around the
training loop, and the failure injection the tests use.

The failure model: a host dies mid-step, the job is torn down and brought
up again, and it must resume from the last committed checkpoint with no
manual step. What makes that true here:

  * checkpoints are atomic and param-shaped (``repro_torch.train.
    checkpoint``), in the JAX package's format;
  * batches are pure functions of the step index, so the resumed run
    consumes exactly the batches the dead run would have;
  * ``supervise`` retries the loop with exponential backoff up to
    ``max_restarts``, re-entering through the resume path each time.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from repro_torch.launch.train import RunConfig, train_loop


class InjectedFailure(RuntimeError):
    pass


def failing_hook(fail_at_step: int):
    """Raise once at ``fail_at_step`` (simulated host loss mid-run)."""
    state = {"armed": True}

    def hook(step, metrics):
        if state["armed"] and step == fail_at_step:
            state["armed"] = False
            raise InjectedFailure(f"injected node failure at step {step}")

    return hook


def supervise(rc: RunConfig, *, max_restarts: int = 3, backoff_s: float = 0.1,
              hook: Optional[Callable] = None) -> Dict:
    """Run train_loop under bounded-retry supervision; resume from the last
    checkpoint after every failure."""
    if not rc.ckpt_dir:
        raise ValueError("supervision requires a checkpoint directory")
    attempt = 0
    while True:
        try:
            return train_loop(rc, hook=hook)
        except Exception as e:  # noqa: BLE001 (any failure triggers a restart)
            attempt += 1
            if attempt > max_restarts:
                raise RuntimeError(
                    f"giving up after {max_restarts} restarts") from e
            print(f"[elastic] attempt {attempt} failed: {e!r}; "
                  f"restarting from latest checkpoint", flush=True)
            time.sleep(backoff_s * (2 ** (attempt - 1)))

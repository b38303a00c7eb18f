"""Preemption / emergency checkpoint handling: a copy of
``repro.checkpoint.emergency``, which imports no JAX but belongs to the JAX
package.

On real fleets the maintenance notice arrives as SIGTERM (or a runtime
callback) a few seconds before eviction.  `PreemptionGuard` registers a
handler that flips a flag the train loop polls each step; the loop then
takes the *synchronous* emergency-save path and exits cleanly.  The guard is
also directly triggerable (`guard.trigger()`) so tests and simulated-failure
drills exercise the identical code path.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional


class PreemptionGuard:
    def __init__(self, *, install_signal_handlers: bool = False) -> None:
        self._event = threading.Event()
        self._prev = {}
        if install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self._event.set()

    def trigger(self) -> None:
        """Simulate a preemption notice (tests / failure drills)."""
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def reset(self) -> None:
        self._event.clear()

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

"""Fault-tolerance runtime: preemption handling.

Preemption / planned maintenance — SIGTERM arrives with a grace window.
``PreemptionHandler`` flips a flag that the serving loop checks between
chunks (`SampleServer.drain` with ``preemption=``); the server then
finishes the chunk, writes a blocking snapshot and returns, and a later
`SampleServer.restore` continues bit-exactly.
"""

from __future__ import annotations

import signal
import threading


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful checkpoint-and-exit flag.

    Installation is cooperative: any handler that was already registered
    for the signal is chained (called after the flag is set) rather than
    clobbered, so embedding hosts — test harnesses, notebook kernels,
    process supervisors — keep their own SIGTERM behaviour.  Installs
    that the interpreter refuses (non-main thread, non-main interpreter,
    unsupported signal) are swallowed and reported via ``installed``;
    ``trigger()`` still works, so drive loops behave identically whether
    or not the OS-level hook landed.
    """

    def __init__(self, install: bool = True, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev: dict[int, object] = {}
        self.installed = False
        if install:
            for sig in signals:
                try:
                    self._prev[int(sig)] = signal.signal(sig, self._on_signal)
                    self.installed = True
                except (ValueError, OSError, RuntimeError, TypeError):
                    # non-main thread / non-main interpreter / bad signum
                    self._prev.pop(int(sig), None)

    def _on_signal(self, signum, frame):
        self._flag.set()
        prev = self._prev.get(int(signum))
        # Chain a real previously-installed handler; SIG_DFL/SIG_IGN and
        # None (no previous Python-level handler) are not callable.
        if callable(prev):
            prev(signum, frame)

    def uninstall(self):
        """Put back whatever handlers we displaced (tests, embedders)."""
        for sig, prev in list(self._prev.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError, RuntimeError, TypeError):
                pass
        self._prev.clear()
        self.installed = False

    def trigger(self):  # for tests / manual drain
        self._flag.set()

    @property
    def should_exit(self) -> bool:
        return self._flag.is_set()

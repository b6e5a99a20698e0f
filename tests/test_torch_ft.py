"""The port's fault-tolerance runtime: `repro_torch.runtime.ft`.

Counterparts of the reference's `PreemptionHandler` tests
(tests/test_train_infra.py): the SIGTERM flag, chaining a handler that was
there before, uninstall, a non-main-thread install that degrades to a
usable flag.
"""

import os
import signal
import threading

from repro_torch.runtime.ft import PreemptionHandler


def test_preemption_handler_flag():
    h = PreemptionHandler(install=False)
    assert not h.should_exit and not h.installed
    h.trigger()
    assert h.should_exit


def test_preemption_handler_chains_previous_handler():
    seen = []

    def before(signum, frame):
        seen.append(signum)

    signal.signal(signal.SIGUSR1, before)
    try:
        h = PreemptionHandler(signals=(signal.SIGUSR1,))
        assert h.installed
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.should_exit
        assert seen == [signal.SIGUSR1]  # the previous handler still ran
        h.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is before
    finally:
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)


def test_preemption_handler_uninstall_restores_default():
    signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    h = PreemptionHandler(signals=(signal.SIGUSR1,))
    assert h.installed
    h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL
    assert not h.installed


def test_preemption_handler_non_main_thread_install():
    out = {}

    def worker():
        h = PreemptionHandler()  # signal.signal raises off the main thread
        out["installed"] = h.installed
        h.trigger()
        out["should_exit"] = h.should_exit

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out == {"installed": False, "should_exit": True}

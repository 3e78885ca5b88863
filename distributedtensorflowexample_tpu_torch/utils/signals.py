"""Scoped signal-handler installation for the preemption path (a copy of
the JAX package's ``utils/signals.py``).

The trainer's SIGTERM handler only sets a flag; the training loop polls
it at call boundaries (``training/loop.py``), so a signal never lands in
the middle of a step, a collective or a save.
"""

from __future__ import annotations

import contextlib
import signal
import threading


@contextlib.contextmanager
def installed_signal_handler(signum: int, handler):
    """Install ``handler`` for ``signum`` (main thread only:
    ``signal.signal``'s requirement; other threads no-op and yield False)
    and restore the previous disposition on exit, so embedding the caller
    in a larger process (pytest, a notebook) does not keep its signals.

    A previous handler installed by non-Python code reads back as
    ``None``, which ``signal.signal`` refuses: ``SIG_DFL`` is restored
    then, rather than a TypeError raised out of the ``finally`` (which
    would mask the exit path in flight)."""
    install = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signum, handler) if install else None
    try:
        yield install
    finally:
        if install:
            signal.signal(signum,
                          prev if prev is not None else signal.SIG_DFL)


class SigtermFlag:
    """Truthy once SIGTERM has been delivered.  The handler only sets this
    flag: raising from it could leave a step half applied (the parameters
    are updated in place) or a collective half joined."""

    __slots__ = ("_seen",)

    def __init__(self):
        self._seen = False

    def __bool__(self) -> bool:
        return self._seen

    def __call__(self) -> bool:
        return self._seen


@contextlib.contextmanager
def sigterm_flag():
    """Install a flag-setting SIGTERM handler for the enclosed block and
    yield the flag (poll it at safe boundaries; never raise from it)."""
    flag = SigtermFlag()

    def _handler(signum, frame):
        flag._seen = True

    with installed_signal_handler(signal.SIGTERM, _handler):
        yield flag

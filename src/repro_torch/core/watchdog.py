"""Port of ``repro/core/watchdog.py`` (threading only, verbatim apart from
this paragraph): the deadline watchdog the reference's elastic trainer and
serving engine share.  The port's serving engine (``serve/engine.py``,
``_dispatch_decode``) calls it; elastic training, which would be its second
caller, is ROADMAP.md queue 1, item 14.

A hung device call — a collective that never completes on the production
mesh, a decode step that stalls in the serving engine — is invisible to
exception handling: nothing raises, the host just waits forever.  The only
portable detector is a deadline.  :func:`call_with_deadline` runs the
dispatch+sync on a daemon worker thread and raises
:class:`WatchdogTimeout` on the *caller's* thread when the deadline
passes; the worker (the hung call, in the fault model) is left to expire
on its own.  A supervision loop catches the timeout, classifies it as a
lost device / lost decode step, and runs its recovery path.
"""
from __future__ import annotations

import threading
import time


class WatchdogTimeout(RuntimeError):
    """The supervised call did not complete within its deadline."""


def call_with_deadline(fn, args=(), kwargs=None, *, deadline_s: float,
                       what: str = "step"):
    """Run ``fn(*args, **kwargs)`` under a watchdog deadline.

    The call runs on a daemon worker thread; if it does not finish within
    ``deadline_s`` a :class:`WatchdogTimeout` is raised **on the caller's
    thread** — the worker (a hung collective, in the fault model) is left
    to expire on its own.  Exceptions from ``fn`` re-raise here."""
    if deadline_s <= 0:
        raise ValueError("deadline_s must be > 0")
    box = {}
    done = threading.Event()

    def work():
        try:
            box["value"] = fn(*args, **(kwargs or {}))
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=work, daemon=True,
                     name=f"tl-watchdog-{what}").start()
    if not done.wait(deadline_s):
        raise WatchdogTimeout(
            f"{what} exceeded its {deadline_s:.1f}s watchdog deadline "
            "(hung collective / lost device)")
    if "error" in box:
        raise box["error"]
    return box["value"]


def simulate_hang(deadline_s: float):
    """Stand-in for a hung collective: sleeps past the watchdog deadline
    (bounded, so the abandoned worker thread eventually exits)."""
    time.sleep(min(3.0 * deadline_s, deadline_s + 30.0))

"""Progress/status lines on stderr — the reference's background
progress-thread model (src/progress.cpp:395-413: a detached thread
wakes periodically and repaints from shared counters while workers
compute).

Work loops call `start(msg)` / `tick(done, total)` / `done(summary)`.
`tick` only stores counters; a daemon painter thread repaints the
status line every 0.2 s, so a long device dispatch or GIL-released C
call no longer freezes the line — it keeps an mm:ss elapsed heartbeat
exactly like the reference's "%02u:%02u" prefix.  Everything is
suppressed under -quiet and when stderr is not a tty (like the
reference, progress goes to stderr and never affects file outputs).
"""

from __future__ import annotations

import sys
import threading
import time

from .config import options

_lock = threading.Lock()
_active = False
_label = ""
_done_n = 0
_total_n = 0
_t0 = 0.0
_painter: threading.Thread | None = None
_stop = threading.Event()


def _enabled() -> bool:
    """Progress repaints only make sense on a terminal; suppress them
    under -quiet and when stderr is redirected to a file or pipe."""
    try:
        tty = sys.stderr.isatty()
    except Exception:
        tty = False
    return tty and not options().flag("quiet") \
        and not options().flag("no_progress")


def _line() -> str:
    el = int(time.monotonic() - _t0)
    mm, ss = divmod(el, 60)
    if _total_n > 0:
        pct = 100.0 * _done_n / _total_n
        return f"\r{mm:02d}:{ss:02d} {_label} {pct:5.1f}%"
    return f"\r{mm:02d}:{ss:02d} {_label} {_done_n}"


def _paint_loop() -> None:
    while not _stop.wait(0.2):
        # write under _lock: a line composed just before done() clears
        # _active must not land after done()'s final summary line
        # (writes are sub-millisecond; contention is negligible)
        with _lock:
            if not _active:
                continue
            msg = _line()
            try:
                sys.stderr.write(msg)
                sys.stderr.flush()
            except Exception:
                return


def start(label: str) -> None:
    global _active, _label, _done_n, _total_n, _t0, _painter
    if not _enabled():
        return
    with _lock:
        _active = True
        _label = label
        _done_n = 0
        _total_n = 0
        _t0 = time.monotonic()
    sys.stderr.write(f"{label}")
    sys.stderr.flush()
    if _painter is None or not _painter.is_alive():
        _stop.clear()
        _painter = threading.Thread(target=_paint_loop, daemon=True,
                                    name="usearch-progress")
        _painter.start()


def tick(done: int, total: int) -> None:
    """Store counters only — no IO.  The painter thread repaints;
    workers stay out of stderr entirely (reference: counter updates in
    work loops, prints in the progress thread)."""
    global _done_n, _total_n
    if not _active:
        return
    _done_n = done
    _total_n = total


def done(summary: str = "") -> None:
    global _active
    if not _active:
        return
    with _lock:
        _active = False
        if summary:
            sys.stderr.write(f"\r{_label} 100.0% {summary}\n")
        else:
            sys.stderr.write(f"\r{_label} 100.0%\n")
        sys.stderr.flush()

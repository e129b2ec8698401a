"""debug — crash handler + stack dump kit (reference butil/debug/:
stack_trace.cc, crash logging).

``install_crash_handler()`` arms faulthandler so SIGSEGV/SIGFPE/SIGABRT
dump every thread's Python stack to stderr (and optionally a crash log
file) before dying — the runtime equivalent of the reference's
stack-trace-on-crash. ``dump_all_stacks()`` is the on-demand variant
backing /threads. Server.start() installs the handler once.
"""

from __future__ import annotations

import faulthandler
import sys
import threading
import traceback
from typing import Optional

_installed = [False]
_crash_file = [None]


def install_crash_handler(crash_log_path: Optional[str] = None) -> None:
    """Re-arming is allowed: a later call with a crash_log_path re-points
    the dump there (Server.start() claims the first, stderr-bound install;
    an application asking for a persistent crash file must still get it).
    Keeps the file object alive for faulthandler's sake."""
    if _installed[0] and not crash_log_path:
        return
    if not _installed[0] and not crash_log_path \
            and faulthandler.is_enabled():
        # the application armed faulthandler itself (own crash log):
        # the default stderr install must not silently re-point it
        _installed[0] = True
        return
    stream = sys.stderr
    old = None
    if crash_log_path:
        try:
            f = open(crash_log_path, "a")
        except OSError:
            if _installed[0]:
                return
        else:
            old = _crash_file[0]
            _crash_file[0] = f
            stream = f
    elif _crash_file[0] is not None:
        stream = _crash_file[0]
    try:
        faulthandler.enable(file=stream, all_threads=True)
        _installed[0] = True
    except (RuntimeError, ValueError):
        return  # no usable stream; keep the previous arming intact
    if old is not None:
        # close the superseded crash file only AFTER faulthandler moved to
        # the new one — never leave it armed on a closed/reused fd
        try:
            old.close()
        except OSError:
            pass


def dump_all_stacks() -> str:
    """Every thread's current Python stack — THE implementation behind
    /threads (builtin/services.py delegates here); covers threads not in
    threading.enumerate() (foreign/ctypes threads) by tid."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in frames.items():
        t = by_id.get(tid)
        name = t.name if t else f"tid{tid}"
        out.append(f"-- {name} (tid={tid}) --")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out) + "\n"

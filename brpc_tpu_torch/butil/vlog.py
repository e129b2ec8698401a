"""vlog — verbose-logging sites with runtime-tunable levels.

Counterpart of the reference's VLOG() + /vlog builtin
(butil/logging.h VLOG_IS_ON, builtin/vlog_service.cpp): call sites
register themselves by module name on first use; each module's verbosity
level can be raised/lowered at runtime from the dashboard without
restarting. Disabled sites cost one dict lookup + int compare.

    from brpc_tpu_torch.butil import vlog
    if vlog.vlog_is_on("socket", 2):
        ...expensive formatting...
    vlog.vlog("socket", 1, "conn %s drained %d bytes", conn, n)

Module levels: 0 = off (default); a site at level L logs when the
module's level >= L. ``set_vlevel`` accepts fnmatch patterns like the
reference's --vmodule flag ("socket*=2").
"""

from __future__ import annotations

import fnmatch
import logging
import threading
from typing import Dict, List, Tuple

_lock = threading.Lock()
_levels: Dict[str, int] = {}     # module -> enabled level
_seen: Dict[str, int] = {}       # module -> max level seen at call sites
_patterns: List[Tuple[str, int]] = []  # applied to later-registered modules

log = logging.getLogger("brpc_tpu_torch.vlog")


def vlog_is_on(module: str, level: int = 1) -> bool:
    lv = _levels.get(module)
    if lv is None:
        _register(module, level)
        lv = _levels.get(module, 0)
    elif _seen.get(module, 0) < level:
        with _lock:
            _seen[module] = max(_seen.get(module, 0), level)
    return lv >= level


def _register(module: str, level: int) -> None:
    with _lock:
        if module not in _levels:
            lv = 0
            for pat, plv in _patterns:
                if fnmatch.fnmatch(module, pat):
                    lv = plv
            _levels[module] = lv
        _seen[module] = max(_seen.get(module, 0), level)


def vlog(module: str, level: int, fmt: str, *args) -> None:
    if vlog_is_on(module, level):
        log.info("[%s/%d] " + fmt, module, level, *args)


def set_vlevel(pattern: str, level: int) -> int:
    """Set every matching module's level (fnmatch, reference --vmodule);
    remembered for modules that register later. Returns match count."""
    with _lock:
        _patterns.append((pattern, level))
        n = 0
        for module in _levels:
            if fnmatch.fnmatch(module, pattern):
                _levels[module] = level
                n += 1
        return n


def dump() -> List[Tuple[str, int, int]]:
    """(module, enabled_level, max_site_level) sorted — the /vlog view."""
    with _lock:
        return sorted((m, _levels[m], _seen.get(m, 0)) for m in _levels)

"""Variable registry — name -> metric, the backbone of observability.

Rebuild of the reference's ``bvar/variable.cpp``: every metric can be
``expose()``d under a global name, enumerated (``list_exposed``), described
(``describe_exposed``) and dumped. The /vars builtin service and the
Prometheus exporter read this registry.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

# RLock: dropping the dict's last reference to a Variable can run its
# __del__ -> hide() on the same thread that already holds the lock.
_registry: Dict[str, "Variable"] = {}
_registry_lock = threading.RLock()


class Variable:
    """Base class of every metric. Subclasses implement get_value()."""

    def __init__(self):
        self._name: Optional[str] = None

    # ------------------------------------------------------------- exposure
    def expose(self, name: str, prefix: str = "") -> "Variable":
        full = f"{prefix}_{name}" if prefix else name
        full = full.replace("::", "_").replace(" ", "_").lower()
        with _registry_lock:
            old = _registry.get(full)
            if old is not None and old is not self:
                old._name = None
            _registry[full] = self
            self._name = full
        return self

    def hide(self) -> None:
        with _registry_lock:
            if self._name and _registry.get(self._name) is self:
                del _registry[self._name]
            self._name = None

    @property
    def name(self) -> Optional[str]:
        return self._name

    # ---------------------------------------------------------------- value
    def get_value(self):
        raise NotImplementedError

    def describe(self) -> str:
        return str(self.get_value())

    def __del__(self):
        try:
            self.hide()
        except Exception:
            pass


def describe_exposed(name: str) -> Optional[str]:
    with _registry_lock:
        var = _registry.get(name)
    return var.describe() if var is not None else None


def get_exposed(name: str) -> Optional[Variable]:
    with _registry_lock:
        return _registry.get(name)


def list_exposed() -> List[str]:
    with _registry_lock:
        return sorted(_registry)


def exposed_variables():
    """Sorted (name, Variable) snapshot (labeled families need the object,
    not just the describe() string)."""
    with _registry_lock:
        return sorted(_registry.items())


def dump_exposed() -> Dict[str, str]:
    """Snapshot of every exposed variable (for /vars and file dumps)."""
    with _registry_lock:
        items = list(_registry.items())
    return {name: var.describe() for name, var in sorted(items)}


def clear_registry() -> None:
    """Test hook."""
    with _registry_lock:
        dropped = list(_registry.values())
        for var in dropped:
            var._name = None
        _registry.clear()
    del dropped  # destructors run here, outside the lock

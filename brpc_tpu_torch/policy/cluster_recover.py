"""Cluster recover policy — de-thunder recovery after total cluster loss.

Counterpart of the reference's DefaultClusterRecoverPolicy
(reference src/brpc/cluster_recover_policy.h:60-80, .cpp): when a
naming-service cluster comes back from "every instance down", letting the
full client fleet hammer the first instance that reappears knocks it over
again. While *recovering*, a request is shed (EREJECT) with probability
``1 - usable/min_working_instances``, so traffic ramps in proportion to
capacity; recovery ends when the usable count stops changing for
``hold_seconds`` (the cluster has converged) or reaches
``min_working_instances``.

Attach to a load balancer via the LB spec string
(``"rr:min_working_instances=3 hold_seconds=2"`` — the reference's
flag-style params), or construct directly and assign to
``lb.recover_policy``. Channel consults it on every pick.

The port's copy of ``brpc_tpu/policy/cluster_recover.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from brpc_tpu_torch.butil.misc import fast_rand_less_than


class DefaultClusterRecoverPolicy:
    def __init__(self, min_working_instances: int, hold_seconds: float):
        if min_working_instances <= 0:
            raise ValueError("min_working_instances must be > 0")
        self.min_working_instances = int(min_working_instances)
        self.hold_seconds = float(hold_seconds)
        self._lock = threading.Lock()
        self._recovering = False
        self._last_usable = 0
        self._last_usable_change = 0.0

    # ------------------------------------------------------------ lifecycle
    def start_recover(self) -> None:
        """The LB found no usable server — recovery begins when they return
        (reference StartRecover)."""
        with self._lock:
            if not self._recovering:
                self._recovering = True
                self._last_usable = 0
                self._last_usable_change = time.monotonic()

    @property
    def recovering(self) -> bool:
        with self._lock:
            return self._recovering

    # -------------------------------------------------------------- verdict
    def do_reject(self, usable: int) -> bool:
        """True = shed this request (reference DoReject). ``usable`` is the
        LB's count of not-parked instances."""
        with self._lock:
            if not self._recovering:
                return False
            now = time.monotonic()
            if usable != self._last_usable:
                self._last_usable = usable
                self._last_usable_change = now
            # StopRecoverIfNecessary: converged (stable for hold_seconds)
            # or enough capacity came back
            if usable >= self.min_working_instances or (
                    usable > 0 and
                    now - self._last_usable_change >= self.hold_seconds):
                self._recovering = False
                return False
            if usable <= 0:
                return True
            # shed proportionally to the missing capacity
            return int(fast_rand_less_than(self.min_working_instances)) \
                >= usable


def parse_recover_params(params: str) -> Optional[DefaultClusterRecoverPolicy]:
    """Parse the reference's param syntax: ``min_working_instances=N
    hold_seconds=S`` (space or comma separated). Unknown keys or malformed
    values raise ValueError — a typo must not silently disable the
    protection (reference GetRecoverPolicyByParams rejects them too,
    cluster_recover_policy.cpp:140-146). Returns None only for an empty
    params string."""
    params = params.strip()
    if not params:
        return None
    min_working = None
    hold = 3.0
    for part in params.replace(",", " ").split():
        key, _, val = part.partition("=")
        try:
            if key == "min_working_instances":
                min_working = int(val)
            elif key == "hold_seconds":
                hold = float(val)
            else:
                raise ValueError(f"unknown cluster-recover param {key!r}")
        except ValueError as e:
            raise ValueError(
                f"bad cluster-recover params {params!r}: {e}") from None
    if min_working is None:
        raise ValueError(
            f"cluster-recover params {params!r} missing min_working_instances")
    return DefaultClusterRecoverPolicy(min_working, hold)

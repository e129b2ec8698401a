"""fault — deterministic fault injection for chaos testing.

Named injection points threaded through the transport and RPC core; armed
via :func:`arm` from tests, the ``/fault`` builtin service from a running
server, or the reloadable ``fault_spec`` flag. See fault/core.py and
docs/fault-injection.md.
"""

from brpc_tpu_torch.fault.core import (  # noqa: F401
    arm,
    disarm,
    disarm_all,
    hit,
    maybe_sleep,
    parse_spec_kv,
    register,
    snapshot,
)

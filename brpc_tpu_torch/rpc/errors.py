"""RPC error codes: a re-export of :mod:`brpc_tpu_torch.errors`, so the
port keeps one table."""

from brpc_tpu_torch.errors import *  # noqa: F401,F403

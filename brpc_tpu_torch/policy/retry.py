"""Retry policy: the user's "should this error retry?".

The port of ``brpc_tpu/policy/retry.py`` (the reference's
``retry_policy.h`` RetryPolicy::DoRetry and ``backup_request_policy.h``).
The Controller consults the channel's ``retry_policy`` on every
error-channel event (``rpc/controller.py``); the default retries
connection-level failures only (application errors and timeouts do not
retry: a timeout means the deadline budget is already spent).
"""

from __future__ import annotations

from brpc_tpu_torch.rpc import errors


class RetryPolicy:
    def do_retry(self, controller) -> bool:
        """Called with the failed controller (error_code set, call-id lock
        held). True -> re-issue on a (possibly different) server."""
        raise NotImplementedError


class DefaultRetryPolicy(RetryPolicy):
    def do_retry(self, controller) -> bool:
        return controller.error_code in errors.DEFAULT_RETRYABLE


class RetryOnCodes(RetryPolicy):
    """Retry on an explicit set of codes (plus the connection-level set)."""

    def __init__(self, codes, include_default: bool = True):
        self.codes = frozenset(codes) | (
            errors.DEFAULT_RETRYABLE if include_default else frozenset())

    def do_retry(self, controller) -> bool:
        return controller.error_code in self.codes


class TunnelRetryPolicy(RetryOnCodes):
    """Retry posture for tpu:// tunnel clients.

    On top of the connection-level set (which a tunnel kill maps onto via
    the transport's retriable-code fanout), also retries EOVERCROWDED:
    during a heal the rebuilt window starts empty, so the first calls can
    race a still-wedged credit ledger — re-issuing lands them on the fresh
    epoch instead of surfacing a transient overload."""

    def __init__(self, include_default: bool = True):
        super().__init__({errors.EOVERCROWDED}, include_default)


class BackupRequestPolicy:
    """Decides whether a backup (hedged) request fires for this call
    (reference backup_request_policy.h)."""

    def do_backup(self, controller) -> bool:
        return True


_default = DefaultRetryPolicy()


def default_retry_policy() -> RetryPolicy:
    return _default

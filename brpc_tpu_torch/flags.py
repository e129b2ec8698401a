"""flags — runtime-reloadable configuration flags (gflags equivalent).

Rebuild of the reference's flag system: ~180 ``DEFINE_*`` gflags across
src/brpc, with **reloadable** flags registered through a validator
(``reloadable_flags.h:43-60``) that can be PUT at runtime via the
``/flags/<name>?setvalue=`` builtin service (``builtin/flags_service.cpp``),
and every flag surfaced as a metrics variable (``bvar/gflag.cpp``).

Design notes (not a port): a Flag is a typed cell with an optional
validator; ``set_from_string`` parses + validates + swaps atomically under
the registry lock. Modules read flags with ``flags.get(name)`` or by holding
the Flag object — reads are a single attribute load, no lock (Python object
assignment is atomic), matching the reference's relaxed-read semantics.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

_BOOL_TRUE = {"true", "1", "yes", "on", "t", "y"}
_BOOL_FALSE = {"false", "0", "no", "off", "f", "n"}


class FlagError(Exception):
    pass


class Flag:
    """One typed, named configuration cell."""

    __slots__ = ("name", "value", "default", "type", "help",
                 "validator", "reloadable")

    def __init__(self, name: str, default: Any, help: str = "",
                 validator: Optional[Callable[[Any], bool]] = None,
                 reloadable: bool = False, type_: Optional[type] = None):
        self.name = name
        self.default = default
        self.value = default
        self.type = type_ or type(default)
        self.help = help
        self.validator = validator
        self.reloadable = reloadable or validator is not None

    # ------------------------------------------------------------------ parse
    def parse(self, text: str) -> Any:
        if self.type is bool:
            low = text.strip().lower()
            if low in _BOOL_TRUE:
                return True
            if low in _BOOL_FALSE:
                return False
            raise FlagError(f"{self.name}: not a bool: {text!r}")
        try:
            if self.type is int:
                return int(text, 0)
            if self.type is float:
                return float(text)
            if self.type is str:
                return text
        except ValueError as e:
            raise FlagError(f"{self.name}: {e}") from None
        raise FlagError(f"{self.name}: unsupported flag type {self.type}")

    def set(self, value: Any) -> None:
        """Validate + swap. Raises FlagError if rejected."""
        if self.type is not type(value):
            # allow int->float promotion only
            if self.type is float and isinstance(value, int):
                value = float(value)
            else:
                raise FlagError(
                    f"{self.name}: expected {self.type.__name__}, "
                    f"got {type(value).__name__}")
        if self.validator is not None and not self.validator(value):
            raise FlagError(f"{self.name}: value {value!r} rejected by validator")
        self.value = value

    def set_from_string(self, text: str) -> None:
        self.set(self.parse(text))


_registry: Dict[str, Flag] = {}
_lock = threading.Lock()


def define(name: str, default: Any, help: str = "",
           validator: Optional[Callable[[Any], bool]] = None,
           reloadable: bool = False) -> Flag:
    """DEFINE_* equivalent. A validator makes the flag reloadable (the
    reference's RegisterFlagValidatorOrDie contract)."""
    with _lock:
        if name in _registry:
            raise FlagError(f"flag {name!r} already defined")
        f = Flag(name, default, help, validator, reloadable)
        _registry[name] = f
        return f


def get(name: str) -> Any:
    f = _registry.get(name)
    if f is None:
        raise FlagError(f"unknown flag {name!r}")
    return f.value


def set_flag(name: str, text_or_value) -> None:
    """Runtime update — the /flags/<name>?setvalue= path. Only reloadable
    flags may change after startup."""
    with _lock:
        f = _registry.get(name)
        if f is None:
            raise FlagError(f"unknown flag {name!r}")
        if not f.reloadable:
            raise FlagError(f"flag {name!r} is not reloadable")
        if isinstance(text_or_value, str) and f.type is not str:
            f.set_from_string(text_or_value)
        else:
            f.set(text_or_value)


def find(name: str) -> Optional[Flag]:
    return _registry.get(name)


def list_flags() -> List[Flag]:
    with _lock:
        return sorted(_registry.values(), key=lambda f: f.name)


def reset_for_test() -> None:
    with _lock:
        _registry.clear()


# ---------------------------------------------------------------- core flags
# (defined here so every subsystem shares one registry; subsystems may also
# define their own at import). Only the flags the ported modules read are
# defined: setting any other raises FlagError("unknown flag"), and each
# comes back with the slice that ports its feature.
def _positive(v) -> bool:
    return v > 0


def _non_negative(v) -> bool:
    return v >= 0


health_check_interval_s = define(
    "health_check_interval_s", 3.0,
    "seconds between re-probes of a failed server", validator=_positive)
circuit_breaker_enabled = define(
    "circuit_breaker_enabled", True,
    "isolate error-rate outlier nodes", reloadable=True)
max_body_size = define(
    "max_body_size", 1 << 31,
    "largest accepted wire message", validator=_positive)
idle_timeout_s = define(
    "idle_timeout_s", -1.0,
    "close connections idle longer than this (<=0 disables)",
    reloadable=True)
log_error_text = define(
    "log_error_text", False,
    "log every failed RPC's error text", reloadable=True)
rpcz_sample_ratio = define(
    "rpcz_sample_ratio", 1.0,
    "fraction of RPCs recorded by rpcz", validator=lambda v: 0 <= v <= 1)
rpc_dump_ratio = define(
    "rpc_dump_ratio", 0.0,
    "fraction of requests sampled to dump files",
    validator=lambda v: 0 <= v <= 1)
rpc_dump_max_per_sec = define(
    "rpc_dump_max_per_sec", 0,
    "hard cap on dump records written per second, enforced by a "
    "monotonic-clock token bucket after the ratio draw (0 = no cap "
    "beyond the shared collector budget)", validator=_non_negative)
span_export_path = define(
    "span_export_path", "",
    "append every finished span to this file as one OTLP-shaped JSON "
    "line (trace/export.py); empty disables export", reloadable=True)
event_dispatcher_num = define(
    "event_dispatcher_num", 2,
    "number of IO event loops sockets are spread across "
    "(reference event_dispatcher.cpp:32)", validator=_positive)
inline_cut_max_bytes = define(
    "inline_cut_max_bytes", 128 * 1024,
    "read bursts beyond this are parsed on a fiber worker instead of the "
    "event loop (reference ProcessEvent handoff, socket.cpp:2256)",
    validator=_positive)
stream_body_min_bytes = define(
    "stream_body_min_bytes", 256 * 1024,
    "message bodies at least this large are consumed incrementally through "
    "a pending-body cursor once their header is cracked, so transport "
    "flow-control credits return mid-message", reloadable=True,
    validator=_positive)
tpu_tunnel_auto_heal = define(
    "tpu_tunnel_auto_heal", True,
    "re-establish a failed tpu:// tunnel in the background (fresh HELLO "
    "handshake under a new window generation) instead of waiting for the "
    "next caller to re-dial", reloadable=True)
tpu_reconnect_backoff_ms = define(
    "tpu_reconnect_backoff_ms", 50,
    "initial delay between tpu:// re-handshake attempts; doubles per "
    "failure up to tpu_reconnect_backoff_max_ms", validator=_positive)
tpu_reconnect_backoff_max_ms = define(
    "tpu_reconnect_backoff_max_ms", 2000,
    "ceiling for the tpu:// reconnect exponential backoff",
    validator=_positive)
tpu_reconnect_window_s = define(
    "tpu_reconnect_window_s", 10.0,
    "total time budget a background tunnel heal keeps retrying before "
    "giving up (the next RPC or health probe re-dials on demand)",
    validator=_positive)
tpu_doorbell_coalesce_us = define(
    "tpu_doorbell_coalesce_us", 200,
    "coalesce FT_ACK credit returns and small response frames produced "
    "inside one poll-batch round into a single ctrl-socket doorbell, "
    "bounded by this many microseconds of added hold latency "
    "(0 = legacy per-message writes)", validator=_non_negative)
rtc_enable = define(
    "rtc_enable", True,
    "run-to-completion dispatch: execute cheap, small-payload methods "
    "directly on the cut-loop thread instead of the queue->worker hop",
    reloadable=True)
rtc_budget_us = define(
    "rtc_budget_us", 2000,
    "a run-to-completion handler exceeding this wall budget demotes its "
    "method back to queued dispatch (sticky)", validator=_positive)
rtc_cheap_us = define(
    "rtc_cheap_us", 1000,
    "auto-classify a method as inline-eligible once its observed "
    "execution-time EMA sits below this", validator=_positive)
rtc_max_body = define(
    "rtc_max_body", 16 * 1024,
    "only messages with bodies at most this large (and no attachment) "
    "ride the run-to-completion path", validator=_positive)
tpu_shard_workers = define(
    "tpu_shard_workers", 0,
    "spread the Python service lane over this many worker OS processes "
    "(cid-sharded dispatch plane); 0 disables sharding entirely — the "
    "in-process dispatch path is untouched", validator=_non_negative)
tpu_shard_rebalance_pct = define(
    "tpu_shard_rebalance_pct", 60,
    "reclaim lease credits from a sibling worker only when its idle "
    "share exceeds this percent of a fair per-worker split (lower = "
    "eager rebalancing, higher = less reclaim churn)",
    validator=lambda v: 0 < v <= 100)
tpu_shard_respawn_backoff_ms = define(
    "tpu_shard_respawn_backoff_ms", 50,
    "base backoff before respawning a dead shard worker (multiplied by "
    "the slot's respawn count)", validator=_positive)
tpu_shard_respawn_max = define(
    "tpu_shard_respawn_max", 3,
    "stop respawning a worker slot after this many deaths; its cids "
    "then route to in-process fallback", validator=_non_negative)
tpu_shard_ring_mb = define(
    "tpu_shard_ring_mb", 4,
    "size in MiB of each parent<->worker shm doorbell ring",
    validator=_positive)
tpu_shard_forward_max = define(
    "tpu_shard_forward_max", 128 * 1024,
    "requests larger than this stay on the in-process dispatch path "
    "(forwarding copies the frame through the shm ring once)",
    validator=_positive)
shard_vars_interval_s = define(
    "shard_vars_interval_s", 1.0,
    "seconds between W_VARS windowed var snapshots a shard worker ships "
    "to the parent for fleet-wide /vars aggregation", validator=_positive)
serving_shard_skew_ratio = define(
    "serving_shard_skew_ratio", 0.25,
    "serving_shard_skew watch rule fires when any KV shard's occupancy "
    "exceeds its fleet mean by more than this ratio (reloadable: the "
    "rule reads the flag at every tick)",
    validator=lambda v: 0.0 < v <= 1.0)
serving_prefix_cache_enabled = define(
    "serving_prefix_cache_enabled", True,
    "radix prefix cache over the paged KV pools: admission forks the "
    "longest cached block-aligned prefix chain (refcount++, zero "
    "copies) and prefills only the suffix; completion commits full "
    "blocks back into the tree (reloadable: the engine reads the flag "
    "per admission)", validator=lambda v: v in (True, False, 0, 1))
serving_prefix_evict_watermark = define(
    "serving_prefix_evict_watermark", 0.80,
    "prefix-cache trim target: tree commits evict LRU refcount-1 "
    "chains until pool occupancy is back under this ratio, keeping the "
    "slack up to the admission watermark as decode headroom "
    "(reloadable: read at every trim)",
    validator=lambda v: 0.0 < float(v) <= 1.0)
serving_prefix_thrash_rate = define(
    "serving_prefix_thrash_rate", 20.0,
    "serving_prefix_thrash watch rule fires when prefix-cache eviction "
    "sustains above this many blocks/s: the tree is churning instead "
    "of caching (reloadable: the rule reads the flag at every tick)",
    validator=_positive)
serving_migrate_window_mb = define(
    "serving_migrate_window_mb", 64,
    "credit window (MiB of staged device bytes) for the KV-migration "
    "record stream: the prefill engine stalls exactly when the decode "
    "engine holds this many unconsumed migrated-block bytes",
    validator=_positive)
serving_migrate_timeout_ms = define(
    "serving_migrate_timeout_ms", 30000,
    "per-sequence migration deadline: MigrateCommit gives up (and the "
    "source keeps the chain, falling back to local decode) if the "
    "destination has not adopted every block within this bound",
    validator=_positive)
serving_spec_accept_rate_min = define(
    "serving_spec_accept_rate_min", 0.2,
    "serving_spec_collapse watch rule fires when the speculative-decode "
    "accept rate (accepted/drafted over recent steps) sustains below "
    "this bound: drafts are being rejected wholesale and the verify "
    "rows are wasted compute (reloadable: the rule reads the flag at "
    "every tick)", validator=lambda v: 0.0 < float(v) <= 1.0)
serving_migrate_backlog_max = define(
    "serving_migrate_backlog_max", 8.0,
    "serving_migrate_backlog watch rule fires when more than this many "
    "KV migrations are in flight at once: prefill engines ship chains "
    "faster than decode engines adopt them (reloadable: the rule reads "
    "the flag at every tick)", validator=_positive)
serving_qos_starvation_ms = define(
    "serving_qos_starvation_ms", 2000.0,
    "serving_qos_starvation watch rule fires when the oldest queued "
    "request across the QoS tenant lanes has waited more than this many "
    "milliseconds: fair-share weights (or the limiter ceiling) are "
    "starving a lane (reloadable: the rule reads the flag at every "
    "tick)", validator=_positive)

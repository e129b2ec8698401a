"""rpc_dump — rate-limited request sampling to replayable files.

Rebuild of the reference's ``rpc_dump.h:30-57`` (AskToBeSampled hooked into
ProcessRpcRequest) + the dump format consumed by ``tools/rpc_replay``.

Two on-disk formats:

v1 (legacy, headerless) — one length-prefixed record per sample::

    u32 meta_size | u32 body_size | RpcMeta pb | body bytes

v2 — the file opens with the magic ``RPCDUMP2\\n``; each record carries an
extra JSON blob ahead of the raw wire bytes::

    u32 extra_size | u32 meta_size | u32 body_size | extra json | meta | body

The extra blob stamps what replay and diffing need and the RpcMeta alone
can't say: the arrival wall-clock timestamp (inter-arrival gaps for
open-loop replay), trace/span ids as hex, service.method, the deadline
budget and priority, and — because a record is committed when the request
*settles*, not when it arrives — the server span's complete phase timeline
plus final latency and error code. ``RpcDumpLoader`` sniffs the header per
file and yields :class:`DumpRecord` objects that still unpack as
``(meta, body)`` tuples, so v1-era consumers read both formats unchanged.

Clocks: interval/rate accounting (the token bucket) runs on the monotonic
clock like everything in ``trace/``; the wall clock appears only inside
the on-disk record timestamp.
"""

from __future__ import annotations

import json
import os
import random
import struct
import threading
import time
from typing import Any, Dict, Iterator, Optional

from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.proto import rpc_meta_pb2

_REC_FMT = "!II"
_REC_SIZE = struct.calcsize(_REC_FMT)
_REC2_FMT = "!III"
_REC2_SIZE = struct.calcsize(_REC2_FMT)

MAGIC_V2 = b"RPCDUMP2\n"

MAX_FILE_BYTES = 64 << 20

g_dump_sampled = Adder("g_dump_sampled")      # records committed to disk
g_dump_skipped = Adder("g_dump_skipped")      # ratio-selected but shed
g_dump_bytes = Adder("g_dump_bytes")          # record bytes written
g_dump_rotations = Adder("g_dump_rotations")  # file rolls past the first
g_dump_errors = Adder("g_dump_errors")        # write failures (disk full)


class RpcDumper:
    """Per-server sampler writing to <dir>/requests.<n>.dump files."""

    def __init__(self, directory: str, max_file_bytes: int = MAX_FILE_BYTES):
        self.directory = directory
        self.max_file_bytes = max_file_bytes
        self._lock = threading.Lock()
        self._file = None
        self._file_bytes = 0
        self._file_index = 0
        self.sampled_count = 0
        self.per_method: Dict[str, int] = {}
        # token bucket for rpc_dump_max_per_sec (monotonic clock); starts
        # with one token so a fresh dumper can always take its first sample
        self._tokens = 1.0
        self._tokens_t = time.monotonic()
        os.makedirs(directory, exist_ok=True)

    def ask_to_be_sampled(self) -> bool:
        ratio = _flags.get("rpc_dump_ratio")
        if ratio <= 0.0:
            return False
        if ratio < 1.0 and random.random() >= ratio:
            return False
        if not self._take_token():
            g_dump_skipped.put(1)
            return False
        # ratio selects; the shared Collector budget caps (reference
        # rpc_dump.h:46-57 speed-limit via bvar Collector)
        from brpc_tpu_torch.metrics.collector import global_collector

        if not global_collector().ask_to_be_sampled():
            g_dump_skipped.put(1)
            return False
        return True

    def _take_token(self) -> bool:
        cap = _flags.get("rpc_dump_max_per_sec")
        if cap <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(float(cap),
                               self._tokens + (now - self._tokens_t) * cap)
            self._tokens_t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    # ------------------------------------------------------------ v2 records
    def begin(self, meta: rpc_meta_pb2.RpcMeta, body: bytes) -> Dict[str, Any]:
        """Open a v2 record at dispatch time: the arrival timestamp and the
        request identity are stamped now; the record is written by
        :meth:`commit` once the span's phase timeline is complete."""
        req = meta.request
        return {
            "v": 2,
            # wall clock is the on-disk arrival stamp only (inter-arrival
            # gaps for replay pacing + cross-host alignment); never used
            # for interval math in-process
            "ts_us": time.time() * 1e6,  # tpulint: disable=monotonic-clock
            "service": req.service_name,
            "method": req.method_name,
            "trace_id": f"{req.trace_id:016x}",
            "span_id": f"{req.span_id:016x}",
            "log_id": int(req.log_id),
            "timeout_ms": int(req.timeout_ms or 0),
            # QoS identity: which fair-share lane the request billed
            # against and how protected it is — rpc_replay re-stamps both
            # so replayed overload waves shed the same tenants
            "tenant": req.tenant_id,
            "priority": int(req.priority),
            "_meta": meta,
            "_body": bytes(body),
        }

    def commit(self, pending: Dict[str, Any], span=None,
               error_code: int = 0) -> None:
        """Write the record opened by :meth:`begin`, folding in the settled
        span's phase timeline (may be None: the record then carries raw
        wire bytes only, like v1 did)."""
        meta = pending.pop("_meta")
        body = pending.pop("_body")
        pending["error_code"] = int(error_code)
        if span is not None:
            pending["latency_us"] = round(span.latency_us, 1)
            pending["phases"] = {k: round(v, 1)
                                 for k, v in span.phases.items()}
        else:
            pending["latency_us"] = 0.0
            pending["phases"] = {}
        record = pack_record_v2(meta, body, pending)
        key = f"{pending['service']}.{pending['method']}"
        try:
            with self._lock:
                if self._file is None or self._file_bytes > self.max_file_bytes:
                    self._roll()
                self._file.write(record)
                self._file.flush()
                self._file_bytes += len(record)
                self.sampled_count += 1
                self.per_method[key] = self.per_method.get(key, 0) + 1
        except OSError:
            g_dump_errors.put(1)
            return
        g_dump_sampled.put(1)
        g_dump_bytes.put(len(record))

    def sample(self, meta: rpc_meta_pb2.RpcMeta, body: bytes) -> None:
        """One-shot record with no phase timeline — ``commit(begin(...))``
        for callers that never see the span settle."""
        self.commit(self.begin(meta, body))

    def _roll(self) -> None:
        if self._file is not None:
            self._file.close()
            g_dump_rotations.put(1)
        path = os.path.join(self.directory,
                            f"requests.{self._file_index}.dump")
        self._file_index += 1
        self._file = open(path, "wb")
        self._file.write(MAGIC_V2)
        self._file_bytes = len(MAGIC_V2)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def state(self) -> Dict[str, Any]:
        """Snapshot for the /dump builtin view."""
        with self._lock:
            return {
                "directory": self.directory,
                "max_file_bytes": self.max_file_bytes,
                "file_index": self._file_index,
                "file_bytes": self._file_bytes,
                "sampled": self.sampled_count,
                "per_method": dict(self.per_method),
            }


def pack_record(meta: rpc_meta_pb2.RpcMeta, body: bytes) -> bytes:
    """v1 record (kept for back-compat fixtures and old dumps)."""
    meta_bytes = meta.SerializeToString()
    return (struct.pack(_REC_FMT, len(meta_bytes), len(body))
            + meta_bytes + body)


def pack_record_v2(meta: rpc_meta_pb2.RpcMeta, body: bytes,
                   info: Dict[str, Any]) -> bytes:
    extra = json.dumps(info, separators=(",", ":"),
                       sort_keys=True).encode("utf-8")
    meta_bytes = meta.SerializeToString()
    return (struct.pack(_REC2_FMT, len(extra), len(meta_bytes), len(body))
            + extra + meta_bytes + body)


class DumpRecord:
    """One loaded record. Unpacks as ``(meta, body)`` for v1-era callers;
    the v2 extras live in :attr:`info` (empty dict for v1 records)."""

    __slots__ = ("meta", "body", "info", "version")

    def __init__(self, meta: rpc_meta_pb2.RpcMeta, body: bytes,
                 info: Optional[Dict[str, Any]] = None, version: int = 1):
        self.meta = meta
        self.body = body
        self.info = info or {}
        self.version = version

    def __iter__(self):
        return iter((self.meta, self.body))

    @property
    def trace_id(self) -> int:
        tid = self.info.get("trace_id", "")
        if tid:
            try:
                return int(tid, 16)
            except ValueError:
                pass
        return int(self.meta.request.trace_id)

    @property
    def span_id(self) -> int:
        sid = self.info.get("span_id", "")
        if sid:
            try:
                return int(sid, 16)
            except ValueError:
                pass
        return int(self.meta.request.span_id)

    @property
    def ts_us(self) -> float:
        """Arrival wall-clock timestamp (0.0 on v1 records)."""
        return float(self.info.get("ts_us", 0.0))

    @property
    def method_key(self) -> str:
        svc = self.info.get("service") or self.meta.request.service_name
        meth = self.info.get("method") or self.meta.request.method_name
        return f"{svc}.{meth}"


class RpcDumpLoader:
    """Iterate records of one dump file (or a directory of them); format
    detected per file, truncated tail records tolerated (partial write on
    crash loses at most the last record)."""

    def __init__(self, path: str):
        self.paths = []
        if os.path.isdir(path):
            self.paths = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith(".dump"))
        else:
            self.paths = [path]

    def __iter__(self) -> Iterator[DumpRecord]:
        for p in self.paths:
            with open(p, "rb") as f:
                data = f.read()
            if data.startswith(MAGIC_V2):
                yield from self._iter_v2(data)
            else:
                yield from self._iter_v1(data)

    @staticmethod
    def _iter_v1(data: bytes) -> Iterator[DumpRecord]:
        pos = 0
        while pos + _REC_SIZE <= len(data):
            meta_size, body_size = struct.unpack_from(_REC_FMT, data, pos)
            pos += _REC_SIZE
            if pos + meta_size + body_size > len(data):
                break  # truncated tail record
            try:
                meta = rpc_meta_pb2.RpcMeta.FromString(
                    data[pos:pos + meta_size])
            except Exception:
                break  # corrupt meta: stop at the damage
            pos += meta_size
            body = data[pos:pos + body_size]
            pos += body_size
            yield DumpRecord(meta, body, None, 1)

    @staticmethod
    def _iter_v2(data: bytes) -> Iterator[DumpRecord]:
        pos = len(MAGIC_V2)
        while pos + _REC2_SIZE <= len(data):
            extra_size, meta_size, body_size = struct.unpack_from(
                _REC2_FMT, data, pos)
            pos += _REC2_SIZE
            if pos + extra_size + meta_size + body_size > len(data):
                break  # truncated tail record
            try:
                info = json.loads(data[pos:pos + extra_size])
            except ValueError:
                break
            pos += extra_size
            try:
                meta = rpc_meta_pb2.RpcMeta.FromString(
                    data[pos:pos + meta_size])
            except Exception:
                break
            pos += meta_size
            body = data[pos:pos + body_size]
            pos += body_size
            yield DumpRecord(meta, body, info, 2)

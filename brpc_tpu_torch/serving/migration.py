"""KV block-chain migration over the tpu:// record lane.

The port of ``brpc_tpu/serving/migration.py``: the disaggregated serving
plane's primitive, which ships a LIVE sequence's paged KV between engines
without re-prefilling a token. The control message
(:class:`MigrateRequest`, the manifest: tokens so far, chain geometry,
the audited length) rides a normal RPC; the block bytes stream over the
record lane (``tpu/device_stream.py``): one 16-byte ``(handle, nbytes)``
record per block, credit-windowed on staged device bytes.

Ownership is a two-phase handshake with no window where the chain is
owned by nobody or by both sides:

1. source: ``quiesce_sequence`` (forced ledger audit; any write clears
   the mark), ``export_chain``, then ``MigrateOpen`` with the manifest;
   the destination allocates a *staging* chain (its blocks owned by the
   staging id for the whole transfer) and accepts the record stream.
2. source streams one record per block (k half then v half, position
   order); the destination reads each staged payload back to the host
   (:func:`~brpc_tpu_torch.tpu.device_stream.host_sink_options`), and
   credits flow back as it consumes them.
3. when the last block lands, the destination writes the chain into its
   pools with one indexed write per pool (``assert_writable`` first:
   staging blocks are refcount 1 by construction), adopts the chain under
   the destination sequence id (``adopt_sequence``, refcount + 1), frees
   the staging id, and parks the sequence in the destination engine.
4. ``MigrateCommit``'s reply IS the adoption ACK: only on
   ``accepted=True`` does the source ``release_exported`` its chain. Any
   failure (stream write error, drop fault, timeout, engine stopped)
   leaves the source chain intact (``unquiesce_sequence``) so the
   sequence falls back to local decode.

The block bytes are the reference's: fp32, ``(2, layers, block_size,
kv_dim)`` per block. The pools are read and written in place through the
cache (``kv.read_chain`` / ``kv.write_chain``, exactly the chain's
slots); the engine's ``pool_gate`` keeps the write off the step loop's
launches. A sharded chain (a ``ShardTable`` of a ``ShardedKVCache``) is
read from and written to its shard's pools: a slice of the stacked pools,
or over a mesh with a rank per position the pools on the shard's own
rank, by one program there. The source and destination ``DeviceStore`` must be
one store (both engines on ``global_store(device)`` of one process),
because a record names a handle of the store it was put in.

Fault points: ``serving.migrate.stall`` (``delay_ms`` per block record on
the source) and ``serving.migrate.drop`` (the destination's tunnel dies
mid-migration: the receiver fails the transfer, frees its staging chain,
and the source keeps the sequence).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.status import PassiveStatus

_fault.register("serving.migrate.stall",
                "stall the source between migrated block records "
                "(delay_ms=)")
_fault.register("serving.migrate.drop",
                "kill the destination tunnel mid-migration (after=N "
                "records): the receiver fails the transfer and the "
                "source retains the chain")

g_serving_migrate_seqs = Adder("g_serving_migrate_seqs")
g_serving_migrate_blocks = Adder("g_serving_migrate_blocks")
g_serving_migrate_bytes = Adder("g_serving_migrate_bytes")
g_serving_migrate_failed = Adder("g_serving_migrate_failed")

_inflight_lock = threading.Lock()
_inflight = [0]  # migrations in flight in this process (out + in)


def _inflight_delta(d: int) -> None:
    with _inflight_lock:
        _inflight[0] += d


g_serving_migrate_inflight = PassiveStatus(lambda: _inflight[0]) \
    .expose("g_serving_migrate_inflight")
g_serving_migrate_inflight.prometheus_type = "gauge"


# --------------------------------------------------------- pool plumbing
def read_chain_blocks(kv, table, block_bytes: int) -> List[bytes]:
    """Serialize a chain's blocks for the record lane: one gather per
    pool where the pools live (``kv.read_chain``: a sharded chain's
    shard, over ranks its pool-holding rank), ONE copy of both to the
    host, then one ``k ‖ v`` payload per block, in table (= position)
    order."""
    blocks = kv.read_chain(table).cpu().numpy()
    out: List[bytes] = []
    for i in range(len(table)):
        payload = blocks[i].tobytes()
        if len(payload) != block_bytes:
            raise AssertionError(
                f"block payload {len(payload)}B != manifest "
                f"{block_bytes}B")
        out.append(payload)
    return out


def write_chain_blocks(kv, staging_table, payloads: List[bytes],
                       ntokens: int) -> None:
    """Write received block payloads into the destination pools: one copy
    to the device and one indexed write per pool for the WHOLE chain,
    exactly the chain's slots (the reference pads the scatter to a power
    of two only to spare a jit trace). The pools change in place; the
    caller holds the engine's ``pool_gate``. Staging blocks are owned by
    the staging id alone (refcount 1): ``assert_writable`` proves it
    under an armed ledger before any slot is touched."""
    bs = kv.block_size
    n = len(payloads)
    kv.assert_writable(staging_table, 0, n * bs)
    host = np.concatenate([np.frombuffer(p, dtype=np.float32)
                           for p in payloads])
    kv.write_chain(staging_table, torch.from_numpy(host).view(
        n, 2, kv.layers, bs, kv.kv_dim))
    kv.pools_written()


def chain_block_bytes(kv) -> int:
    """Per-record payload size: the k and v halves of one block."""
    return 2 * kv.layers * kv.block_size * kv.kv_dim * 4  # float32


# ---------------------------------------------------------------- source
class KVMigrator:
    """Source side: serialize, stream, release on the ACK.

    One migrator per (engine, destination) pair; the engine calls
    :meth:`migrate` from its step loop (the handoff after prefill) or
    from the drain in ``stop()`` (shard-death recovery). The sequence must
    be quiescent (no launch outstanding), which both call sites guarantee;
    ``quiesce_sequence`` re-audits the ledger and arms the export gate
    regardless."""

    def __init__(self, dest_addr: str, dest_shard: int = 0,
                 window_bytes: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 channel_options=None):
        self.dest_addr = dest_addr
        self.dest_shard = dest_shard
        self._window = window_bytes
        self._timeout = timeout_s
        self._channel_options = channel_options
        self._channel = None
        self._lock = threading.Lock()
        self.seqs = 0
        self.blocks = 0
        self.bytes = 0
        self.failed = 0
        self.send_s = 0.0  # wall seconds inside stream + commit (gbps)
        self.seq_s: List[float] = []  # wall seconds per migrated sequence
        # where a migrated sequence's seconds go: MigrateOpen's round
        # trip, the chain's gather and copy to the host, the puts and
        # records, MigrateCommit's wait for the adoption
        self.phase_s = {"open": 0.0, "read": 0.0, "send": 0.0,
                        "commit": 0.0}

    # built lazily, so constructing a migrator never dials anything
    def _stub(self):
        from brpc_tpu_torch.proto import serving_pb2
        from brpc_tpu_torch.rpc import Channel, ChannelOptions, Stub

        with self._lock:
            if self._channel is None:
                opts = self._channel_options or ChannelOptions(
                    protocol="trpc_std", timeout_ms=60000)
                ch = Channel(opts)
                ch.init(self.dest_addr)
                self._channel = ch
            return Stub(self._channel,
                        serving_pb2.DESCRIPTOR.services_by_name[
                            "LlmService"])

    def _window_bytes(self) -> int:
        if self._window is not None:
            return self._window
        return int(_flags.get("serving_migrate_window_mb")) << 20

    def _timeout_s(self) -> float:
        if self._timeout is not None:
            return self._timeout
        return float(_flags.get("serving_migrate_timeout_ms")) / 1000.0

    def migrate(self, seq, kv, recovery: bool = False) -> Optional[int]:
        """Ship ``seq``'s chain to the destination engine. Returns the
        adopted destination sequence id, or None, in which case the chain
        is STILL OWNED LOCALLY and the sequence can keep decoding here
        (fallback) or be aborted retriably by the caller."""
        from brpc_tpu_torch.proto import serving_pb2
        from brpc_tpu_torch.rpc import Controller, RpcError
        from brpc_tpu_torch.rpc.stream import (StreamOptions, stream_close,
                                               stream_create)
        from brpc_tpu_torch.tpu.device_stream import (record_measure,
                                                      send_handle)

        timeout = self._timeout_s()
        _inflight_delta(1)
        sid = 0
        try:
            kv.quiesce_sequence(seq.seq_id)
            table, ntokens = kv.export_chain(seq.seq_id)
            block_bytes = chain_block_bytes(kv)
            manifest = serving_pb2.MigrateRequest(
                seq_id=seq.seq_id,
                prompt_tokens=[int(t) for t in seq.prompt],
                out_tokens=[int(t) for t in seq.out_tokens],
                max_new_tokens=seq.max_new_tokens,
                stop_token=seq.stop_token,
                ntokens=ntokens,
                n_blocks=len(table),
                block_size=kv.block_size,
                layers=kv.layers,
                kv_dim=kv.kv_dim,
                block_bytes=block_bytes,
                recovery=recovery)
            stub = self._stub()
            t0 = time.monotonic()
            sid = stream_create(StreamOptions(
                window_bytes=self._window_bytes(),
                measure=record_measure))
            cntl = Controller()
            cntl.stream_id = sid
            cntl.timeout_ms = int(timeout * 1000)
            ack = stub.MigrateOpen(manifest, controller=cntl)
            if not ack.accepted:
                raise RuntimeError(f"migrate rejected: {ack.message!r}")
            t_open = time.monotonic()
            store = kv.store
            payloads = read_chain_blocks(kv, table, block_bytes)
            t_read = time.monotonic()
            for payload in payloads:
                _fault.maybe_sleep(_fault.hit("serving.migrate.stall"))
                h, n = store.put(payload)
                rc = send_handle(sid, h, n, timeout=timeout)
                if rc != 0:
                    store.free(h)
                    raise RuntimeError(
                        f"migration stream write failed rc={rc}")
            t_send = time.monotonic()
            cntl2 = Controller()
            cntl2.timeout_ms = int(timeout * 1000)
            ack2 = stub.MigrateCommit(
                serving_pb2.MigrateCommitRequest(seq_id=seq.seq_id),
                controller=cntl2)
            if not ack2.accepted:
                raise RuntimeError(
                    f"migrate commit rejected: {ack2.message!r}")
            # the destination ACKed adoption: ownership moves NOW
            kv.release_exported(seq.seq_id)
            t_end = time.monotonic()
            dt = t_end - t0
            with self._lock:
                for name, a, b in (("open", t0, t_open),
                                   ("read", t_open, t_read),
                                   ("send", t_read, t_send),
                                   ("commit", t_send, t_end)):
                    self.phase_s[name] += b - a
                self.seqs += 1
                self.blocks += len(table)
                self.bytes += block_bytes * len(table)
                self.send_s += dt
                if len(self.seq_s) < 65536:
                    self.seq_s.append(dt)
            g_serving_migrate_seqs.put(1)
            g_serving_migrate_blocks.put(len(table))
            g_serving_migrate_bytes.put(block_bytes * len(table))
            return int(ack2.dest_seq_id)
        except (RpcError, RuntimeError, AssertionError, KeyError,
                OSError):
            # the chain never left local ownership: un-arm the export
            # gate and let the caller fall back to local decode
            try:
                kv.unquiesce_sequence(seq.seq_id)
            except Exception:
                pass
            with self._lock:
                self.failed += 1
            g_serving_migrate_failed.put(1)
            return None
        finally:
            if sid:
                stream_close(sid)
            _inflight_delta(-1)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            gbps = (self.bytes / self.send_s / 1e9) if self.send_s else 0.0
            return {"dest": self.dest_addr, "dest_shard": self.dest_shard,
                    "seqs": self.seqs, "blocks": self.blocks,
                    "bytes": self.bytes, "failed": self.failed,
                    "gbps": gbps, "phase_s": dict(self.phase_s)}


# ------------------------------------------------------------- receiver
class _Inbound:
    """One in-flight inbound migration's state machine."""

    __slots__ = ("manifest", "staging_id", "staging_table", "payloads",
                 "state", "event", "dest_seq_id", "message", "lock",
                 "t_open")

    def __init__(self, manifest, staging_id, staging_table):
        self.manifest = manifest
        self.staging_id = staging_id
        self.staging_table = staging_table
        self.payloads: List[bytes] = []
        self.state = "open"  # open -> done | failed
        self.event = threading.Event()
        self.dest_seq_id = 0
        self.message = ""
        self.lock = threading.Lock()
        self.t_open = time.monotonic()


class MigrationReceiver:
    """Destination side: staging alloc, buffer the stream, write the
    pools, adopt, park in the engine. Owned by
    :class:`~brpc_tpu_torch.serving.service.LlmServingService`, whose
    ``MigrateOpen`` / ``MigrateCommit`` handlers delegate here."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._inbound: Dict[int, _Inbound] = {}
        self.seqs_in = 0
        self.failed_in = 0

    # ------------------------------------------------------------- open
    def open(self, cntl, request):
        from brpc_tpu_torch.proto import serving_pb2
        from brpc_tpu_torch.rpc.stream import stream_accept
        from brpc_tpu_torch.serving.kv_cache import KVCacheFull
        from brpc_tpu_torch.tpu.device_stream import host_sink_options

        kv = self.engine.kv

        def reject(msg: str):
            return serving_pb2.MigrateAck(accepted=False, message=msg)

        meta = getattr(cntl, "_srv_meta", None)
        sid = 0
        if meta is not None and meta.stream_settings.stream_id:
            sid = meta.stream_settings.stream_id
        if not sid:
            return reject("migration needs a record stream")
        if (request.block_size != kv.block_size
                or request.layers != kv.layers
                or request.kv_dim != kv.kv_dim):
            return reject(
                f"geometry mismatch: got bs={request.block_size}/"
                f"L={request.layers}/d={request.kv_dim}, pool has "
                f"bs={kv.block_size}/L={kv.layers}/d={kv.kv_dim}")
        if request.block_bytes != chain_block_bytes(kv):
            return reject(f"block_bytes {request.block_bytes} != "
                          f"{chain_block_bytes(kv)}")
        if request.n_blocks != kv.blocks_for(request.ntokens):
            return reject(f"{request.n_blocks} blocks cannot carry "
                          f"{request.ntokens} tokens")
        if not self.engine.running:
            return reject("destination engine is not running")
        # the staging id owns the blocks for the whole transfer; engine
        # sequence ids start at 1, so the negated source id never
        # collides with a live local table
        staging_id = -(abs(int(request.seq_id)) + 1)
        try:
            staging_table = kv.alloc_sequence(staging_id, request.ntokens)
        except (KVCacheFull, ValueError) as e:
            return reject(f"staging alloc failed: {e}")
        inb = _Inbound(request.__class__.FromString(
            request.SerializeToString()), staging_id, staging_table)
        with self._lock:
            self._inbound[int(request.seq_id)] = inb
        _inflight_delta(1)
        window = int(_flags.get("serving_migrate_window_mb")) << 20

        def sink(data: bytes) -> None:
            self._on_block(inb, data)

        def on_closed(_sid: int) -> None:
            # the producer went away without completing: fail, free staging
            self._fail(inb, "stream closed before commit")

        stream_accept(cntl, host_sink_options(
            sink, window, store=kv.store, on_closed=on_closed))
        return serving_pb2.MigrateAck(accepted=True,
                                      blocks=request.n_blocks)

    # ------------------------------------------------------- stream sink
    def _on_block(self, inb: _Inbound, data: bytes) -> None:
        drop = _fault.hit("serving.migrate.drop")
        with inb.lock:
            if inb.state != "open":
                return  # already failed or done: discard stragglers
            if drop is not None:
                pass  # fall through to the failure path below
            elif len(data) != inb.manifest.block_bytes:
                drop = {"reason": f"short block ({len(data)}B)"}
            else:
                inb.payloads.append(data)
                if len(inb.payloads) < inb.manifest.n_blocks:
                    return
        if drop is not None:
            self._fail(inb, str(drop.get("reason",
                                         "destination tunnel killed")))
            return
        self._commit_inbound(inb)

    def _commit_inbound(self, inb: _Inbound) -> None:
        """Every block landed: write the pools, adopt, park. Runs on the
        stream's receive thread; ``pool_gate`` keeps the in-place write
        off the step loop's launches on the same pools."""
        kv = self.engine.kv
        m = inb.manifest
        try:
            with self.engine.pool_gate:
                write_chain_blocks(kv, inb.staging_table, inb.payloads,
                                   m.ntokens)
            seq = self.engine.make_adopted_sequence(
                np.asarray(list(m.prompt_tokens), dtype=np.int32),
                list(m.out_tokens), m.max_new_tokens, m.stop_token)
            kv.adopt_sequence(seq.seq_id, inb.staging_table, m.ntokens)
            if not self.engine.adopt_migrated(seq, recovery=m.recovery):
                kv.free_sequence(seq.seq_id)
                raise RuntimeError("destination engine refused adoption")
        except Exception as e:  # any failure is a clean abort
            self._fail(inb, f"adoption failed: {e}")
            return
        kv.free_sequence(inb.staging_id)  # the chain is seq's alone now
        with inb.lock:
            inb.state = "done"
            inb.dest_seq_id = seq.seq_id
        with self._lock:
            self.seqs_in += 1
        _inflight_delta(-1)
        inb.event.set()

    def _fail(self, inb: _Inbound, msg: str) -> None:
        with inb.lock:
            if inb.state != "open":
                return
            inb.state = "failed"
            inb.message = msg
        self.engine.kv.free_sequence(inb.staging_id)  # no leaked blocks
        with self._lock:
            self.failed_in += 1
            for key, v in list(self._inbound.items()):
                if v is inb:
                    del self._inbound[key]
        _inflight_delta(-1)
        g_serving_migrate_failed.put(1)
        inb.event.set()

    # ------------------------------------------------------------ commit
    def commit(self, cntl, request):
        from brpc_tpu_torch.proto import serving_pb2

        with self._lock:
            inb = self._inbound.pop(int(request.seq_id), None)
        if inb is None:
            return serving_pb2.MigrateAck(
                accepted=False, message=f"no open migration for "
                                        f"sequence {request.seq_id}")
        timeout = float(_flags.get("serving_migrate_timeout_ms")) / 1000.0
        if not inb.event.wait(timeout):
            self._fail(inb, "migration timed out awaiting blocks")
        with inb.lock:
            ok = inb.state == "done"
            return serving_pb2.MigrateAck(
                accepted=ok, dest_seq_id=inb.dest_seq_id,
                blocks=len(inb.payloads), message=inb.message)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"seqs_in": self.seqs_in, "failed_in": self.failed_in,
                    "pending_in": len(self._inbound)}

"""Iteration-level scheduler: continuous batching over the paged KV cache.

The port of ``brpc_tpu/serving/engine.py``'s main path. The engine
thread runs a step loop; each step prefills the sequences admitted since
the last one (one prefill each) and then runs ONE decode step for the
whole running batch. New requests are admitted *between* steps under a
token budget, so a long generation never blocks a short one behind it
(continuous batching). ``scheduling="static"`` keeps the gang behaviour
(admit a batch, drain it, admit the next) as the comparison lane.

Admission: a prompt longer than ``token_budget`` is refused with
EREQUEST (FIFO admission could never pull it, and every request behind
it would wait forever; the JAX engine accepts it and never serves it),
a request whose client deadline (``cntl.deadline_mono``, stamped by the
server's deadline enforcement) is spent is refused with ERPCTIMEDOUT at
submit and again when it reaches the head of the queue, a bounded FIFO
queue refuses past its cap and the KV watermark
(:meth:`PagedKVCache.can_admit`) when the pool would pass it, both with
EOVERCROWDED. A step that raises fails its sequences with EINTERNAL and
the engine carries on; ``stop()`` fails what is left with ELOGOFF and
every KV block returns to the pool.

Completion has two forms. Without a controller, ``done`` receives a
:class:`GenerateResult` for every request, success or failure. With one
(``cntl=``, the RPC path of :class:`~brpc_tpu_torch.serving.service.
LlmServingService`), ``done`` is the server's closure: it receives the
``GenerateResponse``, or None after ``cntl.set_failed``; a request that
arrived with a stream gets one ``TokenDelta`` frame per generated token,
and a connection that fails mid-generation ends its sequence with
EFAILEDSOCKET. Spans get ``prefill_us`` / ``decode_us`` phases, the
profiler the ``prefill`` / ``decode`` phases, ``/vars`` the
``g_serving_*`` counters and recorders, and the fault points
``serving.decode.stall`` and ``serving.kv.exhaust`` are armed as in the
JAX engine. QoS, speculative decoding, the prefix cache and migration are
not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from brpc_tpu_torch import errors
from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.status import PassiveStatus
from brpc_tpu_torch.profiling import registry as _prof
from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.serving.kv_cache import KVCacheFull, PagedKVCache
from brpc_tpu_torch.tpu.device_lane import step_dispatch

_log = logging.getLogger("brpc_tpu_torch")

_fault.register("serving.decode.stall",
                "stall the serving engine's decode step (delay_ms=)")
_fault.register("serving.kv.exhaust",
                "force KV-pool admission rejections (EOVERCROWDED)")

g_serving_steps = Adder("g_serving_steps")
g_serving_tokens = Adder("g_serving_tokens")
g_serving_prefill_tokens = Adder("g_serving_prefill_tokens")
g_serving_admitted = Adder("g_serving_admitted")
g_serving_rejected = Adder("g_serving_rejected")
g_serving_aborted = Adder("g_serving_aborted")
g_serving_completed = Adder("g_serving_completed")
g_serving_deadline_rejects = Adder("g_serving_deadline_rejects")
g_serving_step = LatencyRecorder().expose("g_serving_step")
g_serving_ttft = LatencyRecorder().expose("g_serving_ttft")
g_serving_itl = LatencyRecorder().expose("g_serving_itl")

_engines: List["ServingEngine"] = []
_engines_lock = threading.Lock()


def active_engines() -> List["ServingEngine"]:
    with _engines_lock:
        return [e for e in _engines if e.running]


def _sum_engines(fn) -> int:
    return sum(fn(e) for e in active_engines())


g_serving_queue_depth = PassiveStatus(
    lambda: _sum_engines(lambda e: e.queue_depth)) \
    .expose("g_serving_queue_depth")
g_serving_queue_depth.prometheus_type = "gauge"
g_serving_running = PassiveStatus(
    lambda: _sum_engines(lambda e: e.running_count)) \
    .expose("g_serving_running")
g_serving_running.prometheus_type = "gauge"

SCHED_CONTINUOUS = "continuous"
SCHED_STATIC = "static"


class EngineConfig:
    def __init__(self, max_batch: int = 8, token_budget: int = 512,
                 max_queue: int = 64, max_new_tokens_cap: int = 512,
                 scheduling: str = SCHED_CONTINUOUS,
                 idle_wait_s: float = 0.05):
        if scheduling not in (SCHED_CONTINUOUS, SCHED_STATIC):
            raise ValueError(f"unknown scheduling {scheduling!r}")
        self.max_batch = max_batch
        # per-step budget over prefill tokens + one decode token per
        # running sequence (the Orca iteration-level knob)
        self.token_budget = token_budget
        self.max_queue = max_queue
        self.max_new_tokens_cap = max_new_tokens_cap
        self.scheduling = scheduling
        self.idle_wait_s = idle_wait_s


@dataclasses.dataclass
class GenerateResult:
    """What ``done`` receives: the fields of the JAX engine's
    ``GenerateResponse``, plus the error a failed request ended with
    (``error_code`` 0 on success)."""
    tokens: List[int]
    seq_id: int
    prompt_len: int
    steps: int
    ttft_us: int
    finish_reason: str
    error_code: int = 0
    error_text: str = ""


STATE_WAITING = "waiting"
STATE_RUNNING = "running"
STATE_DONE = "done"


class Sequence:
    """One in-flight generation request."""

    _ids = [0]
    _ids_lock = threading.Lock()

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 stop_token: int = 0, done: Optional[Callable] = None,
                 cntl=None, stream_id: int = 0):
        with Sequence._ids_lock:
            Sequence._ids[0] += 1
            self.seq_id = Sequence._ids[0]
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.stop_token = stop_token
        self.done = done
        self.cntl = cntl
        self.stream_id = stream_id
        self.state = STATE_WAITING
        self.out_tokens: List[int] = []
        self.t_submit = time.monotonic()
        self.t_first_token = 0.0
        self.t_last_token = 0.0
        self.finish_reason = ""

    @property
    def pos(self) -> int:
        """0-based position of the NEXT token to append."""
        return len(self.prompt) + len(self.out_tokens) - 1

    def context_len(self) -> int:
        return len(self.prompt) + len(self.out_tokens)


class ServingEngine:
    def __init__(self, model, kv: Optional[PagedKVCache] = None,
                 config: Optional[EngineConfig] = None):
        self.model = model
        self.kv = kv if kv is not None else model.kv
        self.config = config or EngineConfig()
        self._cv = threading.Condition()
        self._waiting: Deque[Sequence] = collections.deque()
        self._running: List[Sequence] = []
        self._thread: Optional[threading.Thread] = None
        self.running = False
        self.steps = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0
        self.last_step_us = 0.0
        self._occupancy_sum = 0
        self.rejected = 0
        self.ttft_samples: List[float] = []  # us, bounded
        self.itl_samples: List[float] = []   # us, bounded
        self.step_samples: List[float] = []  # us, bounded

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServingEngine":
        with self._cv:
            if self.running:
                return self
            self.running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="brpc-torch-serving-engine")
        self._thread.start()
        with _engines_lock:
            _engines.append(self)
        return self

    def stop(self, abort_code: int = errors.ELOGOFF) -> None:
        with self._cv:
            if not self.running:
                return
            self.running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # fail anything still in flight, then the pool is whole again
        with self._cv:
            pending = list(self._waiting) + list(self._running)
            self._waiting.clear()
            self._running = []
        for seq in pending:
            self._finish(seq, abort_code, "engine stopped")
        with _engines_lock:
            if self in _engines:
                _engines.remove(self)

    # ------------------------------------------------------------ admission
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               stop_token: int = 0, done: Optional[Callable] = None,
               cntl=None, stream_id: int = 0
               ) -> "tuple[int, Optional[Sequence]]":
        """Admission front door (runs on the RPC thread). Returns
        (error_code, seq): 0 and the queued sequence, or a reject code
        (and no sequence; ``done`` is not called for a rejected request,
        the caller surfaces the code through ``cntl.set_failed``).

        ``cntl`` switches ``done`` to the RPC form (see the module doc);
        ``stream_id`` is the server-side stream accepted for the request,
        0 for none."""
        if max_new_tokens < 1:
            return errors.EREQUEST, None
        max_new_tokens = min(max_new_tokens, self.config.max_new_tokens_cap)
        if len(prompt) < 1 or (len(prompt) + max_new_tokens
                               > self.model.config.max_context):
            return errors.EREQUEST, None
        if len(prompt) > self.config.token_budget:
            # FIFO admission pulls a prompt only within one step's budget:
            # a longer one would never run and would block the queue
            return errors.EREQUEST, None
        # deadline at admission (the server's deadline enforcement stamps
        # cntl.deadline_mono; re-checked when the sequence leaves the queue)
        deadline = getattr(cntl, "deadline_mono", 0.0) if cntl else 0.0
        if deadline and time.monotonic() >= deadline:
            g_serving_deadline_rejects.put(1)
            g_serving_rejected.put(1)
            return errors.ERPCTIMEDOUT, None
        if _fault.hit("serving.kv.exhaust") is not None:
            self.kv.note_rejected()
            self.rejected += 1
            g_serving_rejected.put(1)
            return errors.EOVERCROWDED, None
        with self._cv:
            if not self.running:
                return errors.ELOGOFF, None
            if len(self._waiting) >= self.config.max_queue:
                self.rejected += 1
                g_serving_rejected.put(1)
                return errors.EOVERCROWDED, None
            # watermark backpressure counts queued-but-unadmitted prefill
            # tokens too, else a burst overcommits the pool before the
            # step loop catches up
            queued = sum(s.context_len() for s in self._waiting)
            if not self.kv.can_admit(queued + len(prompt)):
                self.kv.note_rejected()
                self.rejected += 1
                g_serving_rejected.put(1)
                return errors.EOVERCROWDED, None
            seq = Sequence(prompt, max_new_tokens, stop_token, done, cntl,
                           stream_id)
            self._waiting.append(seq)
            self._cv.notify()
        return 0, seq

    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    @property
    def running_count(self) -> int:
        return len(self._running)

    # ------------------------------------------------------------ step loop
    def _loop(self) -> None:
        _prof.register_current_thread("serving")
        try:
            while True:
                with self._cv:
                    while (self.running and not self._waiting
                           and not self._running):
                        self._cv.wait(self.config.idle_wait_s)
                    if not self.running:
                        return
                    admitted = self._admit_locked()
                if not admitted and not self._running:
                    # waiting work exists but the pool is full: let
                    # in-flight frees land instead of spinning the step
                    time.sleep(0.002)
                    continue
                try:
                    self._step(admitted)
                except Exception as e:  # the engine must survive a bad step
                    for seq in list(self._running):
                        self._finish(seq, errors.EINTERNAL,
                                     f"step failed: {e!r}")
                    self._running = []
        finally:
            _prof.unregister_current_thread()

    def _admit_locked(self) -> List[Sequence]:
        """Pull waiting sequences into the running set, in FIFO order,
        while a batch slot and step budget remain. Continuous mode refills
        every step; static mode only once the gang has drained."""
        cfg = self.config
        if cfg.scheduling == SCHED_STATIC and self._running:
            return []
        admitted: List[Sequence] = []
        budget = cfg.token_budget - len(self._running)
        while (self._waiting and len(self._running) < cfg.max_batch
               and budget >= len(self._waiting[0].prompt)):
            seq = self._waiting[0]
            deadline = (getattr(seq.cntl, "deadline_mono", 0.0)
                        if seq.cntl else 0.0)
            if deadline and time.monotonic() >= deadline:
                self._waiting.popleft()
                g_serving_deadline_rejects.put(1)
                self._finish(seq, errors.ERPCTIMEDOUT,
                             "deadline expired in serving queue")
                continue
            try:
                self._alloc_for(seq)
            except KVCacheFull:
                break  # keep FIFO order; retry next step
            self._waiting.popleft()
            budget -= len(seq.prompt)
            seq.state = STATE_RUNNING
            self._running.append(seq)
            admitted.append(seq)
            g_serving_admitted.put(1)
        return admitted

    def _alloc_for(self, seq: Sequence) -> None:
        """Allocate ``seq``'s block table (cold: no prefix reuse yet)."""
        self.kv.alloc_sequence(seq.seq_id, seq.context_len())

    def _step(self, admitted: List[Sequence]) -> None:
        t0 = time.perf_counter_ns()
        # ---- prefill phase: one prefill per newly admitted sequence
        if admitted:
            prev = _prof.set_phase("prefill")
            try:
                for seq in admitted:
                    tp0 = time.perf_counter_ns()
                    table = self.kv.block_table(seq.seq_id)
                    first = self.model.prefill(seq.prompt, table)
                    g_serving_prefill_tokens.put(len(seq.prompt))
                    self.prefill_tokens += len(seq.prompt)
                    self._append_token(seq, first)
                    span = getattr(seq.cntl, "span", None)
                    if span is not None:
                        span.add_phase(
                            "prefill_us",
                            (time.perf_counter_ns() - tp0) / 1000.0)
            finally:
                _prof.set_phase(prev)
        self._reap_finished()
        # ---- decode phase: ONE decode step for the whole batch
        batch = list(self._running)
        if batch:
            prev = _prof.set_phase("decode")
            try:
                _fault.maybe_sleep(_fault.hit("serving.decode.stall"))
                td0 = time.perf_counter_ns()
                tokens = np.array([s.out_tokens[-1] for s in batch],
                                  dtype=np.int32)
                # the step's input token (last sampled) is written at the
                # end of the current context, so capacity must cover
                # context_len() and the write position is context_len()-1
                positions = np.array([s.pos for s in batch], dtype=np.int32)
                tables = [self.kv.extend_sequence(s.seq_id, s.context_len())
                          for s in batch]
                # dispatch-count invariant: under an armed ledger the whole
                # decode batch must cost exactly ONE launch + ONE host sync
                audit = (getattr(self.model, "FUSED_STEP", False)
                         and self.kv._check)
                if audit:
                    d_before = step_dispatch.snapshot()
                nxt = self.model.decode_step(tokens, positions, tables)
                if audit:
                    launches, _, syncs = step_dispatch.delta(
                        d_before, step_dispatch.snapshot())
                    if (launches, syncs) != (1, 1):
                        raise AssertionError(
                            f"decode step dispatched {launches} launches / "
                            f"{syncs} host syncs for {len(batch)} seqs; "
                            f"the step contract is exactly (1, 1)")
                decode_us = (time.perf_counter_ns() - td0) / 1000.0
                for s, tok in zip(batch, nxt):
                    self._append_token(s, int(tok))
                for s in batch:
                    span = getattr(s.cntl, "span", None)
                    if span is not None:
                        span.add_phase("decode_us", decode_us / len(batch))
            except KVCacheFull:
                # mid-decode exhaustion: shed the youngest sequence; the
                # admission watermark should make this rare, never fatal
                self._finish(batch[-1], errors.EOVERCROWDED,
                             "kv pool exhausted mid-decode")
                self._running.remove(batch[-1])
            finally:
                _prof.set_phase(prev)
        self._reap_finished()
        self.steps += 1
        self._occupancy_sum += len(batch)
        g_serving_steps.put(1)
        self.last_step_us = (time.perf_counter_ns() - t0) / 1000.0
        g_serving_step.record(self.last_step_us)
        if len(self.step_samples) < 65536:
            self.step_samples.append(self.last_step_us)

    # ----------------------------------------------------------- completion
    def _append_token(self, seq: Sequence, tok: int) -> None:
        now = time.monotonic()
        if not seq.out_tokens:
            seq.t_first_token = now
            g_serving_ttft.record((now - seq.t_submit) * 1e6)
            if len(self.ttft_samples) < 65536:
                self.ttft_samples.append((now - seq.t_submit) * 1e6)
        elif seq.t_last_token:
            g_serving_itl.record((now - seq.t_last_token) * 1e6)
            if len(self.itl_samples) < 65536:
                self.itl_samples.append((now - seq.t_last_token) * 1e6)
        seq.t_last_token = now
        seq.out_tokens.append(tok)
        self.tokens_generated += 1
        g_serving_tokens.put(1)
        stopped = bool(seq.stop_token) and tok == seq.stop_token
        finished = stopped or len(seq.out_tokens) >= seq.max_new_tokens
        self._stream_delta(seq, [tok], finished)
        if finished:
            seq.finish_reason = "stop_token" if stopped else "length"
            seq.state = STATE_DONE

    def _stream_delta(self, seq: Sequence, toks: List[int],
                      done: bool) -> None:
        if not seq.stream_id:
            return
        from brpc_tpu_torch.rpc.stream import stream_write

        delta = serving_pb2.TokenDelta(seq_id=seq.seq_id, tokens=toks,
                                       step=len(seq.out_tokens), done=done)
        if stream_write(seq.stream_id, delta.SerializeToString()) != 0:
            seq.stream_id = 0  # stream died; finish via the RPC response

    def _reap_finished(self) -> None:
        still: List[Sequence] = []
        for seq in self._running:
            sock = getattr(seq.cntl, "_srv_socket", None)
            if sock is not None and getattr(sock, "failed", False):
                # the connection died mid-generation: a retriable error to
                # the sequence, its blocks back to the pool
                self._finish(seq, errors.EFAILEDSOCKET,
                             "connection failed mid-generation")
            elif seq.state == STATE_DONE:
                self._finish(seq, 0, "")
            else:
                still.append(seq)
        self._running = still

    def _finish(self, seq: Sequence, code: int, reason: str) -> None:
        self.kv.free_sequence(seq.seq_id)
        seq.state = STATE_DONE
        if code == 0:
            g_serving_completed.put(1)
        else:
            g_serving_aborted.put(1)
        if seq.stream_id and code != 0:
            from brpc_tpu_torch.rpc.stream import stream_close

            stream_close(seq.stream_id)
            seq.stream_id = 0
        done, seq.done = seq.done, None
        if done is None:
            return
        ttft_us = 0
        if seq.t_first_token:
            ttft_us = int((seq.t_first_token - seq.t_submit) * 1e6)
        if seq.cntl is not None:
            self._finish_rpc(seq, done, code, reason, ttft_us)
            return
        result = GenerateResult(
            tokens=list(seq.out_tokens), seq_id=seq.seq_id,
            prompt_len=len(seq.prompt), steps=len(seq.out_tokens),
            ttft_us=ttft_us, finish_reason=seq.finish_reason or
            ("length" if code == 0 else "error"),
            error_code=code, error_text=reason)
        try:
            done(result)
        except Exception:  # a caller's callback must not kill the engine
            _log.exception("done callback of sequence %d raised",
                           seq.seq_id)

    @staticmethod
    def _finish_rpc(seq: Sequence, done, code: int, reason: str,
                    ttft_us: int) -> None:
        """The RPC form of completion: the server's ``done`` with the
        ``GenerateResponse``, or with None after ``cntl.set_failed``."""
        try:
            if code != 0:
                seq.cntl.set_failed(code, reason)
                done(None)
            else:
                done(serving_pb2.GenerateResponse(
                    tokens=seq.out_tokens, seq_id=seq.seq_id,
                    prompt_len=len(seq.prompt), steps=len(seq.out_tokens),
                    ttft_us=ttft_us,
                    finish_reason=seq.finish_reason or "length"))
        except Exception:  # the response path must not kill the engine
            _log.exception("RPC completion of sequence %d raised",
                           seq.seq_id)

    # ------------------------------------------------------------ visibility
    def snapshot(self) -> Dict[str, object]:
        def pct(samples, q):
            return float(np.percentile(samples, q)) if samples else 0.0

        occ = (self._occupancy_sum / self.steps) if self.steps else 0.0
        return {
            "scheduling": self.config.scheduling,
            "max_batch": self.config.max_batch,
            "token_budget": self.config.token_budget,
            "queue_depth": self.queue_depth,
            "running": self.running_count,
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "prefill_tokens": self.prefill_tokens,
            "rejected": self.rejected,
            "batch_occupancy_avg": round(occ, 3),
            "last_step_us": round(self.last_step_us, 1),
            "step_us_p50": pct(self.step_samples, 50),
            "step_us_p99": pct(self.step_samples, 99),
            "ttft_us_p50": pct(self.ttft_samples, 50),
            "ttft_us_p99": pct(self.ttft_samples, 99),
            "itl_us_p50": pct(self.itl_samples, 50),
            "kv": self.kv.snapshot(),
        }

"""Iteration-level scheduler: continuous batching over the paged KV cache.

The port of ``brpc_tpu/serving/engine.py``'s main path. The engine
thread runs a step loop; each step prefills the sequences admitted since
the last one (one prefill each) and then runs ONE decode step for the
whole running batch. New requests are admitted *between* steps under a
token budget, so a long generation never blocks a short one behind it
(continuous batching). ``scheduling="static"`` keeps the gang behaviour
(admit a batch, drain it, admit the next) as the comparison lane.

Admission: a bounded FIFO queue (EOVERCROWDED past the cap) and the KV
watermark (:meth:`PagedKVCache.can_admit`, EOVERCROWDED when the pool
would pass it). A step that raises fails its sequences with EINTERNAL and
the engine carries on; ``stop()`` fails what is left with ELOGOFF and
every KV block returns to the pool.

``done`` receives a :class:`GenerateResult` for every request, success
or failure. QoS, speculative decoding, the prefix cache, migration,
streaming, fault points and /vars metrics of the JAX engine are not
ported yet.
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
from brpc_tpu_torch.serving.kv_cache import KVCacheFull, PagedKVCache
from brpc_tpu_torch.tpu.device_lane import step_dispatch

_log = logging.getLogger("brpc_tpu_torch")

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
                 stop_token: int = 0,
                 done: Optional[Callable[[GenerateResult], None]] = None):
        with Sequence._ids_lock:
            Sequence._ids[0] += 1
            self.seq_id = Sequence._ids[0]
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.stop_token = stop_token
        self.done = done
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

    # ------------------------------------------------------------ admission
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               stop_token: int = 0,
               done: Optional[Callable[[GenerateResult], None]] = None
               ) -> "tuple[int, Optional[Sequence]]":
        """Admission front door. Returns (error_code, seq): 0 and the
        queued sequence, or a reject code (and no sequence; ``done`` is
        not called for a rejected request)."""
        if max_new_tokens < 1:
            return errors.EREQUEST, None
        max_new_tokens = min(max_new_tokens, self.config.max_new_tokens_cap)
        if len(prompt) < 1 or (len(prompt) + max_new_tokens
                               > self.model.config.max_context):
            return errors.EREQUEST, None
        with self._cv:
            if not self.running:
                return errors.ELOGOFF, None
            if len(self._waiting) >= self.config.max_queue:
                self.rejected += 1
                return errors.EOVERCROWDED, None
            # watermark backpressure counts queued-but-unadmitted prefill
            # tokens too, else a burst overcommits the pool before the
            # step loop catches up
            queued = sum(s.context_len() for s in self._waiting)
            if not self.kv.can_admit(queued + len(prompt)):
                self.kv.note_rejected()
                self.rejected += 1
                return errors.EOVERCROWDED, None
            seq = Sequence(prompt, max_new_tokens, stop_token, done)
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
        while True:
            with self._cv:
                while (self.running and not self._waiting
                       and not self._running):
                    self._cv.wait(self.config.idle_wait_s)
                if not self.running:
                    return
                admitted = self._admit_locked()
            if not admitted and not self._running:
                # waiting work exists but the pool is full: let in-flight
                # frees land instead of spinning the step
                time.sleep(0.002)
                continue
            try:
                self._step(admitted)
            except Exception as e:  # the engine must survive a bad step
                for seq in list(self._running):
                    self._finish(seq, errors.EINTERNAL,
                                 f"step failed: {e!r}")
                self._running = []

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
            try:
                self._alloc_for(seq)
            except KVCacheFull:
                break  # keep FIFO order; retry next step
            self._waiting.popleft()
            budget -= len(seq.prompt)
            seq.state = STATE_RUNNING
            self._running.append(seq)
            admitted.append(seq)
        return admitted

    def _alloc_for(self, seq: Sequence) -> None:
        """Allocate ``seq``'s block table (cold: no prefix reuse yet)."""
        self.kv.alloc_sequence(seq.seq_id, seq.context_len())

    def _step(self, admitted: List[Sequence]) -> None:
        t0 = time.perf_counter_ns()
        # ---- prefill phase: one prefill per newly admitted sequence
        for seq in admitted:
            table = self.kv.block_table(seq.seq_id)
            first = self.model.prefill(seq.prompt, table)
            self.prefill_tokens += len(seq.prompt)
            self._append_token(seq, first)
        self._reap_finished()
        # ---- decode phase: ONE decode step for the whole batch
        batch = list(self._running)
        if batch:
            try:
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
                for s, tok in zip(batch, nxt):
                    self._append_token(s, int(tok))
            except KVCacheFull:
                # mid-decode exhaustion: shed the youngest sequence; the
                # admission watermark should make this rare, never fatal
                self._finish(batch[-1], errors.EOVERCROWDED,
                             "kv pool exhausted mid-decode")
                self._running.remove(batch[-1])
        self._reap_finished()
        self.steps += 1
        self._occupancy_sum += len(batch)
        self.last_step_us = (time.perf_counter_ns() - t0) / 1000.0
        if len(self.step_samples) < 65536:
            self.step_samples.append(self.last_step_us)

    # ----------------------------------------------------------- completion
    def _append_token(self, seq: Sequence, tok: int) -> None:
        now = time.monotonic()
        if not seq.out_tokens:
            seq.t_first_token = now
            if len(self.ttft_samples) < 65536:
                self.ttft_samples.append((now - seq.t_submit) * 1e6)
        elif seq.t_last_token and len(self.itl_samples) < 65536:
            self.itl_samples.append((now - seq.t_last_token) * 1e6)
        seq.t_last_token = now
        seq.out_tokens.append(tok)
        self.tokens_generated += 1
        stopped = bool(seq.stop_token) and tok == seq.stop_token
        if stopped or len(seq.out_tokens) >= seq.max_new_tokens:
            seq.finish_reason = "stop_token" if stopped else "length"
            seq.state = STATE_DONE

    def _reap_finished(self) -> None:
        still: List[Sequence] = []
        for seq in self._running:
            if seq.state == STATE_DONE:
                self._finish(seq, 0, "")
            else:
                still.append(seq)
        self._running = still

    def _finish(self, seq: Sequence, code: int, reason: str) -> None:
        self.kv.free_sequence(seq.seq_id)
        seq.state = STATE_DONE
        done, seq.done = seq.done, None
        if done is None:
            return
        ttft_us = 0
        if seq.t_first_token:
            ttft_us = int((seq.t_first_token - seq.t_submit) * 1e6)
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

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
JAX engine.

The reference's defaults: a radix prefix cache (``serving/
prefix_cache.py``) is built over the pool whenever the model has
``prefill_suffix`` and gates every admission on the
``serving_prefix_cache_enabled`` flag. A prompt whose block-aligned
prefix is cached forks that chain (no copy) and prefills only the
suffix, in one decode-shaped launch; a finished sequence commits its
full blocks into the tree; ``prefix_cache=False`` turns the cache off.
``EngineConfig(spec_k=k)`` turns each decode step into k drafted tokens
per sequence (``serving/speculative.py``, host-side prompt lookup) and
one ``verify_step`` launch, committing the longest accepted prefix plus
one bonus token; greedy acceptance keeps the tokens those of
``spec_k=0``.

Disaggregated serving, as in the reference: ``EngineConfig(role=)``
places an engine. A ``"prefill"`` engine with a migrator
(:meth:`ServingEngine.set_migrator`, a ``serving/migration.KVMigrator``)
hands every chain to its destination right after prefill and completes
the request with ``finish_reason="handoff"``, the adopted sequence's id
and ``handoff_shard``; a failed migration leaves the sequence decoding
here. A migrated-in sequence is parked until a ``submit(...,
resume_seq_id=)`` attaches a client, which then receives only the tokens
decoded here. Any engine with a migrator drains its live sequences to
the destination on ``stop()`` (shard death): each request fails
retriably with EFAILEDSOCKET, and its retry, the same prompt, attaches
by prompt match to the migrated sequence with no prefill. ``pool_gate``
serializes the step's launches against a migration writing the pools.

Over a :class:`~brpc_tpu_torch.serving.kv_cache.ShardedKVCache` (a
:class:`~brpc_tpu_torch.serving.mesh_model.MeshTransformer`'s dp
shards), a prompt is placed on its prefix-hash shard at submit and at
allocation, the watermark is the owning shard's, and ``snapshot()``'s
``shard_steps`` attributes each decode step to the shards whose
sequences it ran.

Multi-tenant QoS, as in the reference: ``EngineConfig(qos=QosConfig(...))``
replaces the FIFO queue with ``serving/qos.TenantScheduler``'s weighted
fair-share lanes (a request bills ``tenant_id``'s lane, from ``cntl`` or
passed to ``submit``; ``priority`` at or above ``protected_priority``
rides the protected lane), re-checks the deadline, the lane's cap and
the closed loop's ceiling at every enqueue (EOVERCROWDED, retriable),
and installs ``QosGovernor`` on the series sampler's post-tick hooks,
which shrinks the ceiling under rising queue wait and sheds queued
best-effort work down to it. The ``serving.qos.burst`` fault point
clones a tenant's submits. ``qos=None`` (the default) keeps the FIFO
path as it was.
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
from brpc_tpu_torch.serving import qos as _qos
from brpc_tpu_torch.serving import speculative as _spec
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

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_BOTH = "both"


class EngineConfig:
    def __init__(self, max_batch: int = 8, token_budget: int = 512,
                 max_queue: int = 64, max_new_tokens_cap: int = 512,
                 scheduling: str = SCHED_CONTINUOUS,
                 idle_wait_s: float = 0.05, role: str = ROLE_BOTH,
                 spec_k: int = 0, spec_ngram: int = 3,
                 spec_collapse_after: int = 4, qos=None):
        if scheduling not in (SCHED_CONTINUOUS, SCHED_STATIC):
            raise ValueError(f"unknown scheduling {scheduling!r}")
        if role not in (ROLE_PREFILL, ROLE_DECODE, ROLE_BOTH):
            raise ValueError(f"unknown role {role!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.max_batch = max_batch
        # per-step budget over prefill tokens + one decode token per
        # running sequence (the Orca iteration-level knob)
        self.token_budget = token_budget
        self.max_queue = max_queue
        self.max_new_tokens_cap = max_new_tokens_cap
        self.scheduling = scheduling
        self.idle_wait_s = idle_wait_s
        # disaggregated serving: a "prefill" engine runs prefill, then
        # migrates each chain to its KVMigrator's destination (decoding
        # locally when that fails); a "decode" engine mostly adopts
        # migrated sequences but still takes fresh submissions (a role is
        # placement, not capability)
        self.role = role
        # speculative decoding: spec_k > 0 turns each decode step into
        # draft-k + one verify launch; per sequence the AdaptiveK
        # controller shrinks k on rejection and collapses to plain decode
        # after spec_collapse_after consecutive zero-accept steps
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.spec_collapse_after = spec_collapse_after
        # multi-tenant QoS: a serving.qos.QosConfig turns admission into
        # weighted fair share and the closed-loop overload governor; None
        # keeps the single-tenant FIFO path
        self.qos = qos


@dataclasses.dataclass
class GenerateResult:
    """What ``done`` receives: the fields of the JAX engine's
    ``GenerateResponse``, plus the error a failed request ended with
    (``error_code`` 0 on success). A handoff (``finish_reason
    "handoff"``) names the adopted sequence in ``seq_id`` and its engine
    in ``handoff_shard``."""
    tokens: List[int]
    seq_id: int
    prompt_len: int
    steps: int
    ttft_us: int
    finish_reason: str
    error_code: int = 0
    error_text: str = ""
    handoff_shard: int = 0


STATE_WAITING = "waiting"
STATE_RUNNING = "running"
STATE_DONE = "done"


class Sequence:
    """One in-flight generation request."""

    _ids = [0]
    _ids_lock = threading.Lock()

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 stop_token: int = 0, done: Optional[Callable] = None,
                 cntl=None, stream_id: int = 0, tenant_id: str = "",
                 priority: int = 0):
        with Sequence._ids_lock:
            Sequence._ids[0] += 1
            self.seq_id = Sequence._ids[0]
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.stop_token = stop_token
        self.done = done
        self.cntl = cntl
        self.stream_id = stream_id
        # QoS identity: which fair-share lane this bills, and how
        # protected it is under shedding
        self.tenant_id = tenant_id
        self.priority = priority
        self.state = STATE_WAITING
        self.out_tokens: List[int] = []
        # tokens covered by a forked prefix-cache chain (block-aligned);
        # prefill runs only the suffix past this point
        self.prefix_len = 0
        # the per-sequence AdaptiveK, made at its first speculative step
        self.spec = None
        self.t_submit = time.monotonic()
        self.t_first_token = 0.0
        self.t_last_token = 0.0
        self.finish_reason = ""
        # disaggregation: a migrated-in sequence is "adopted" and decodes
        # with no client until a resume or retry attaches one;
        # handoff_base counts the out_tokens the prefill engine already
        # returned (a resume attach replies only the suffix)
        self.adopted = False
        self.handoff_base = 0
        self.resume_attach = False
        self._attached = False
        self._deferred: Optional[tuple] = None

    @property
    def pos(self) -> int:
        """0-based position of the NEXT token to append."""
        return len(self.prompt) + len(self.out_tokens) - 1

    def context_len(self) -> int:
        return len(self.prompt) + len(self.out_tokens)


class ServingEngine:
    def __init__(self, model, kv: Optional[PagedKVCache] = None,
                 config: Optional[EngineConfig] = None, prefix_cache=None):
        self.model = model
        self.kv = kv if kv is not None else model.kv
        self.config = config or EngineConfig()
        # radix prefix cache: None builds one over the pool (each
        # admission still reads the serving_prefix_cache_enabled flag),
        # False turns it off (cold lanes, comparison runs)
        if prefix_cache is None and hasattr(model, "prefill_suffix"):
            from brpc_tpu_torch.serving.prefix_cache import \
                build_prefix_cache
            prefix_cache = build_prefix_cache(self.kv)
        self.prefix = prefix_cache or None
        # per-engine speculative counters (the module's g_serving_spec_*
        # variables sum the process)
        self.spec_stats = (_spec.SpecStats()
                           if self.config.spec_k > 0 else None)
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
        # disaggregation: the migrator ships chains OUT (set_migrator),
        # the receiver (installed by LlmServingService) adopts chains IN;
        # _adopted parks migrated-in sequences until a client attaches,
        # and _adopted_pending holds them for a max_batch slot
        self.migrator = None
        self._migration_rx = None
        self._adopted: Dict[int, Sequence] = {}
        self._adopted_pending: Deque[Sequence] = collections.deque()
        self._recover_index: Dict[tuple, Deque[int]] = {}
        # serializes pool writes between the step loop's launches and a
        # migration writing an adopted chain into the pools
        self.pool_gate = threading.Lock()
        # per-shard decode attribution: shard -> [steps, total_us,
        # last_us, seq_steps] (only shards with live sequences tick)
        self._shard_step: Dict[int, List[float]] = {}
        # multi-tenant QoS: the fair-share scheduler replaces _waiting as
        # the queue and the governor closes the overload loop from the
        # sampler tick (installed in start())
        self.qos = (_qos.TenantScheduler(self.config.qos, engine=self)
                    if self.config.qos is not None else None)
        self._qos_governor = (_qos.QosGovernor(self)
                              if self.qos is not None else None)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServingEngine":
        with self._cv:
            if self.running:
                return self
            self.running = True
        if self._qos_governor is not None:
            # the governor rides the 1 Hz sampler tick, sampling the
            # queue-wait series ring the sweep just filled
            from brpc_tpu_torch.metrics.series import (
                ensure_series_installed, global_series)

            ensure_series_installed()
            hooks = global_series().post_tick_hooks
            if self._qos_governor not in hooks:
                hooks.append(self._qos_governor)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="brpc-torch-serving-engine")
        self._thread.start()
        with _engines_lock:
            _engines.append(self)
        return self

    def set_migrator(self, migrator) -> "ServingEngine":
        """Install the outbound KV migrator (serving/migration.py). A
        prefill-role engine hands every prefilled chain to it from the
        step loop; ANY engine with one drains its live sequences to the
        destination on stop() instead of aborting them."""
        self.migrator = migrator
        return self

    def stop(self, abort_code: int = errors.ELOGOFF) -> None:
        with self._cv:
            if not self.running:
                return
            self.running = False
            self._cv.notify_all()
        if self._qos_governor is not None:
            from brpc_tpu_torch.metrics.series import global_series

            try:
                global_series().post_tick_hooks.remove(self._qos_governor)
            except ValueError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # shard-death recovery: with a migrator, live chains move to the
        # survivor (the step loop has ended, so every sequence is
        # quiescent) before anything is aborted or the tree is cleared
        if self.migrator is not None:
            self._drain_migrate()
        # fail anything still in flight, then the pool is whole again
        self._abort_all_locked_out(abort_code, "engine stopped")
        with self._cv:
            self._adopted.clear()
            self._recover_index.clear()
        if self.prefix is not None:
            # release every tree hold so assert_idle sees the pool whole
            self.prefix.clear()
        with _engines_lock:
            if self in _engines:
                _engines.remove(self)

    # ------------------------------------------------------------ admission
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               stop_token: int = 0, done: Optional[Callable] = None,
               cntl=None, stream_id: int = 0, resume_seq_id: int = 0,
               tenant_id: Optional[str] = None,
               priority: Optional[int] = None, _synthetic: bool = False
               ) -> "tuple[int, Optional[Sequence]]":
        """Admission front door (runs on the RPC thread). Returns
        (error_code, seq): 0 and the queued sequence, or a reject code
        (and no sequence; ``done`` is not called for a rejected request,
        the caller surfaces the code through ``cntl.set_failed``).

        ``cntl`` switches ``done`` to the RPC form (see the module doc);
        ``stream_id`` is the server-side stream accepted for the request,
        0 for none. ``resume_seq_id`` attaches to a migrated-in sequence
        (the handoff reply named it): no admission, no allocation, the
        chain is already here.

        ``tenant_id`` / ``priority`` default to the wire identity on
        ``cntl``; pass them when no controller carries them.
        ``_synthetic`` marks the clones of the ``serving.qos.burst``
        fault point, so they do not fire it again."""
        if resume_seq_id:
            with self._cv:
                seq = self._adopted.get(resume_seq_id)
            if seq is None:
                return errors.EREQUEST, None
            return self._bind_attach(seq, cntl, done, stream_id,
                                     resume=True)
        if max_new_tokens < 1:
            return errors.EREQUEST, None
        max_new_tokens = min(max_new_tokens, self.config.max_new_tokens_cap)
        if len(prompt) < 1 or (len(prompt) + max_new_tokens
                               > self.model.config.max_context):
            return errors.EREQUEST, None
        # shard-death recovery: a retried request whose sequence was
        # drained here picks up the live generation, no prefill
        if self._recover_index:
            cand = self._recover_match(prompt, max_new_tokens, stop_token)
            if cand is not None:
                return self._bind_attach(cand, cntl, done, stream_id,
                                         resume=False)
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
        if tenant_id is None:
            tenant_id = getattr(cntl, "tenant_id", "") if cntl else ""
        if priority is None:
            priority = getattr(cntl, "priority", 0) if cntl else 0
        if self.qos is not None and not _synthetic:
            # chaos: inflate this tenant's arrival rate at admission;
            # each real submit fans out factor - 1 synthetic clones that
            # bill the same lane (and shed the same way)
            burst = _fault.hit("serving.qos.burst", tenant=tenant_id)
            if burst is not None:
                for _ in range(max(0, int(burst.get("factor", 2)) - 1)):
                    self.submit(prompt, max_new_tokens,
                                stop_token=stop_token, tenant_id=tenant_id,
                                priority=priority, _synthetic=True)
        with self._cv:
            if not self.running:
                return errors.ELOGOFF, None
            if self.qos is None \
                    and len(self._waiting) >= self.config.max_queue:
                self.rejected += 1
                g_serving_rejected.put(1)
                return errors.EOVERCROWDED, None
            # watermark backpressure counts queued-but-unadmitted prefill
            # tokens too, else a burst overcommits the pool before the
            # step loop catches up
            seq = Sequence(prompt, max_new_tokens, stop_token, done, cntl,
                           stream_id, tenant_id=tenant_id, priority=priority)
            queued = sum(s.context_len() for s in self._iter_waiting())
            need = queued + len(prompt)
            shard = None
            if self.prefix is not None:
                # a cached prefix's blocks already count in the pool's
                # occupancy: only the suffix is new demand; prefix-hash
                # placement beats the seq-id route, so a hit lands on the
                # shard holding the chain
                shard = self.prefix.route_shard(prompt)
                need = queued + max(1, len(prompt)
                                    - self.prefix.match_len(prompt))
            if not self.kv.can_admit(need, route_key=seq.seq_id,
                                     shard=shard):
                # before refusing, ask the tree to give back LRU
                # refcount-1 chains; the watermark itself is unchanged
                if not (self.prefix is not None
                        and self.prefix.evict_for_admission(
                            need, shard=shard, route_key=seq.seq_id)
                        and self.kv.can_admit(need, route_key=seq.seq_id,
                                              shard=shard)):
                    self.kv.note_rejected()
                    self.rejected += 1
                    g_serving_rejected.put(1)
                    return errors.EOVERCROWDED, None
            if self.qos is not None:
                # the tenant's fair-share lane: enqueue re-evaluates the
                # QoS predicate (deadline, lane cap, ceiling) under the
                # lock, so the check and the append are one decision
                code = self.qos.enqueue(seq)
                if code != 0:
                    if code == errors.ERPCTIMEDOUT:
                        g_serving_deadline_rejects.put(1)
                    self.rejected += 1
                    g_serving_rejected.put(1)
                    return code, None
            else:
                self._waiting.append(seq)
            self._cv.notify()
        return 0, seq

    def _iter_waiting(self):
        """Every queued, not yet admitted sequence (lock held): the FIFO
        deque, or the fair-share lanes with QoS on."""
        if self.qos is not None:
            return self.qos.iter_waiting()
        return iter(self._waiting)

    @property
    def queue_depth(self) -> int:
        if self.qos is not None:
            return self.qos.total_depth()
        return len(self._waiting)

    @property
    def running_count(self) -> int:
        return len(self._running)

    # -------------------------------------------------- migration adoption
    def make_adopted_sequence(self, prompt: np.ndarray,
                              out_tokens: List[int], max_new_tokens: int,
                              stop_token: int = 0) -> Sequence:
        """The destination-side Sequence of a migrated chain. The caller
        (MigrationReceiver) adopts the KV under its ``seq_id`` BEFORE
        handing it to :meth:`adopt_migrated`: the step loop never sees
        the sequence without blocks."""
        seq = Sequence(prompt, max_new_tokens, stop_token)
        seq.out_tokens = list(out_tokens)
        seq.handoff_base = len(out_tokens)
        seq.adopted = True
        seq.state = STATE_RUNNING
        # the source engine recorded TTFT; t_last_token stays 0 so the
        # first local decode restarts the ITL clock (transfer and slot
        # wait belong to the handoff, not to this engine's token gap)
        seq.t_first_token = time.monotonic()
        seq.t_last_token = 0.0
        return seq

    def adopt_migrated(self, seq: Sequence, recovery: bool = False) -> bool:
        """Queue a migrated-in sequence (its KV already adopted) for
        decode. The step loop moves it into the running set under the
        same max_batch cap as admission; its tokens wait on the sequence
        until a client attaches. ``recovery`` also indexes it for the
        attach by prompt match (a retry after shard death has no
        resume_seq_id: the original reply never arrived)."""
        with self._cv:
            if not self.running:
                return False
            self._adopted[seq.seq_id] = seq
            if recovery:
                key = (tuple(int(t) for t in seq.prompt),
                       int(seq.max_new_tokens), int(seq.stop_token))
                self._recover_index.setdefault(
                    key, collections.deque()).append(seq.seq_id)
            self._adopted_pending.append(seq)
            self._cv.notify()
        return True

    def _recover_match(self, prompt: np.ndarray, max_new_tokens: int,
                       stop_token: int) -> Optional[Sequence]:
        key = (tuple(int(t) for t in prompt), int(max_new_tokens),
               int(stop_token))
        with self._cv:
            dq = self._recover_index.get(key)
            while dq:
                rid = dq.popleft()
                if not dq:
                    self._recover_index.pop(key, None)
                    dq = None
                cand = self._adopted.get(rid)
                if cand is not None and not cand._attached:
                    return cand
        return None

    def _bind_attach(self, seq: Sequence, cntl, done, stream_id: int,
                     resume: bool) -> "tuple[int, Optional[Sequence]]":
        """Attach a client to a parked migrated sequence. A live one
        streams the tokens decoded since the handoff and keeps decoding;
        a finished one completes the request at once from its deferred
        result."""
        with self._cv:
            if seq._attached or seq.done is not None:
                return errors.EREQUEST, None
            seq._attached = True
            seq.resume_attach = resume
            seq.cntl = cntl
            seq.stream_id = stream_id
            deferred = seq._deferred
            base = seq.handoff_base if resume else 0
            replay = list(seq.out_tokens[base:])
            finished = seq.state == STATE_DONE
            if deferred is None:
                seq.done = done
            else:
                self._adopted.pop(seq.seq_id, None)
        if deferred is not None:
            if done is not None:
                self._complete(seq, done, *deferred)
            return 0, seq
        if replay and stream_id:
            # catch the client up on tokens decoded before it attached
            self._stream_delta(seq, replay, finished)
        return 0, seq

    # ------------------------------------------------------------ step loop
    def _loop(self) -> None:
        _prof.register_current_thread("serving")
        try:
            while True:
                with self._cv:
                    while (self.running and not self._waiting
                           and not self._running
                           and not self._adopted_pending
                           and (self.qos is None
                                or self.qos.total_depth() == 0)):
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
                    with self.pool_gate:
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
        # migrated-in chains first (already prefilled), capped by
        # max_batch so a burst of migrations never grows the decode
        # batch past what admission itself would run
        while self._adopted_pending and len(self._running) < cfg.max_batch:
            seq = self._adopted_pending.popleft()
            self._running.append(seq)
            admitted.append(seq)
        # a speculating sequence can commit up to 1 + k tokens a step, so
        # it reserves that many budget slots, not one
        budget = cfg.token_budget - sum(self._decode_cost(s)
                                        for s in self._running)
        if self.qos is not None:
            return self._admit_qos_locked(admitted, budget)
        while (self._waiting and len(self._running) < cfg.max_batch
               and budget >= self._prefill_cost(self._waiting[0])):
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
                # one retry after asking the tree for its LRU refcount-1
                # chains; still full means out of headroom: keep FIFO
                # order and retry next step
                if not (self.prefix is not None
                        and self.prefix.evict_for_admission(
                            seq.context_len(), route_key=seq.seq_id)):
                    break
                try:
                    self._alloc_for(seq)
                except KVCacheFull:
                    break
            self._waiting.popleft()
            budget -= self._prefill_cost(seq)
            seq.state = STATE_RUNNING
            self._running.append(seq)
            admitted.append(seq)
            g_serving_admitted.put(1)
        return admitted

    def _admit_qos_locked(self, admitted: List[Sequence],
                          budget: int) -> List[Sequence]:
        """Fair-share admission: each pull serves the backlogged tenant
        with the smallest virtual clock (stride scheduling meters the
        step's token budget by weight); the deadline is re-checked per
        sequence as the FIFO path does, and a head the pool cannot take
        keeps its turn for the next step's full budget."""
        cfg = self.config
        while len(self._running) < cfg.max_batch:
            seq = self.qos.peek(budget, self._prefill_cost)
            if seq is None:
                break
            deadline = (getattr(seq.cntl, "deadline_mono", 0.0)
                        if seq.cntl else 0.0)
            if deadline and time.monotonic() >= deadline:
                self.qos.drop(seq)
                g_serving_deadline_rejects.put(1)
                self._finish(seq, errors.ERPCTIMEDOUT,
                             "deadline expired in serving queue")
                continue
            try:
                self._alloc_for(seq)
            except KVCacheFull:
                if not (self.prefix is not None
                        and self.prefix.evict_for_admission(
                            seq.context_len(), route_key=seq.seq_id)):
                    break
                try:
                    self._alloc_for(seq)
                except KVCacheFull:
                    break
            cost = self._prefill_cost(seq)
            self.qos.commit(seq, cost)
            budget -= cost
            seq.state = STATE_RUNNING
            self._running.append(seq)
            admitted.append(seq)
            g_serving_admitted.put(1)
        return admitted

    def _decode_cost(self, seq: Sequence) -> int:
        """Step-budget cost of one decode step for ``seq``: the most
        tokens it can commit (1 + its current draft length)."""
        if self.config.spec_k <= 0:
            return 1
        k = seq.spec.k if seq.spec is not None else self.config.spec_k
        return 1 + k

    def _prefill_cost(self, seq: Sequence) -> int:
        """Step-budget cost of prefilling ``seq``: only the suffix past
        the cached prefix runs through the model (>= 1: the first token
        is always sampled here)."""
        if self.prefix is None:
            return len(seq.prompt)
        if seq.prefix_len:  # already forked (allocated, not yet stepped)
            return max(1, len(seq.prompt) - seq.prefix_len)
        return max(1, len(seq.prompt) - self.prefix.match_len(seq.prompt))

    def _alloc_for(self, seq: Sequence) -> None:
        """Allocate ``seq``'s block table, forking the longest cached
        prefix chain when the tree has one (refcount++, no copy), else
        cold: on a sharded pool the cold table is placed on the prompt's
        prefix-hash shard, so a first-seen prefix builds its chain where
        later hits will route to."""
        if self.prefix is None:
            self.kv.alloc_sequence(seq.seq_id, seq.context_len())
            return
        matched = self.prefix.fork(seq.seq_id, seq.prompt)
        if not matched:
            shard = self.prefix.route_shard(seq.prompt)
            if shard is None:
                self.kv.alloc_sequence(seq.seq_id, seq.context_len())
            else:
                self.kv.alloc_sequence(seq.seq_id, seq.context_len(),
                                       shard=shard)
            return
        seq.prefix_len = matched
        try:
            # grow the adopted chain to cover the prompt + decode slot
            self.kv.extend_sequence(seq.seq_id, seq.context_len())
        except KVCacheFull:
            self.kv.free_sequence(seq.seq_id)  # unwind the fork
            seq.prefix_len = 0
            raise

    def _step(self, admitted: List[Sequence]) -> None:
        t0 = time.perf_counter_ns()
        # ---- prefill phase: one prefill per newly admitted sequence
        if admitted:
            prev = _prof.set_phase("prefill")
            try:
                for seq in admitted:
                    if seq.adopted:
                        continue  # the chain arrived prefilled
                    tp0 = time.perf_counter_ns()
                    if seq.prefix_len:
                        # forked chain: split the divergence block if it
                        # is shared, then run only the suffix (one
                        # decode-shaped launch)
                        self.kv.ensure_writable(seq.seq_id, seq.prefix_len)
                        table = self.kv.block_table(seq.seq_id)
                        first = self.model.prefill_suffix(
                            seq.prompt, table, seq.prefix_len)
                        n = len(seq.prompt) - seq.prefix_len
                    else:
                        table = self.kv.block_table(seq.seq_id)
                        first = self.model.prefill(seq.prompt, table)
                        n = len(seq.prompt)
                    g_serving_prefill_tokens.put(n)
                    self.prefill_tokens += n
                    self._append_token(seq, first)
                    span = getattr(seq.cntl, "span", None)
                    if span is not None:
                        span.add_phase(
                            "prefill_us",
                            (time.perf_counter_ns() - tp0) / 1000.0)
            finally:
                _prof.set_phase(prev)
        self._reap_finished()
        # ---- disaggregated handoff: a prefill-role engine ships every
        # live chain to the decode engine right after its first token; a
        # failed migration leaves the sequence here (local decode), tried
        # again next step
        if self.config.role == ROLE_PREFILL and self.migrator is not None:
            self._migrate_handoff()
        # ---- decode phase: ONE decode step for the whole batch
        batch = list(self._running)
        if batch:
            prev = _prof.set_phase("decode")
            try:
                _fault.maybe_sleep(_fault.hit("serving.decode.stall"))
                td0 = time.perf_counter_ns()
                spec_on = (self.config.spec_k > 0
                           and hasattr(self.model, "verify_step"))
                tokens = np.array([s.out_tokens[-1] for s in batch],
                                  dtype=np.int32)
                # the step's input token (last sampled) is written at the
                # end of the current context, so capacity must cover
                # context_len() and the write position is context_len()-1
                positions = np.array([s.pos for s in batch], dtype=np.int32)
                drafts = (self._draft(batch) if spec_on
                          else [[] for _ in batch])
                tables = [self.kv.extend_sequence(
                    s.seq_id, s.context_len() + len(d))
                    for s, d in zip(batch, drafts)]
                # dispatch-count invariant: under an armed ledger the whole
                # decode batch, all k+1 verify rows per sequence included,
                # must cost exactly ONE launch + ONE host sync of this
                # thread (another engine in the process counts apart)
                audit = (getattr(self.model, "FUSED_STEP", False)
                         and self.kv._check)
                if audit:
                    d_before = step_dispatch.thread_snapshot()
                if spec_on:
                    outs = self.model.verify_step(tokens, positions, tables,
                                                  drafts)
                else:
                    nxt = self.model.decode_step(tokens, positions, tables)
                if audit:
                    launches, _, syncs = step_dispatch.delta(
                        d_before, step_dispatch.thread_snapshot())
                    if (launches, syncs) != (1, 1):
                        raise AssertionError(
                            f"decode step dispatched {launches} launches / "
                            f"{syncs} host syncs for {len(batch)} seqs; "
                            f"the step contract is exactly (1, 1)")
                decode_us = (time.perf_counter_ns() - td0) / 1000.0
                shards_live: Dict[int, int] = {}
                for tbl in tables:
                    sh = getattr(tbl, "shard", 0)
                    shards_live[sh] = shards_live.get(sh, 0) + 1
                for sh, n_live in shards_live.items():
                    st = self._shard_step.setdefault(sh, [0, 0.0, 0.0, 0])
                    st[0] += 1
                    st[1] += decode_us
                    st[2] = decode_us
                    st[3] += n_live
                if spec_on:
                    self._commit_speculative(batch, drafts, outs)
                else:
                    for s, tok in zip(batch, nxt):
                        self._append_token(s, int(tok))
                for s in batch:
                    span = getattr(s.cntl, "span", None)
                    if span is not None:
                        span.add_phase("decode_us", decode_us / len(batch))
            except KVCacheFull:
                # mid-decode exhaustion: shed the youngest sequence; the
                # admission watermark should make this rare, never fatal.
                # Speculative headroom blocks taken before the failure go
                # back first, so the shed is no bigger than without drafts
                if self.config.spec_k > 0:
                    for s in batch:
                        self.kv.truncate_sequence(s.seq_id, s.context_len())
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

    def _draft(self, batch: List[Sequence]) -> List[List[int]]:
        """The draft lane: host-side prompt lookup over each sequence's
        committed history, no device work before the one verify launch.
        k is capped at remaining - 1 (a full accept plus the bonus lands
        exactly on max_new_tokens), so the chain never outgrows the KV
        bound admission allowed."""
        cfg = self.config
        vocab = getattr(self.model.config, "vocab", 0)
        drafts = []
        for s in batch:
            if s.spec is None:
                s.spec = _spec.AdaptiveK(cfg.spec_k, cfg.spec_collapse_after)
            k = min(s.spec.k, max(0, s.max_new_tokens
                                  - len(s.out_tokens) - 1))
            drafts.append(_spec.draft_tokens(
                list(s.prompt) + s.out_tokens, k, cfg.spec_ngram, vocab)
                if k > 0 else [])
        return drafts

    def _commit_speculative(self, batch: List[Sequence],
                            drafts: List[List[int]],
                            outs: List[np.ndarray]) -> None:
        """Greedy acceptance and KV rollback for one verify step. Per
        sequence: commit the longest draft prefix agreeing with the
        verifier's argmax plus the one bonus token (cut short at stop or
        max_new), stream ONE TokenDelta carrying the accepted count, drop
        rejected tail blocks (``truncate_sequence``; the rejected K/V left
        inside kept blocks sits past the committed context, and the next
        step's rows rewrite each such position before any row attends to
        it), and feed the AdaptiveK controller."""
        step_drafted = step_accepted = 0
        st = self.spec_stats
        for s, d, m in zip(batch, drafts, outs):
            a, committed = _spec.accept_longest_prefix(d, m)
            ncommit = 0
            for tok in committed:
                self._append_token(s, tok, stream=False)
                ncommit += 1
                if s.state == STATE_DONE:
                    break
            accepted_sent = min(ncommit, a)
            self._stream_delta(s, committed[:ncommit],
                               s.state == STATE_DONE,
                               accepted=accepted_sent)
            self.kv.truncate_sequence(s.seq_id, s.context_len())
            was_collapsed = s.spec.collapsed
            s.spec.update(len(d), a)
            # the +1 bonus is a *speculative* gain only when the step
            # drafted; an empty-draft step is a plain decode token
            bonus = (ncommit - accepted_sent) if d else 0
            step_drafted += len(d)
            step_accepted += a
            st.drafted += len(d)
            st.accepted += a
            st.rejected += len(d) - a
            st.bonus += bonus
            if d:
                st.spec_steps += 1
                _spec.g_serving_spec_draft_tokens.put(len(d))
                if a:
                    _spec.g_serving_spec_accepted_tokens.put(a)
                if len(d) - a:
                    _spec.g_serving_spec_rejected_tokens.put(len(d) - a)
            if s.spec.collapsed and not was_collapsed:
                st.collapsed_seqs += 1
            if bonus:
                _spec.g_serving_spec_bonus_tokens.put(bonus)
        _spec.note_step(step_drafted, step_accepted)

    # ----------------------------------------------------------- completion
    def _append_token(self, seq: Sequence, tok: int,
                      stream: bool = True) -> None:
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
        if stream:
            self._stream_delta(seq, [tok], finished)
        if finished:
            seq.finish_reason = "stop_token" if stopped else "length"
            seq.state = STATE_DONE

    def _stream_delta(self, seq: Sequence, toks: List[int],
                      done: bool, accepted: int = 0) -> None:
        if not seq.stream_id:
            return
        from brpc_tpu_torch.rpc.stream import stream_write

        delta = serving_pb2.TokenDelta(seq_id=seq.seq_id, tokens=toks,
                                       step=len(seq.out_tokens), done=done,
                                       accepted=accepted)
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

    # ------------------------------------------------------------- handoff
    def _migrate_handoff(self) -> None:
        """Ship every live chain to the decode engine (on the engine
        thread between phases, so each sequence is quiescent). A success
        completes the request with the handoff; a failure stays in the
        running set and decodes here."""
        moved = []
        for seq in list(self._running):
            if seq.state == STATE_DONE or seq.adopted:
                continue
            dest = self.migrator.migrate(seq, self.kv)
            if dest is not None:
                moved.append((seq, dest))
        if not moved:
            return
        gone = {id(s) for s, _ in moved}
        self._running = [s for s in self._running if id(s) not in gone]
        for seq, dest in moved:
            self._finish_handoff(seq, dest)

    def _finish_handoff(self, seq: Sequence, dest_seq_id: int) -> None:
        """Complete the stage-1 request: ``finish_reason`` "handoff", the
        adopted sequence's id and ``handoff_shard`` tell the client where
        its generation goes on. The migrator released the chain on the
        destination's ACK: nothing to free here."""
        seq.state = STATE_DONE
        seq.finish_reason = "handoff"
        self._stream_delta(seq, [], True)  # the stage-1 stream is complete
        done, seq.done = seq.done, None
        if done is None:
            return
        shard = self.migrator.dest_shard
        try:
            if seq.cntl is not None:
                done(serving_pb2.GenerateResponse(
                    tokens=seq.out_tokens, seq_id=dest_seq_id,
                    prompt_len=len(seq.prompt), steps=len(seq.out_tokens),
                    ttft_us=self._ttft_us(seq), finish_reason="handoff",
                    handoff_shard=shard))
            else:
                done(GenerateResult(
                    tokens=list(seq.out_tokens), seq_id=dest_seq_id,
                    prompt_len=len(seq.prompt), steps=len(seq.out_tokens),
                    ttft_us=self._ttft_us(seq), finish_reason="handoff",
                    handoff_shard=shard))
        except Exception:  # a caller's callback must not kill the engine
            _log.exception("handoff completion of sequence %d raised",
                           seq.seq_id)

    def _drain_migrate(self) -> None:
        """stop()'s recovery: move live chains to the survivor. The
        request still fails retriably (its engine is going away), but its
        retry attaches to the migrated sequence on the destination with
        no prefill."""
        with self._cv:
            live = [s for s in self._running
                    if s.state != STATE_DONE and not s.adopted]
        for seq in live:
            dest = self.migrator.migrate(seq, self.kv, recovery=True)
            if dest is None:
                continue  # the abort in stop() cleans it up
            with self._cv:
                if seq in self._running:
                    self._running.remove(seq)
            self._finish(seq, errors.EFAILEDSOCKET,
                         "shard draining: sequence migrated to survivor "
                         "(retriable)")

    def _finish(self, seq: Sequence, code: int, reason: str) -> None:
        if code == 0 and self.prefix is not None and seq.out_tokens:
            # commit the fully written blocks into the radix tree
            # (insert-or-share) before the table drops; the last sampled
            # token's K/V was never written, hence the -1 valid length
            self.prefix.commit(
                seq.seq_id, list(seq.prompt) + seq.out_tokens,
                len(seq.prompt) + len(seq.out_tokens) - 1)
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
        with self._cv:
            if seq.adopted and seq.done is None and not seq._attached:
                # migrated in with no client yet: park the result for the
                # resume or retry attach (the blocks are freed above)
                seq._deferred = (code, reason)
                return
            self._adopted.pop(seq.seq_id, None)
        done, seq.done = seq.done, None
        if done is None:
            return
        self._complete(seq, done, code, reason)

    @staticmethod
    def _ttft_us(seq: Sequence) -> int:
        if not seq.t_first_token:
            return 0
        return int((seq.t_first_token - seq.t_submit) * 1e6)

    def _complete(self, seq: Sequence, done, code: int,
                  reason: str) -> None:
        """Call ``done`` for a finished sequence: the RPC form (the
        ``GenerateResponse``, or None after ``cntl.set_failed``) when a
        controller came with it, else a :class:`GenerateResult`. A resume
        attach already has the prefill engine's tokens from the handoff
        reply and gets only the suffix decoded here; a recovery attach
        replaces the lost reply whole."""
        toks = (seq.out_tokens[seq.handoff_base:] if seq.resume_attach
                else seq.out_tokens)
        try:
            if seq.cntl is not None:
                if code != 0:
                    seq.cntl.set_failed(code, reason)
                    done(None)
                else:
                    done(serving_pb2.GenerateResponse(
                        tokens=toks, seq_id=seq.seq_id,
                        prompt_len=len(seq.prompt), steps=len(toks),
                        ttft_us=self._ttft_us(seq),
                        finish_reason=seq.finish_reason or "length"))
            else:
                done(GenerateResult(
                    tokens=list(toks), seq_id=seq.seq_id,
                    prompt_len=len(seq.prompt), steps=len(toks),
                    ttft_us=self._ttft_us(seq),
                    finish_reason=seq.finish_reason or
                    ("length" if code == 0 else "error"),
                    error_code=code, error_text=reason))
        except Exception:  # a caller's callback must not kill the engine
            _log.exception("completion of sequence %d raised", seq.seq_id)

    def _abort_all_locked_out(self, code: int, reason: str) -> None:
        """Fail every queued, running and pending-adoption sequence with
        ``code`` (takes the lock itself; the completions run outside
        it)."""
        with self._cv:
            pending = (list(self._waiting) + list(self._running)
                       + list(self._adopted_pending))
            self._waiting.clear()
            self._running = []
            self._adopted_pending.clear()
            if self.qos is not None:
                for seq in list(self.qos.iter_waiting()):
                    self.qos.drop(seq)
                    pending.append(seq)
        for seq in pending:
            self._finish(seq, code, reason)

    # ------------------------------------------------------------ visibility
    def snapshot(self) -> Dict[str, object]:
        def pct(samples, q):
            return float(np.percentile(samples, q)) if samples else 0.0

        occ = (self._occupancy_sum / self.steps) if self.steps else 0.0
        migration = None
        if self.migrator is not None or self._migration_rx is not None:
            migration = {"parked": len(self._adopted)}
            if self.migrator is not None:
                migration["out"] = self.migrator.snapshot()
            if self._migration_rx is not None:
                migration["in"] = self._migration_rx.snapshot()
        return {
            "role": self.config.role,
            "migration": migration,
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
            "shard_steps": {
                sh: {"steps": int(st[0]),
                     "avg_us": round(st[1] / st[0], 1) if st[0] else 0.0,
                     "last_us": round(st[2], 1),
                     "seq_steps": int(st[3])}
                for sh, st in sorted(self._shard_step.items())
            },
            "kv": self.kv.snapshot(),
            "prefix": (self.prefix.snapshot()
                       if self.prefix is not None else None),
            "spec": (dict(self.spec_stats.snapshot(),
                          k_max=self.config.spec_k)
                     if self.spec_stats is not None else None),
            "qos": (self.qos.snapshot()
                    if self.qos is not None else None),
        }

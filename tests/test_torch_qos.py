"""Multi-tenant QoS on the port (brpc_tpu_torch/serving/qos.py and the
engine's QoS branch), held against the JAX package's
(brpc_tpu/serving/qos.py) on the CPU.

The cases of the JAX package's ``tests/test_serving_qos.py``:

- the TenantScheduler as a pure ledger, each case driven through the
  port's and the JAX package's scheduler on the same operations (a
  ``Twin``): every operation returns the same thing on both and the
  snapshots after it are equal. Both run on one stepped clock (each
  module's ``time`` is a fake whose ``monotonic`` the test advances), so
  the waits in the snapshots are equal too;
- the QosLimiter's gradient on both packages, ceiling for ceiling;
- the governor's tick against a stub engine of each package: the same
  requests shed, the protected one kept, every block back in the pool;
- the ``serving.qos.burst`` fault: best-effort sheds, prod never does,
  and prod's p99 under the burst stays within the reference's bound
  (``burst_p99 <= unloaded * 4 + 0.05``) on a stepped clock;
- identity on the wire: Controller ``tenant_id`` / ``priority`` through
  the port's RequestMeta to the engine's lanes, the committed overload
  corpus read by the port's replayer with the identities
  ``tools/rpc_replay`` reads, and ``rpc_replay``'s overrides restamping
  every record against the port's server;
- the vars and gauges, the engine snapshot's ``qos`` and the
  ``/serving`` page's qos and tenant lines (their fields the JAX
  page's), the ``serving_qos_starvation`` watch rule and its reloadable
  bound;
- the overload corpus at its recorded rate through ``tools/rpc_replay``
  against the port's server at the corpus widths: nothing shed, each
  lane billed, the tokens of the same requests on a ``qos=None`` engine;
- the closed loop: the reference's acceptance settings, replayed on a
  stepped clock through an engine whose step loop the test runs, so the
  verdict (prod's p99 at 2x within 1.5x of its 0.25x baseline with QoS,
  past it without) cannot depend on the machine's load. The wall-clock
  form runs on the card (``chip_smoke.py`` phase 4j).
"""

import collections
import json
import os
import threading
import time
import types

import numpy as np
import pytest

from brpc_tpu.serving import qos as jax_qos
from brpc_tpu_torch import fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.bench import qos_replay
from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller, Server,
                                Stub, errors)
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.serving import engine as port_engine_mod
from brpc_tpu_torch.serving import qos as port_qos
from brpc_tpu_torch.serving.qos import (DEFAULT_TENANT, QosConfig,
                                        QosLimiter, TenantScheduler)
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.trace import span as _span
from tools import record_serving_corpus_overload as recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_OVERLOAD = os.path.join(REPO, "tests", "data",
                               "serving_corpus_overload")


# ---------------------------------------------------------- stepped clock
class Clock:
    """The time every patched module reads; only the test moves it."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def perf_counter_ns(self):
        return int(self.t * 1e9)

    def sleep(self, s):
        self.t += s

    def module(self):
        return types.SimpleNamespace(monotonic=self.monotonic,
                                     perf_counter_ns=self.perf_counter_ns,
                                     sleep=self.sleep)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(port_qos, "time", c.module())
    monkeypatch.setattr(jax_qos, "time", c.module())
    return c


def _cost(s):
    return s.cost


class Twin:
    """A port and a JAX TenantScheduler driven by the same operations:
    each returns what the other does, and their snapshots agree after
    every operation."""

    def __init__(self, clock, engine_pair=(None, None), **cfg):
        self.clock = clock
        self.port = TenantScheduler(QosConfig(**cfg), engine=engine_pair[0])
        self.jax = jax_qos.TenantScheduler(jax_qos.QosConfig(**cfg),
                                           engine=engine_pair[1])
        self._pair = {}
        self._n = 0

    def seq(self, tenant, priority=0, cost=16, t_submit=None):
        self._n += 1
        fields = dict(tenant_id=tenant, priority=priority, cntl=None,
                      t_submit=(self.clock.t if t_submit is None
                                else t_submit), cost=cost, uid=self._n)
        p = types.SimpleNamespace(**fields)
        self._pair[self._n] = types.SimpleNamespace(**fields)
        return p

    def _j(self, s):
        return self._pair[s.uid]

    def check(self):
        assert self.port.snapshot() == self.jax.snapshot()

    def enqueue(self, s):
        code = self.port.enqueue(s)
        assert code == self.jax.enqueue(self._j(s))
        self.check()
        return code

    def peek(self, budget):
        p, j = self.port.peek(budget, _cost), self.jax.peek(budget, _cost)
        assert (None if p is None else p.uid) == (None if j is None
                                                  else j.uid)
        return p

    def commit(self, s, cost):
        self.port.commit(s, cost)
        self.jax.commit(self._j(s), cost)
        self.check()

    def drop(self, s):
        self.port.drop(s)
        self.jax.drop(self._j(s))
        self.check()

    def admission_check(self, *a, **k):
        code = self.port.admission_check(*a, **k)
        assert code == self.jax.admission_check(*a, **k)
        self.check()
        return code

    def shed_victims(self, n):
        p = self.port.shed_victims(n)
        assert [s.uid for s in p] == [s.uid for s in
                                      self.jax.shed_victims(n)]
        self.check()
        return p

    def tenant_depth(self, t):
        d = self.port.tenant_depth(t)
        assert d == self.jax.tenant_depth(t)
        return d

    def iter_waiting(self):
        p = list(self.port.iter_waiting())
        assert [s.uid for s in p] == [s.uid for s in
                                      self.jax.iter_waiting()]
        return p

    def snapshot(self):
        self.check()
        return self.port.snapshot()


# ------------------------------------------------- fair share (pure ledger)
class TestFairShare:
    def _run_steps(self, sched, lanes, steps, budget):
        """Admission rounds with every listed lane kept saturated."""
        for _ in range(steps):
            for tenant, prio in lanes:
                while sched.tenant_depth(tenant) < 4:
                    assert sched.enqueue(sched.seq(tenant, prio)) == 0
            b = budget
            while True:
                head = sched.peek(b)
                if head is None:
                    break
                sched.commit(head, head.cost)
                b -= head.cost
            sched.clock.t += 0.01

    def test_equal_weights_split_tokens_evenly(self, clock):
        sched = Twin(clock, tenants={"a": 1.0, "b": 1.0})
        self._run_steps(sched, [("a", 0), ("b", 0)], steps=100, budget=32)
        snap = sched.snapshot()["tenants"]
        total = snap["a"]["admitted_tokens"] + snap["b"]["admitted_tokens"]
        assert total == 100 * 32
        assert abs(snap["a"]["token_share"] - 0.5) <= 0.05

    def test_weighted_share_converges_to_weight_ratio(self, clock):
        sched = Twin(clock, tenants={"heavy": 3.0, "light": 1.0})
        self._run_steps(sched, [("heavy", 0), ("light", 0)],
                        steps=100, budget=64)
        snap = sched.snapshot()["tenants"]
        assert abs(snap["heavy"]["token_share"] - 0.75) <= 0.05

    def test_idle_share_redistributes_and_is_reclaimed_within_one_step(
            self, clock):
        sched = Twin(clock, tenants={"a": 1.0, "b": 1.0})
        self._run_steps(sched, [("a", 0), ("b", 0)], steps=10, budget=32)
        for s in sched.iter_waiting():
            if s.tenant_id == "b":
                sched.drop(s)
        before = sched.snapshot()["tenants"]["a"]["admitted_tokens"]
        self._run_steps(sched, [("a", 0)], steps=10, budget=32)
        after = sched.snapshot()["tenants"]["a"]["admitted_tokens"]
        assert after - before == 10 * 32  # the idle share redistributed
        assert sched.enqueue(sched.seq("b")) == 0
        admitted, b = [], 32
        while True:
            head = sched.peek(b)
            if head is None:
                break
            sched.commit(head, head.cost)
            b -= head.cost
            admitted.append(head.tenant_id)
        assert "b" in admitted

    def test_queue_cap_sheds_retriable_per_lane(self, clock):
        sched = Twin(clock, queue_cap=2)
        assert sched.enqueue(sched.seq("bulk")) == 0
        assert sched.enqueue(sched.seq("bulk")) == 0
        assert sched.enqueue(sched.seq("bulk")) == errors.EOVERCROWDED
        assert sched.snapshot()["tenants"]["bulk"]["shed"] == 1
        assert sched.enqueue(sched.seq("other")) == 0  # the cap is per lane

    def test_deadline_rechecked_at_admission_boundary(self, clock):
        sched = Twin(clock)
        dead = clock.t - 0.1
        assert sched.admission_check("t", 0, deadline_mono=dead) \
            == errors.ERPCTIMEDOUT

    def test_protected_carveout_above_ceiling(self, clock):
        sched = Twin(clock, ceiling_start=4.0, ceiling_min=2.0,
                     protected_priority=1)
        for _ in range(4):
            assert sched.enqueue(sched.seq("bulk", 0)) == 0
        assert sched.admission_check("bulk", 0) == errors.EOVERCROWDED
        assert sched.admission_check("prod", 1) == 0
        for _ in range(4):
            assert sched.enqueue(sched.seq("prod", 1)) == 0
        assert sched.admission_check("prod", 1) == errors.EOVERCROWDED

    def test_shed_victims_best_effort_oldest_first(self, clock):
        sched = Twin(clock, protected_priority=1)
        now = clock.t
        old = sched.seq("bulk", 0, t_submit=now - 2.0)
        mid = sched.seq("bulk", 0, t_submit=now - 1.0)
        prod = sched.seq("prod", 1, t_submit=now - 3.0)
        for s in (prod, mid, old):
            assert sched.enqueue(s) == 0
        assert sched.shed_victims(2) == [old, mid]  # age order, p0 first
        assert sched.shed_victims(5) == []
        assert sched.tenant_depth("prod") == 1


# -------------------------------------------------------- gradient limiter
class TestLimiter:
    @staticmethod
    def _pair(**cfg):
        return QosLimiter(QosConfig(**cfg)), \
            jax_qos.QosLimiter(jax_qos.QosConfig(**cfg))

    def test_rising_wait_shrinks_multiplicatively(self):
        lim, ref = self._pair(ceiling_start=8.0, ceiling_min=2.0)
        assert lim.observe(1000.0, inflight=0) == pytest.approx(9.0) \
            == ref.observe(1000.0, inflight=0)
        assert lim.observe(9000.0, inflight=0) == pytest.approx(5.5) \
            == ref.observe(9000.0, inflight=0)
        assert lim.snapshot() == ref.snapshot()

    def test_floor_and_recovery_gated_by_inflight(self):
        lim, ref = self._pair(ceiling_start=4.0, ceiling_min=2.0,
                              ceiling_max=6.0)
        for _ in range(50):
            w = lim._avg_wait_us * 10 + 1000.0
            assert lim.observe(w, inflight=0) == ref.observe(w, inflight=0)
        assert lim.ceiling == pytest.approx(2.0)  # clamped at the floor
        assert lim.observe(0.0, inflight=10) == pytest.approx(2.0) \
            == ref.observe(0.0, inflight=10)
        for _ in range(50):
            assert lim.observe(0.0, inflight=0) == ref.observe(0.0,
                                                               inflight=0)
        assert lim.ceiling == 6.0  # additive recovery up to the max
        assert lim.snapshot() == ref.snapshot()


# ------------------------------------------------ governor (stub engines)
class _StubModel:
    """A stand-in model: the engine's scheduling does not depend on it,
    so admission and shedding run with no device program."""

    def __init__(self, step_s=0.0):
        self.config = types.SimpleNamespace(max_context=4096)
        self.step_s = step_s
        self.prefills = 0

    def synth_prompt(self, n):
        return np.arange(1, n + 1, dtype=np.int32)

    def prefill(self, prompt, table):
        self.prefills += 1
        if self.step_s:
            time.sleep(self.step_s)
        return 1

    def decode_step(self, tokens, positions, tables):
        if self.step_s:
            time.sleep(self.step_s)
        return np.full(len(tables), 2, dtype=np.int32)


class _Cntl:
    """Just enough controller for the engine's getattr probes."""

    def __init__(self, deadline_mono=0.0):
        self.deadline_mono = deadline_mono
        self._srv_socket = types.SimpleNamespace(failed=False)
        self.code = 0
        self.text = ""

    def set_failed(self, code, text):
        self.code, self.text = code, text


def _small_kv(num_blocks=32, block_size=8, watermark=0.9):
    kv = PagedKVCache(KVCacheConfig(block_size=block_size,
                                    num_blocks=num_blocks,
                                    watermark=watermark), 1, 8,
                      device="cpu")
    kv._check = True
    return kv


def _stub_engine(step_s=0.0, start=True, model=None, **cfg):
    kv = _small_kv(num_blocks=cfg.pop("num_blocks", 32))
    cfg.setdefault("idle_wait_s", 0.005)
    eng = ServingEngine(model or _StubModel(step_s), kv, EngineConfig(**cfg))
    return eng.start() if start else eng


def _governor_case(side):
    """The reference's governor case on one package's engine; returns the
    ceiling and which submits were shed."""
    if side == "port":
        eng = _stub_engine(start=False, qos=QosConfig(
            ceiling_start=8.0, ceiling_min=2.0, queue_cap=32))
        cntl_cls = _Cntl
    else:
        from test_serving import _Cntl as JaxCntl
        from test_serving import _stub_engine as jax_stub_engine

        eng = jax_stub_engine(start=False, qos=jax_qos.QosConfig(
            ceiling_start=8.0, ceiling_min=2.0, queue_cap=32))
        cntl_cls = JaxCntl
    eng.running = True
    subs = []

    def submit(tenant, prio):
        cntl = cntl_cls()
        ev = threading.Event()
        code, seq = eng.submit(eng.model.synth_prompt(4), 2, cntl=cntl,
                               tenant_id=tenant, priority=prio,
                               done=lambda r, e=ev: e.set())
        assert code == 0
        subs.append((cntl, ev, seq))
        return seq

    try:
        submit("prod", 1)
        bulk = [submit("bulk", 0) for _ in range(5)]
        gov = eng._qos_governor
        assert gov is not None
        assert eng.queue_depth == 6
        gov.tick(sample_us=1000.0)  # warms the floor: no shed
        assert eng.queue_depth == 6
        gov.tick(sample_us=30000.0)  # 30x the floor: shrink + shed
        ceiling = eng.qos.limiter.ceiling
        assert ceiling < 6.0
        shed = [s for (c, e, s) in subs if c.code == errors.EOVERCROWDED]
        assert len(shed) == 6 - int(ceiling)
        assert all(s.tenant_id == "bulk" for s in shed)
        assert shed[0] is bulk[0]  # the oldest best-effort went first
        assert subs[0][0].code == 0  # the protected request survived
        assert gov.sheds == len(shed)
        for (c, e, s) in subs:
            if c.code == errors.EOVERCROWDED:
                assert e.wait(5.0)
        shed_idx = [i for i, (c, _e, _s) in enumerate(subs)
                    if c.code == errors.EOVERCROWDED]
    finally:
        eng.running = False
        eng._abort_all_locked_out(errors.ELOGOFF, "teardown")
    eng.kv.assert_idle("governor teardown")  # zero leaked KV blocks
    return ceiling, shed_idx


class TestGovernor:
    def test_tick_sheds_queued_best_effort_down_to_ceiling(self):
        port = _governor_case("port")
        assert port == _governor_case("jax")

    def test_governor_rides_the_sampler_hook_lifecycle(self):
        from brpc_tpu_torch.metrics.series import global_series

        eng = _stub_engine(qos=QosConfig())
        try:
            assert eng._qos_governor in global_series().post_tick_hooks
        finally:
            eng.stop()
        assert eng._qos_governor not in global_series().post_tick_hooks
        eng.kv.assert_idle("hook lifecycle teardown")


# ------------------------------------------------------------------- chaos
@pytest.fixture()
def fault_enabled():
    _flags.set_flag("fault_injection_enabled", True)
    yield
    fault.disarm_all()
    _flags.set_flag("fault_injection_enabled", False)


BURST_STEP_S = 0.002  # the reference's burst stub: 2 ms a prefill or step


class _BurstModel(_StubModel):
    """The reference burst case's stub model (``step_s=0.002``) on the
    stepped clock: a prefill or a decode step moves the clock 2 ms."""

    def __init__(self, clock):
        super().__init__()
        self.clock = clock

    def prefill(self, prompt, table):
        self.prefills += 1
        self.clock.t += BURST_STEP_S
        return 1

    def decode_step(self, tokens, positions, tables):
        self.clock.t += BURST_STEP_S
        return np.full(len(tables), 2, dtype=np.int32)


def _step_until(eng, clock, finished, what):
    """Run the engine's step loop (admit, then step) on the stepped clock
    until ``finished()``; an idle engine before that is a failure."""
    for _ in range(100000):
        if finished():
            return
        with eng._cv:
            admitted = eng._admit_locked()
        if not admitted and not eng._running:
            raise AssertionError(f"the engine went idle before {what}")
        with eng.pool_gate:
            eng._step(admitted)
    raise AssertionError(f"{what} never finished")


class TestQosChaos:
    def test_burst_fault_sheds_bulk_protects_prod_and_recovers(
            self, fault_enabled, monkeypatch):
        """Each real bulk submit fans out 7 synthetic clones against a
        lane capped at 4: bulk sheds EOVERCROWDED, prod never does, and
        prod's p99 under the armed burst stays within the reference's
        bound, ``burst_p99 <= unloaded * 4 + 0.05``, on the stepped clock
        (this loop is the engine's step loop; a step moves the clock as
        the reference's 2 ms stub sleeps); disarmed, the lane drains and
        a plain bulk request completes."""
        clock = Clock()
        monkeypatch.setattr(port_qos, "time", clock.module())
        monkeypatch.setattr(port_engine_mod, "time", clock.module())
        qos = QosConfig(tenants={"prod": 8.0, "bulk": 1.0}, queue_cap=4,
                        protected_priority=1)
        eng = _stub_engine(start=False, model=_BurstModel(clock),
                           max_batch=4, token_budget=64, num_blocks=64,
                           qos=qos)
        eng.running = True
        try:
            def prod_once():
                cntl = _Cntl()
                ev = threading.Event()
                t0 = clock.t
                code, _ = eng.submit(eng.model.synth_prompt(8), 4,
                                     cntl=cntl, tenant_id="prod",
                                     priority=1,
                                     done=lambda r, e=ev: e.set())
                assert code == 0
                _step_until(eng, clock, ev.is_set, "a prod request")
                assert cntl.code == 0
                return clock.t - t0

            unloaded = sorted(prod_once() for _ in range(8))[-1]
            assert unloaded > 0

            # each real bulk submit fans out 7 synthetic clones: 96
            # offered against a lane capped at 4
            fault.arm("serving.qos.burst", mode="always", factor=8,
                      match={"tenant": "bulk"})
            codes = [eng.submit(eng.model.synth_prompt(8), 4,
                                tenant_id="bulk", priority=0,
                                done=lambda r: None)[0]
                     for _ in range(12)]
            burst_p99 = sorted(prod_once() for _ in range(8))[-1]
            snap = eng.qos.snapshot()["tenants"]
            assert snap["bulk"]["shed"] > 0  # the flood shed EOVERCROWDED
            assert snap["prod"]["shed"] == 0  # the protected lane never did
            assert set(codes) <= {0, errors.EOVERCROWDED}
            # protected p99 holds within bound under the armed burst
            assert burst_p99 <= unloaded * 4 + 0.05, (burst_p99, unloaded)

            fault.disarm_all()
            # recovery: the lane drains and a plain bulk request completes
            _step_until(eng, clock,
                        lambda: not (eng.queue_depth or eng.running_count),
                        "the burst's drain")
            cntl = _Cntl()
            ev = threading.Event()
            code, _ = eng.submit(eng.model.synth_prompt(8), 4, cntl=cntl,
                                 tenant_id="bulk", priority=0,
                                 done=lambda r, e=ev: e.set())
            assert code == 0
            _step_until(eng, clock, ev.is_set, "the bulk request")
            assert cntl.code == 0
        finally:
            eng.running = False
            eng._abort_all_locked_out(errors.ELOGOFF, "burst case done")
        eng.kv.assert_idle("post burst fault")  # zero leaked KV blocks


# ----------------------------------------------------- identity on the wire
def _serving_server(eng):
    return Server().add_service(LlmServingService(eng)).start("127.0.0.1:0")


class TestWireIdentity:
    def test_tenant_and_priority_ride_request_meta(self):
        eng = _stub_engine(qos=QosConfig(tenants={"prod": 2.0}))
        server = _serving_server(eng)
        try:
            ch = Channel(ChannelOptions(protocol="trpc_std",
                                        timeout_ms=30000))
            ch.init(str(server.listen_endpoint()))
            stub = Stub(ch, serving_pb2.DESCRIPTOR
                        .services_by_name["LlmService"])
            cntl = Controller()
            cntl.tenant_id = "prod"
            cntl.priority = 1
            resp = stub.Generate(serving_pb2.GenerateRequest(
                prompt_len=8, max_new_tokens=2), controller=cntl)
            assert not cntl.failed() and len(resp.tokens) == 2
            resp = stub.Generate(serving_pb2.GenerateRequest(
                prompt_len=8, max_new_tokens=2), controller=Controller())
            assert len(resp.tokens) == 2
            snap = eng.qos.snapshot()["tenants"]
            assert snap["prod"]["admitted"] == 1
            assert snap[DEFAULT_TENANT]["admitted"] == 1
        finally:
            server.stop()
            server.join(timeout=2)
            eng.stop()
        eng.kv.assert_idle("wire identity teardown")

    def test_overload_corpus_records_identity(self):
        """The port's replayer reads the committed corpus's identities as
        ``tools/rpc_replay`` does, in the same arrival order and
        offsets."""
        from tools.rpc_replay import load_items

        items, skipped = load_items(CORPUS_OVERLOAD)
        recs = qos_replay.load_corpus(CORPUS_OVERLOAD)
        assert skipped == 0 and len(recs) == len(items) \
            == len(recorder.SCHEDULE)
        assert [(r.tenant, r.priority, r.offset_s) for r in recs] == \
            [(i.tenant, i.priority, i.offset_s) for i in items]
        got = collections.Counter((r.tenant, r.priority) for r in recs)
        want = collections.Counter(
            (t, p) for _, t, p, _, _ in recorder.SCHEDULE)
        assert got == want
        assert sorted((r.request.prompt_len, r.request.max_new_tokens)
                      for r in recs) == sorted(
            (pl, mn) for _, _, _, pl, mn in recorder.SCHEDULE)

    def test_replay_overrides_restamp_every_record(self, tmp_path):
        from tools import rpc_replay

        eng = _stub_engine(max_batch=8, token_budget=512, num_blocks=256,
                           qos=QosConfig(queue_cap=64))
        server = _serving_server(eng)
        try:
            out = tmp_path / "replay.json"
            rc = rpc_replay.main([
                "--dump", CORPUS_OVERLOAD,
                "--server", str(server.listen_endpoint()),
                "--rate-mult", "20", "--timeout-ms", "30000",
                "--report-interval", "0",
                "--tenant-override", "probe", "--priority-override", "1",
                "--json-out", str(out)])
            assert rc == 0
            data = json.loads(out.read_text())
            assert list(data["tenants"]) == ["probe"]
            assert data["tenants"]["probe"]["ok"] == data["sent"]
            snap = eng.qos.snapshot()["tenants"]
            assert snap["probe"]["admitted"] == data["sent"]
        finally:
            server.stop()
            server.join(timeout=2)
            eng.stop()
        eng.kv.assert_idle("override replay teardown")


# ----------------------------------------------------------- observability
class TestObservability:
    def test_snapshot_and_builtin_page_render_qos(self):
        """The reference's builtin-page case on the port's ``/serving``:
        the qos line and a tenant lane in the text view, the section in
        the JSON view; the qos and tenant lines carry the JAX page's
        fields for the same submit on a JAX stub engine."""
        from brpc_tpu.builtin.services import serving_service as jax_page
        from brpc_tpu_torch.builtin.services import serving_service
        from test_serving import _Cntl as JaxCntl
        from test_serving import _stub_engine as jax_stub_engine

        def run(eng, cntl, page):
            ev = threading.Event()
            code, _ = eng.submit(eng.model.synth_prompt(8), 2, cntl=cntl,
                                 tenant_id="prod", priority=1,
                                 done=lambda r, e=ev: e.set())
            assert code == 0 and ev.wait(30)
            _st, _ct, text = page(None, types.SimpleNamespace(
                query={}, path="/serving"))
            _st, ct, body = page(None, types.SimpleNamespace(
                query={"format": "json"}, path="/serving"))
            assert "json" in ct
            return eng.snapshot()["qos"], text, json.loads(body)["engines"]

        eng = _stub_engine(qos=QosConfig(tenants={"prod": 2.0}))
        try:
            snap, body, snaps = run(eng, _Cntl(), serving_service)
        finally:
            eng.stop()
        eng.kv.assert_idle("qos page teardown")
        assert snap["tenants"]["prod"]["admitted"] >= 1
        assert {"ceiling", "min_wait_us", "avg_wait_us", "updates"} \
            <= set(snap["limiter"])
        assert "qos: ceiling=" in body
        assert "[tenant prod]" in body
        assert any(s.get("qos") for s in snaps)
        jeng = jax_stub_engine(qos=jax_qos.QosConfig(tenants={"prod": 2.0}))
        try:
            _jsnap, jbody, _ = run(jeng, JaxCntl(), jax_page)
        finally:
            jeng.stop()

        def keys(page, start):
            return [[w.split("=")[0] for w in line.split() if "=" in w]
                    for line in page.splitlines()
                    if line.strip().startswith(start)]

        for start in ("qos:", "[tenant prod]"):
            assert keys(body, start) == keys(jbody, start)[-1:]

    def test_snapshot_renders_qos(self):
        """The engine snapshot's ``qos`` section survives a JSON round
        trip, and a QoS-less engine has none."""
        eng = _stub_engine(qos=QosConfig(tenants={"prod": 2.0}))
        try:
            cntl = _Cntl()
            ev = threading.Event()
            code, _ = eng.submit(eng.model.synth_prompt(8), 2, cntl=cntl,
                                 tenant_id="prod", priority=1,
                                 done=lambda r, e=ev: e.set())
            assert code == 0 and ev.wait(30)
            snap = eng.snapshot()["qos"]
            assert snap["tenants"]["prod"]["admitted"] >= 1
            assert {"ceiling", "min_wait_us", "avg_wait_us", "updates"} \
                <= set(snap["limiter"])
            assert json.loads(json.dumps(snap)) == snap
        finally:
            eng.stop()
        eng.kv.assert_idle("qos snapshot teardown")
        plain = _stub_engine()
        try:
            assert plain.snapshot()["qos"] is None
        finally:
            plain.stop()

    def test_qos_vars_and_gauges_track_live_engines(self):
        qos = QosConfig(tenants={"prod": 2.0}, ceiling_start=6.0,
                        ceiling_min=2.0, ceiling_max=6.0)
        gate = threading.Event()

        class _Gated(_StubModel):
            def prefill(self, prompt, table):
                gate.wait(30)  # hold the queue still while it is read
                return 1

        eng = _stub_engine(max_batch=1, qos=qos, model=_Gated())
        tvars = port_qos._vars_for_tenant("prod")
        a0 = tvars["admitted"].get_value()
        s0 = tvars["shed"].get_value()
        evs = []
        try:
            sheds = 0
            for _ in range(10):
                ev = threading.Event()
                code, _ = eng.submit(eng.model.synth_prompt(4), 4,
                                     tenant_id="prod", priority=0,
                                     done=lambda r, e=ev: e.set())
                if code == errors.EOVERCROWDED:
                    sheds += 1
                else:
                    evs.append(ev)
            assert sheds >= 4  # 10 offered against a ceiling of 6
            with eng._cv:  # atomic against the step loop
                assert tvars["depth"].get_value() \
                    == eng.qos.tenant_depth("prod")
                assert port_qos.g_serving_qos_occupancy.get_value() > 0.0
                assert port_qos.g_serving_qos_max_wait_ms.get_value() >= 0.0
            gate.set()
            for ev in evs:
                assert ev.wait(30)
            assert tvars["admitted"].get_value() - a0 == len(evs)
            assert tvars["shed"].get_value() - s0 == sheds
        finally:
            gate.set()
            eng.stop()
        eng.kv.assert_idle("qos vars teardown")


def test_qos_starvation_rule_installed_with_reloadable_bound():
    from brpc_tpu_torch.metrics.watch import (KIND_THRESHOLD, global_watch,
                                              install_default_rules)

    install_default_rules()
    rule = {r.name: r
            for r in global_watch().rules()}["serving_qos_starvation"]
    assert rule.var == "g_serving_qos_max_wait_ms"
    assert rule.kind == KIND_THRESHOLD and rule.op == ">"
    assert rule.value_fn is not None
    assert rule.value_fn() == pytest.approx(
        _flags.get("serving_qos_starvation_ms"))
    _flags.set_flag("serving_qos_starvation_ms", "500")
    try:
        assert rule.value_fn() == pytest.approx(500.0)
    finally:
        _flags.set_flag("serving_qos_starvation_ms", "2000")


# ------------------------------------- the corpus at its recorded rate
def _corpus_engine(qos):
    """The overload recorder's engine (tools/record_serving_corpus_overload
    .build_engine) on the port, on the CPU."""
    cfg = ModelConfig(vocab=256, d_model=32, n_heads=2, n_layers=2)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=256),
                      cfg.n_layers, cfg.kv_dim, device="cpu")
    kv._check = True
    return ServingEngine(TinyTransformer(cfg, kv), kv, EngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.005,
        qos=qos)).start()


def test_overload_corpus_replays_clean_through_qos_at_recorded_rate():
    """The committed overload corpus at its RECORDED rate, through
    ``tools/rpc_replay``, against the port's server at the corpus widths
    with QoS armed: inside capacity nothing sheds, both tenants are
    billed on their lanes, every server span carries the engine's
    phases; and the port's replayer, the same corpus against a
    ``qos=None`` engine and the QoS engine, gets the same tokens for
    every request."""
    from tools import rpc_replay

    saved = {k: _flags.get(k) for k in
             ("rpcz_sample_ratio", "collector_max_samples_per_second")}
    _flags.set_flag("rpcz_sample_ratio", "1.0")
    _flags.set_flag("collector_max_samples_per_second", "0")
    from brpc_tpu_torch.metrics import collector

    collector.global_collector()._deny_until = 0.0
    # the ceiling's floor above the corpus's worst case: this gates the
    # identity restamp at the recorded rate, not the closed loop
    engine = _corpus_engine(QosConfig(tenants={"prod": 4.0, "batch": 1.0},
                                      queue_cap=64, ceiling_min=48.0))
    plain = _corpus_engine(None)
    try:
        _span.reset_for_test()
        server = _serving_server(engine)
        try:
            rc = rpc_replay.main([
                "--dump", CORPUS_OVERLOAD,
                "--server", str(server.listen_endpoint()),
                "--rate-mult", "1", "--timeout-ms", "30000",
                "--report-interval", "0"])
            assert rc == 0  # inside capacity: nothing shed or failed
            deadline = time.monotonic() + 10.0
            while (len([s for s in _span.recent_spans(200)
                        if s.kind == _span.KIND_SERVER])
                   < len(recorder.SCHEDULE)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            recs = qos_replay.load_corpus(CORPUS_OVERLOAD)
            qos_out = qos_replay.replay(str(server.listen_endpoint()), recs,
                                        rate_mult=1.0)
        finally:
            server.stop()
            server.join(timeout=2)
        snap = engine.qos.snapshot()["tenants"]
        n_prod = sum(1 for r in recorder.SCHEDULE if r[1] == recorder.PROD)
        assert snap["prod"]["admitted"] == 2 * n_prod
        assert snap["batch"]["admitted"] \
            == 2 * (len(recorder.SCHEDULE) - n_prod)
        spans = [s for s in _span.recent_spans(200)
                 if s.kind == _span.KIND_SERVER]
        assert len([s for s in spans if "prefill_us" in s.phases
                    and "decode_us" in s.phases]) >= len(recorder.SCHEDULE)
        server = _serving_server(plain)
        try:
            plain_out = qos_replay.replay(str(server.listen_endpoint()),
                                          recs, rate_mult=1.0)
        finally:
            server.stop()
            server.join(timeout=2)
        assert [c for c, _ in qos_out["records"]] == [0] * len(recs)
        assert qos_out["records"] == plain_out["records"]
        for r, (_c, toks) in zip(recs, qos_out["records"]):
            assert len(toks) == r.request.max_new_tokens
    finally:
        for e in (engine, plain):
            e.stop()
            e.kv.assert_idle("overload corpus gate teardown")
            e.model.close()
        for k, v in saved.items():
            _flags.set_flag(k, str(v))


# --------------------------------------- closed-loop overload (acceptance)
DECODE_S = 0.005     # the reference's decode-dominated stub: 5 ms a step
PREFILL_S = 0.0002   # and 0.2 ms a prefill


class _SteppedModel(_StubModel):
    """The reference's ``_QosStubModel`` on the stepped clock: a decode
    step moves the clock 5 ms, a prefill 0.2 ms."""

    def __init__(self, clock):
        super().__init__()
        self.clock = clock

    def prefill(self, prompt, table):
        self.prefills += 1
        self.clock.t += PREFILL_S
        return 1

    def decode_step(self, tokens, positions, tables):
        self.clock.t += DECODE_S
        return np.full(len(tables), 2, dtype=np.int32)


def _closed_loop(clock, qos, rate_mult):
    """The overload schedule at ``rate_mult`` through one port engine at
    the reference's closed-loop settings, this loop being its step loop
    on the stepped clock: arrivals submit when the clock passes their
    offset, each step admits and runs, and the governor ticks once a
    (stepped) second on the mean queue wait of that second's
    admissions. Returns per tenant rpc_replay's fields (shed counting
    EOVERCROWDED) and each request's tokens."""
    eng = ServingEngine(_SteppedModel(clock), _small_kv(num_blocks=256),
                        EngineConfig(max_batch=5, token_budget=64,
                                     max_queue=256, qos=qos))
    eng.running = True
    arrivals = sorted((off / rate_mult, i, tenant, prio, plen, new)
                      for i, (off, tenant, prio, plen, new)
                      in enumerate(recorder.SCHEDULE))
    t0 = clock.t
    out = {}

    def done_for(i, t_sub):
        def done(res):
            out[i] = (res.error_code, clock.t - t_sub, list(res.tokens))
        return done

    waits, next_tick, k = [], t0 + 1.0, 0
    try:
        while k < len(arrivals) or eng.queue_depth or eng.running_count:
            while k < len(arrivals) and t0 + arrivals[k][0] <= clock.t:
                _, i, tenant, prio, plen, new = arrivals[k]
                code, _ = eng.submit(eng.model.synth_prompt(plen), new,
                                     tenant_id=tenant, priority=prio,
                                     done=done_for(i, clock.t))
                if code != 0:
                    out[i] = (code, 0.0, [])
                k += 1
            if eng._qos_governor is not None and clock.t >= next_tick:
                eng._qos_governor.tick(
                    sample_us=float(np.mean(waits)) * 1e6 if waits else 0.0)
                waits, next_tick = [], next_tick + 1.0
            with eng._cv:
                admitted = eng._admit_locked()
            waits += [clock.t - s.t_submit for s in admitted]
            if not admitted and not eng._running:
                if k >= len(arrivals):
                    break
                clock.t = max(clock.t, t0 + arrivals[k][0])  # idle
                continue
            with eng.pool_gate:
                eng._step(admitted)
    finally:
        eng.running = False
        eng._abort_all_locked_out(errors.ELOGOFF, "closed loop done")
    eng.kv.assert_idle("closed loop")
    assert len(out) == len(arrivals)
    tenants = {}
    for tenant in (recorder.PROD, recorder.BATCH):
        idx = [i for i, r in enumerate(recorder.SCHEDULE) if r[1] == tenant]
        ok = [out[i][1] * 1e6 for i in idx if out[i][0] == 0]
        tenants[tenant] = {
            "sent": len(idx), "ok": len(ok),
            "fail": sum(1 for i in idx if out[i][0] != 0),
            "shed": sum(1 for i in idx if out[i][0] == errors.EOVERCROWDED),
            "p99_us": float(np.percentile(ok, 99)) if ok else 0.0}
    return tenants, {i: v[2] for i, v in out.items() if v[0] == 0}


def test_closed_loop_overload_protects_prod_and_sheds_batch(monkeypatch):
    """The acceptance gate on the stepped clock: the overload corpus's
    schedule at 2x the recorded rate against the saturable engine. With
    QoS armed the protected tenant's p99 stays within 1.5x of its 0.25x
    baseline while best-effort sheds EOVERCROWDED; the same wave with
    QoS off breaks the bound; every request that completes gets the
    tokens it gets with QoS off."""
    clock = Clock()
    monkeypatch.setattr(port_qos, "time", clock.module())
    monkeypatch.setattr(port_engine_mod, "time", clock.module())
    qos_cfg = QosConfig(tenants={"prod": 8.0, "batch": 1.0}, queue_cap=8,
                        protected_priority=1, ceiling_start=3.0,
                        ceiling_min=2.0, ceiling_max=3.0)
    base, _ = _closed_loop(clock, qos_cfg, 0.25)
    assert base["prod"]["fail"] == 0, base
    p99_unloaded = base["prod"]["p99_us"]
    assert p99_unloaded > 0

    over, over_toks = _closed_loop(clock, qos_cfg, 2)
    prod, batch = over["prod"], over["batch"]
    assert prod["fail"] == 0  # the protected lane never shed
    assert batch["shed"] > 0  # best-effort shed EOVERCROWDED
    assert batch["shed"] == batch["fail"]  # sheds, not errors
    assert prod["p99_us"] <= 1.5 * p99_unloaded, (prod, p99_unloaded)

    fifo, fifo_toks = _closed_loop(clock, None, 2)
    assert fifo["prod"]["fail"] == fifo["batch"]["fail"] == 0
    assert fifo["prod"]["p99_us"] > 1.5 * p99_unloaded, (fifo, p99_unloaded)
    for i, toks in over_toks.items():
        assert toks == fifo_toks[i], i

"""The port's fleet plane (brpc_tpu_torch/fleet) against the JAX
package's: every case of ``tests/test_fleet.py`` on the port (op-correct
cross-server merge of scraped /vars, member liveness under injected and
real failures, the SLO engine's multi-window error-budget burn, the
/fleet and /slo builtins, the two-real-server path with the cluster Adder
exact and the slo_burn rule flipping firing -> ok on a seeded latency
spike), then the cross-package cases: a port observer over one JAX member
and one port member merges exactly as the JAX observer does over the same
scraped pages, and each package's observer scrapes the other's server.

The fixture keeps the port's variable registry as it found it: every
variable a test exposes goes, and the module-level ones come back, so no
later test on the same worker loses a /vars entry or inherits a rule.
"""

import contextlib
import json
import sys
import time

import pytest

from brpc_tpu_torch import fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.fleet import (
    FleetObserver,
    SloEngine,
    SloObjective,
    global_observer,
    global_slo,
    set_global_observer,
)
from brpc_tpu_torch.metrics import clear_registry
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.series import global_series
from brpc_tpu_torch.metrics.status import PassiveStatus
from brpc_tpu_torch.metrics.variable import get_exposed
from brpc_tpu_torch.metrics.watch import STATE_FIRING, STATE_OK, global_watch


@contextlib.contextmanager
def _import_time_exposures():
    """Collect the variables that a port module exposes from its body
    while it is imported inside the block (a module first loaded by the
    test): they are the module's own, not the test's."""
    from brpc_tpu_torch.metrics import variable as _variable

    kept = {}
    expose = _variable.Variable.expose

    def recording(self, name, prefix=""):
        out = expose(self, name, prefix)
        frame = sys._getframe(1)
        while frame is not None:
            if (frame.f_code.co_name == "<module>" and str(
                    frame.f_globals.get("__name__", "")).startswith(
                        "brpc_tpu_torch")):
                kept[self.name] = self
                break
            frame = frame.f_back
        return out

    _variable.Variable.expose = recording
    try:
        yield kept
    finally:
        _variable.Variable.expose = expose


def _restore_registry(saved, kept):
    """Put the port's variable registry back to ``saved``: variables a
    test exposed are dropped, the ones it cleared are re-registered, and
    those a port module exposed as it was first imported during the test
    (``kept``) stay, as they would have outside it."""
    from brpc_tpu_torch.metrics import variable as _variable

    with _variable._registry_lock:
        for name, var in list(_variable._registry.items()):
            if saved.get(name) is not var and kept.get(name) is not var:
                var._name = None
        _variable._registry.clear()
        for name, var in list(kept.items()) + list(saved.items()):
            var._name = name
            _variable._registry[name] = var


@pytest.fixture(autouse=True)
def _clean_state():
    from brpc_tpu_torch.metrics import variable as _variable

    with _variable._registry_lock:
        saved = dict(_variable._registry)
    clear_registry()
    global_series().clear()
    kept = {}
    try:
        with _import_time_exposures() as kept:
            try:
                yield
            finally:
                global_slo().clear()
                set_global_observer(None)
                fault.disarm_all()
    finally:
        _restore_registry(saved, kept)
        global_series().clear()


@pytest.fixture(autouse=True)
def _leave_no_state():
    """Echo traffic here classifies EchoService.Echo as cheap in each
    package's run-to-completion table, which is keyed by name across the
    process: clear both after each test, so a later test's slow handler
    of that name is not run inline. And leave no watch rule of either
    package firing (a worker death, a tunnel torn down under a client)."""
    from brpc_tpu.rpc import run_to_completion as jax_rtc
    from brpc_tpu_torch.rpc import run_to_completion as port_rtc
    from tests.test_torch_kv_vars_watch import quiet_watches

    with quiet_watches():
        yield
    jax_rtc._reset_for_test()
    port_rtc._reset_for_test()


@pytest.fixture()
def fault_enabled():
    _flags.set_flag("fault_injection_enabled", True)
    yield
    fault.disarm_all()
    _flags.set_flag("fault_injection_enabled", False)


class _Http:
    """Minimal HttpMessage stand-in for invoking builtin handlers."""

    def __init__(self, path, query=None, headers=None):
        self.path = path
        self.query = query or {}
        self.headers = headers or {}

    def header(self, name, default=""):
        return self.headers.get(name, default)


def _doc(vars_map, series=None, rules=None, engines=None):
    """One fake member's scrape surface, keyed by endpoint path."""
    return {
        "/vars?series=json": {"workers": 0, "series": series or {},
                              "vars": vars_map},
        "/serving?format=json": {"engines": engines or []},
        "/watch?format=json": {"rules": rules or []},
    }


def _stub_fetch(cluster):
    """cluster: {addr: _doc(...)}. Missing addr/path -> ConnectionError."""
    def fetch(addr, path):
        member = cluster.get(addr)
        if member is None:
            raise ConnectionError(f"no route to {addr}")
        doc = member.get(path)
        if doc is None:
            raise ConnectionError(f"{addr}{path} -> HTTP 404")
        return doc
    return fetch


# ----------------------------------------------------------------- seeds
class TestObserverSeeds:
    def test_list_scheme_and_plain_and_list(self):
        for seeds in ("list://a:1,b:2", "a:1,b:2", ["a:1", "b:2"]):
            obs = FleetObserver(seeds, fetch=_stub_fetch({}))
            try:
                assert obs.member_addrs() == ["a:1", "b:2"]
            finally:
                obs.hide_all()

    def test_naming_service_reconsulted_each_round(self):
        class _Node:
            def __init__(self, ep):
                self.ep = ep

        class _Naming:
            def __init__(self):
                self.addrs = ["a:1"]

            def get_servers(self):
                return [_Node(a) for a in self.addrs]

        ns = _Naming()
        obs = FleetObserver(ns, fetch=_stub_fetch(
            {"a:1": _doc({}), "b:2": _doc({})}))
        try:
            obs.scrape_once()
            assert [m.addr for m in obs.members()] == ["a:1"]
            ns.addrs = ["a:1", "b:2"]   # the autoscaler hook: new member
            assert obs.member_addrs() == ["a:1", "b:2"]
            obs.scrape_once()
            assert [m.addr for m in obs.members()] == ["a:1", "b:2"]
        finally:
            obs.hide_all()


# ----------------------------------------------------------------- merge
class TestObserverMerge:
    def test_adder_sum_is_exact(self):
        obs = FleetObserver("a:1,b:2", fetch=_stub_fetch({
            "a:1": _doc({"g_reqs": ["sum", "counter", 2]}),
            "b:2": _doc({"g_reqs": ["sum", "counter", 3]}),
        }))
        try:
            assert obs.scrape_once() == 2
            assert obs.cluster_value("g_reqs") == 5
            var = get_exposed("cluster_g_reqs")
            assert var is not None and var.get_value() == 5
            assert var.prometheus_type == "counter"
            assert "sum" in var.prometheus_help
        finally:
            obs.hide_all()

    def test_latency_merges_qps_weighted_and_p99_takes_max(self):
        obs = FleetObserver("a:1,b:2", fetch=_stub_fetch({
            "a:1": _doc({"m_latency": ["wavg_qps", "gauge", 100.0],
                         "m_qps": ["sum", "gauge", 1.0],
                         "m_latency_p99": ["max", "gauge", 400.0]}),
            "b:2": _doc({"m_latency": ["wavg_qps", "gauge", 300.0],
                         "m_qps": ["sum", "gauge", 3.0],
                         "m_latency_p99": ["max", "gauge", 900.0]}),
        }))
        try:
            obs.scrape_once()
            # (100*1 + 300*3) / 4 — the busy member dominates the mean
            assert obs.cluster_value("m_latency") == pytest.approx(250.0)
            assert obs.cluster_value("m_qps") == pytest.approx(4.0)
            # conservative percentile bound: max, never an average
            assert obs.cluster_value("m_latency_p99") == 900.0
        finally:
            obs.hide_all()

    def test_derived_families_never_reingested(self):
        # an observer scraping an observer (or itself) must not feed
        # cluster_*/g_slo_* aggregates back into the merge
        obs = FleetObserver("a:1", fetch=_stub_fetch({
            "a:1": _doc({"g_x": ["sum", "counter", 1],
                         "cluster_g_x": ["sum", "counter", 99],
                         "g_slo_echo_burn": ["avg", "gauge", 5.0]}),
        }))
        try:
            obs.scrape_once()
            member = obs.members()[0]
            assert "g_x" in member.vars
            assert "cluster_g_x" not in member.vars
            assert "g_slo_echo_burn" not in member.vars
            assert get_exposed("cluster_cluster_g_x") is None
        finally:
            obs.hide_all()

    def test_malformed_records_skipped(self):
        obs = FleetObserver("a:1", fetch=_stub_fetch({
            "a:1": _doc({"ok": ["sum", "counter", 1],
                         "bad_arity": ["sum", "counter"],
                         "bad_value": ["sum", "counter", "nope"],
                         "bad_bool": ["sum", "counter", True]}),
        }))
        try:
            obs.scrape_once()
            assert set(obs.members()[0].vars) == {"ok"}
        finally:
            obs.hide_all()

    def test_merged_series_elementwise(self):
        obs = FleetObserver("a:1,b:2", fetch=_stub_fetch({
            "a:1": _doc({"g_q": ["sum", "gauge", 3.0]},
                        series={"g_q": {"second": [1.0, 2.0, 3.0],
                                        "count": 3}}),
            "b:2": _doc({"g_q": ["sum", "gauge", 30.0]},
                        series={"g_q": {"second": [10.0, 20.0, 30.0],
                                        "count": 2}}),
        }))
        try:
            obs.scrape_once()
            doc = obs.merged_series("g_q")
            assert doc["second"] == [11.0, 22.0, 33.0]
            assert doc["count"] == 3
            assert doc["op"] == "sum"
            assert obs.merged_series("no_such_var") is None
        finally:
            obs.hide_all()

    def test_serving_union_and_firing(self):
        obs = FleetObserver("a:1,b:2", fetch=_stub_fetch({
            "a:1": _doc({}, engines=[
                {"kv": {"shard_map": {"7": "0", "9": "1"}}}]),
            "b:2": _doc({}, rules=[
                {"name": "kv_pressure", "state": "firing"},
                {"name": "quiet", "state": "ok"}]),
        }))
        try:
            obs.scrape_once()
            assert obs.serving_shard_union() == {
                "a:1/7": "0", "a:1/9": "1"}
            assert obs.firing_rules() == {"b:2": ["kv_pressure"]}
        finally:
            obs.hide_all()


# ----------------------------------------------------------------- chaos
class TestObserverChaos:
    def test_member_death_degrades_and_recovers(self, fault_enabled):
        docs = {
            "a:1": _doc({"g_n": ["sum", "counter", 10]}),
            "b:2": _doc({"g_n": ["sum", "counter", 7]}),
        }
        obs = FleetObserver("a:1,b:2", fetch=_stub_fetch(docs))
        try:
            assert obs.scrape_once() == 2
            assert obs.cluster_value("g_n") == 17
            # kill only member b mid-scrape via the fault point
            fault.arm("fleet.scrape.fail", mode="always",
                      match={"member": "b:2"})
            assert obs.scrape_once() == 1   # no crash, a still answers
            a, b = obs.members()
            assert a.live() and not b.live()
            assert b.stale()
            assert b.consecutive_failures == 1
            assert "fleet.scrape.fail" in b.last_error
            # cluster_* degrades gracefully to the live subset
            assert obs.cluster_value("g_n") == 10
            assert get_exposed("cluster_fleet_members_live").get_value() == 1
            # recovery: disarm -> next scrape folds b back in
            fault.disarm("fleet.scrape.fail")
            assert obs.scrape_once() == 2
            assert all(m.live() for m in obs.members())
            assert obs.cluster_value("g_n") == 17
        finally:
            obs.hide_all()

    def test_all_members_dead_returns_zero_not_crash(self, fault_enabled):
        fault.arm("fleet.scrape.fail", mode="always")
        obs = FleetObserver("a:1,b:2", fetch=_stub_fetch({
            "a:1": _doc({}), "b:2": _doc({})}))
        try:
            assert obs.scrape_once() == 0
            assert obs.live_members() == []
            assert obs.cluster_value("anything") == 0
        finally:
            obs.hide_all()

    def test_fetch_exception_marks_member_not_live(self):
        # a plain network error (no fault framework) takes the same path
        obs = FleetObserver("a:1,gone:9", fetch=_stub_fetch(
            {"a:1": _doc({"g_n": ["sum", "counter", 4]})}))
        try:
            assert obs.scrape_once() == 1
            gone = [m for m in obs.members() if m.addr == "gone:9"][0]
            assert not gone.live() and gone.scrapes_failed == 1
            assert obs.cluster_value("g_n") == 4
        finally:
            obs.hide_all()


# --------------------------------------------------------------- builtins
class TestFleetBuiltin:
    def test_no_observer_message(self):
        from brpc_tpu_torch.builtin.services import fleet_service

        status, _, body = fleet_service(None, _Http("/fleet"))
        assert status == 200 and "no fleet observer" in body

    def test_member_table_and_json(self):
        from brpc_tpu_torch.builtin.services import fleet_service

        obs = FleetObserver("a:1,b:2", fetch=_stub_fetch({
            "a:1": _doc({"g_n": ["sum", "counter", 1]},
                        rules=[{"name": "hot", "state": "firing"}]),
        }))
        set_global_observer(obs)
        try:
            obs.scrape_once()
            status, _, body = fleet_service(None, _Http("/fleet"))
            assert status == 200
            assert "1/2 members live" in body
            assert "a:1" in body and "b:2" in body
            assert "hot" in body
            status, ctype, body = fleet_service(
                None, _Http("/fleet", {"format": "json"}))
            assert status == 200 and "json" in ctype
            doc = json.loads(body)
            assert doc["live"] == 1 and len(doc["members"]) == 2
            assert doc["firing"] == {"a:1": ["hot"]}
        finally:
            set_global_observer(None)
            obs.hide_all()

    def test_trace_404_when_no_spans(self):
        from brpc_tpu_torch.builtin.services import fleet_service

        obs = FleetObserver("a:1", fetch=_stub_fetch({"a:1": _doc({})}))
        set_global_observer(obs)
        try:
            obs.scrape_once()
            status, _, body = fleet_service(
                None, _Http("/fleet/trace/deadbeef"))
            assert status == 404
        finally:
            set_global_observer(None)
            obs.hide_all()


# ------------------------------------------------------------------- slo
class TestSloSpec:
    def test_stem_derivation_and_bound_ms(self):
        obj = SloObjective.from_spec(
            "echo:var=rpc_method_echoservice_echo,bound_ms=50,"
            "objective=0.02,fast_s=5,slow_s=30,tenant=gold")
        assert obj.name == "echo"
        assert obj.latency_var == "rpc_method_echoservice_echo_latency_p99"
        assert obj.errors_var == "rpc_method_echoservice_echo_errors"
        assert obj.total_var == "rpc_method_echoservice_echo_count"
        assert obj.latency_bound_us == 50000.0
        assert obj.objective == 0.02
        assert (obj.fast_window_s, obj.slow_window_s) == (5, 30)
        assert obj.tenant == "gold"

    def test_explicit_vars_override_stem(self):
        obj = SloObjective.from_spec(
            "x:var=stem,latency_var=custom_p99,bound_us=1500")
        assert obj.latency_var == "custom_p99"
        assert obj.latency_bound_us == 1500.0
        assert obj.errors_var == "stem_errors"

    def test_invalid_specs_rejected(self):
        with pytest.raises(ValueError):
            SloObjective.from_spec(":var=x")          # no name
        with pytest.raises(ValueError):
            SloObjective.from_spec("x:novalue")       # piece without =
        with pytest.raises(ValueError):
            SloObjective("x", latency_var="v", objective=0.0)
        with pytest.raises(ValueError):
            SloObjective("x", latency_var="v", fast_window_s=10,
                         slow_window_s=5)
        with pytest.raises(ValueError):
            SloObjective("x")                         # no vars at all

    def test_objectives_flag_installs_on_global_engine(self):
        _flags.set_flag("slo_objectives",
                        "flagged:var=rpc_method_x,bound_ms=10")
        try:
            names = [o.name for o in global_slo().objectives()]
            assert "flagged" in names
            assert any(r.name == "slo_burn_flagged"
                       for r in global_watch().rules())
        finally:
            global_slo().clear()
            _flags.set_flag("slo_objectives", "")
        # a bad spec string is rejected by the validator, not half-applied
        with pytest.raises(_flags.FlagError):
            _flags.set_flag("slo_objectives", "broken spec")


class TestSloBurn:
    def test_latency_burn_multi_window_gate(self):
        from brpc_tpu_torch.metrics.series import SeriesRegistry

        holder = {"p99": 50.0}
        PassiveStatus(lambda: holder["p99"]).expose("t_slo_p99")
        engine = SloEngine()
        engine.add(SloObjective(
            "t", latency_var="t_slo_p99", latency_bound_us=100.0,
            objective=0.1, fast_window_s=4, slow_window_s=8))
        try:
            # a private registry so the 1Hz background sampler can't add
            # extra ticks under the exact-arithmetic assertions below
            reg = SeriesRegistry()
            for _ in range(8):
                reg.tick()                       # healthy baseline
            engine.evaluate(reg)
            state = engine._state["t"]
            assert state["burn"] == 0.0
            assert state["budget_left"] == 1.0
            holder["p99"] = 500.0                # breach the 100us bound
            for _ in range(2):
                reg.tick()
            engine.evaluate(reg)
            state = engine._state["t"]
            # fast window (4s): 2/4 violations / 0.1 objective = 5
            assert state["burn_fast"] == pytest.approx(5.0)
            # slow window (8s): 2/8 / 0.1 = 2.5; headline = min(fast, slow)
            assert state["burn_slow"] == pytest.approx(2.5)
            assert state["burn"] == pytest.approx(2.5)
            assert state["budget_left"] == 0.0
            # the exposed gauge reads the cache, not the series registry
            assert get_exposed("g_slo_t_burn").get_value() == \
                pytest.approx(2.5)
            assert get_exposed("g_slo_t_budget_left").get_value() == 0.0
        finally:
            engine.clear()

    def test_error_burn_from_counter_deltas(self):
        from brpc_tpu_torch.metrics.series import SeriesRegistry

        errors = Adder("t_slo_e")
        errors.expose_as("t_slo_e")
        total = Adder("t_slo_n")
        total.expose_as("t_slo_n")
        engine = SloEngine()
        engine.add(SloObjective(
            "e", errors_var="t_slo_e", total_var="t_slo_n",
            objective=0.1, fast_window_s=4, slow_window_s=8))
        try:
            reg = SeriesRegistry()
            reg.tick()
            total.put(100)
            errors.put(5)
            reg.tick()
            engine.evaluate(reg)
            # 5 errors / 100 requests = 5% rate, / 10% objective = 0.5
            state = engine._state["e"]
            assert state["burn_fast"] == pytest.approx(0.5)
            assert state["burn"] <= 1.0
        finally:
            engine.clear()

    def test_rule_bound_reloadable_via_flag(self):
        engine = SloEngine()
        engine.add(SloObjective("r", latency_var="v", latency_bound_us=1))
        try:
            rule = {r.name: r for r in global_watch().rules()}["slo_burn_r"]
            assert rule.bound() == 1.0
            _flags.set_flag("slo_burn_threshold", 2.5)
            assert rule.bound() == 2.5
        finally:
            _flags.set_flag("slo_burn_threshold", 1.0)
            engine.clear()

    def test_slo_builtin_text_and_json(self):
        from brpc_tpu_torch.builtin.services import slo_service

        status, _, body = slo_service(None, _Http("/slo"))
        assert status == 200 and "no slo objectives" in body
        engine = global_slo()
        engine.add(SloObjective(
            "b", latency_var="v_p99", latency_bound_us=2000.0))
        try:
            status, _, body = slo_service(None, _Http("/slo"))
            assert "b" in body and "burn threshold" in body
            status, ctype, body = slo_service(
                None, _Http("/slo", {"format": "json"}))
            doc = json.loads(body)
            assert doc["source"] == "local"
            assert doc["objectives"][0]["name"] == "b"
            assert doc["objectives"][0]["rule"]["name"] == "slo_burn_b"
        finally:
            engine.clear()

    def test_fleet_source_reads_observer_merged_series(self):
        obs = FleetObserver("a:1,b:2", fetch=_stub_fetch({
            "a:1": _doc({"m_p99": ["max", "gauge", 900.0]},
                        series={"m_p99": {"second": [900.0] * 4,
                                          "count": 4}}),
            "b:2": _doc({"m_p99": ["max", "gauge", 10.0]},
                        series={"m_p99": {"second": [10.0] * 4,
                                          "count": 4}}),
        }))
        engine = SloEngine().attach_observer(obs)
        engine.add(SloObjective(
            "f", latency_var="m_p99", latency_bound_us=100.0,
            objective=0.5, fast_window_s=2, slow_window_s=4))
        try:
            obs.scrape_once()
            engine.evaluate(global_series())
            # merged p99 = max(900, 10) = 900 > 100us bound every second:
            # burn = 1.0 violation rate / 0.5 objective = 2 on both windows
            state = engine._state["f"]
            assert state["burn_fast"] == pytest.approx(2.0)
            assert state["burn"] == pytest.approx(2.0)
            assert engine.to_dict()["source"] == "fleet"
        finally:
            engine.clear()
            obs.hide_all()


# --------------------------------------------------- 2-real-server e2e
class TestFleetE2E:
    def _start_pair(self):
        from brpc_tpu_torch.rpc import Server
        from tests.test_torch_http import EchoServiceImpl

        a = Server().add_service(EchoServiceImpl()).start("127.0.0.1:0")
        b = Server().add_service(EchoServiceImpl()).start("127.0.0.1:0")
        return a, b

    def test_cluster_adder_exactness_over_real_scrape(self):
        from brpc_tpu_torch.policy.http_protocol import http_fetch

        a, b = self._start_pair()
        counter = Adder("g_fleet_e2e_reqs")
        counter.expose_as("g_fleet_e2e_reqs")
        addr_a = str(a.listen_endpoint())
        addr_b = str(b.listen_endpoint())
        obs = FleetObserver(f"list://{addr_a},{addr_b}")
        try:
            counter.put(7)
            assert obs.scrape_once() == 2
            # acceptance: the cluster Adder aggregate equals the sum of
            # independently fetched member /vars values, exactly
            member_sum = 0
            for addr in (addr_a, addr_b):
                resp = http_fetch(addr, "GET", "/vars?series=json")
                assert resp.status == 200
                doc = json.loads(bytes(resp.body).decode())
                member_sum += doc["vars"]["g_fleet_e2e_reqs"][2]
            assert obs.cluster_value("g_fleet_e2e_reqs") == member_sum
            assert get_exposed(
                "cluster_g_fleet_e2e_reqs").get_value() == member_sum
            # /fleet over real HTTP from a member port
            set_global_observer(obs)
            resp = http_fetch(addr_a, "GET", "/fleet")
            assert resp.status == 200
            assert addr_b.encode() in bytes(resp.body)
            assert b"2/2 members live" in bytes(resp.body)
        finally:
            set_global_observer(None)
            obs.hide_all()
            for srv in (a, b):
                srv.stop()
                srv.join(timeout=2)

    def test_real_member_death_marks_stale(self):
        a, b = self._start_pair()
        addr_a = str(a.listen_endpoint())
        addr_b = str(b.listen_endpoint())
        obs = FleetObserver(f"list://{addr_a},{addr_b}")
        try:
            assert obs.scrape_once() == 2
            b.stop()
            b.join(timeout=2)
            assert obs.scrape_once() == 1   # observer survives the death
            dead = [m for m in obs.members() if m.addr == addr_b][0]
            assert not dead.live() and dead.stale()
            live = [m for m in obs.members() if m.addr == addr_a][0]
            assert live.live()
        finally:
            obs.hide_all()
            a.stop()
            a.join(timeout=2)

    def test_seeded_latency_spike_flips_slo_burn_rule(self, fault_enabled):
        """Acceptance: a per-method latency spike seeded on one member via
        rpc.handler.delay drives the observer's slo_burn rule to firing,
        then back to ok once the spike rolls out of the percentile
        window (ticks driven manually — no wall-clock waits)."""
        from brpc_tpu_torch.metrics import global_collector
        from brpc_tpu_torch.proto import echo_pb2
        from brpc_tpu_torch.rpc import Channel, Stub
        from tests.test_torch_http import ECHO_DESC

        a, b = self._start_pair()
        addr_a = str(a.listen_endpoint())
        addr_b = str(b.listen_endpoint())
        obs = FleetObserver(f"list://{addr_a},{addr_b}")
        engine = global_slo().attach_observer(obs)   # /slo reads this one
        # native protocol: its dispatch path carries the rpc.handler.delay
        # fault point (the http lane has no injection sites)
        stub = Stub(Channel().init(addr_a), ECHO_DESC)

        def pump(n):
            for i in range(n):
                assert stub.Echo(
                    echo_pb2.EchoRequest(message=str(i))).message == str(i)

        def step():
            global_collector().tick_all()   # sweep vars into series
            obs.scrape_once()               # pull member series
            engine.evaluate(global_series())  # recompute burn cache
            global_collector().tick_all()   # sample g_slo_*, run watch

        try:
            engine.add(SloObjective(
                "echo", latency_var="rpc_method_echoservice_echo_latency_p99",
                latency_bound_us=20000.0, objective=0.25,
                fast_window_s=4, slow_window_s=8))
            rule = {r.name: r
                    for r in global_watch().rules()}["slo_burn_echo"]
            pump(5)                          # healthy baseline
            for _ in range(4):
                step()
            assert rule.state in (STATE_OK, "no_data")
            # the spike: every Echo on member a delayed 30ms > 20ms bound
            fault.arm("rpc.handler.delay", mode="always", delay_ms=30)
            deadline = time.monotonic() + 30.0
            while rule.state != STATE_FIRING:
                assert time.monotonic() < deadline, \
                    f"rule never fired (observed={rule.observed})"
                pump(2)
                step()
            assert rule.state == STATE_FIRING
            # /slo shows the burn from the fleet-merged series
            from brpc_tpu_torch.builtin.services import slo_service

            _, _, body = slo_service(
                None, _Http("/slo", {"format": "json"}))
            doc = json.loads(body)
            echo = [o for o in doc["objectives"] if o["name"] == "echo"][0]
            assert doc["source"] == "fleet"
            assert echo["burn"] > 1.0
            # recovery: disarm, fast traffic rolls the spike out of the
            # percentile window, the rule clears back to ok
            fault.disarm("rpc.handler.delay")
            deadline = time.monotonic() + 30.0
            while rule.state != STATE_OK:
                assert time.monotonic() < deadline, \
                    f"rule never cleared (observed={rule.observed})"
                pump(4)
                step()
            assert rule.state == STATE_OK
        finally:
            engine.clear()
            engine.attach_observer(None)
            obs.hide_all()
            for srv in (a, b):
                srv.stop()
                srv.join(timeout=2)


# ------------------------------------------------ the two packages together
def _hide_jax(name):
    from brpc_tpu.metrics.variable import get_exposed as jax_exposed

    var = jax_exposed(name)
    if var is not None:
        var.hide()


class TestAcrossPackages:
    """A port observer and a JAX observer over a JAX member and a port
    member, each a real Server in this process answering HTTP on its
    port."""

    NAME = "g_fleet_cross_reqs"

    def _members(self):
        import brpc_tpu.rpc as jax_rpc
        from brpc_tpu.metrics.reducer import Adder as JaxAdder
        from brpc_tpu_torch.rpc import Server
        from tests.test_http import EchoServiceImpl as JaxEcho
        from tests.test_torch_http import EchoServiceImpl

        jax_srv = jax_rpc.Server().add_service(JaxEcho()).start(
            "127.0.0.1:0")
        port_srv = Server().add_service(EchoServiceImpl()).start(
            "127.0.0.1:0")
        jax_var = JaxAdder(self.NAME)
        jax_var.put(5)
        port_var = Adder(self.NAME)
        port_var.put(7)
        return jax_srv, port_srv, jax_var, port_var

    @staticmethod
    def _stop(*servers):
        for srv in servers:
            srv.stop()
            srv.join(timeout=2)

    def test_port_merge_equals_the_jax_merge_over_the_same_pages(self):
        """Both observers read the same scraped documents (one fetch of
        each member's three pages over real HTTP): every cluster value,
        merged series, shard union and firing map is equal."""
        from brpc_tpu.fleet import FleetObserver as JaxObserver
        from brpc_tpu_torch.policy.http_protocol import http_fetch

        jax_srv, port_srv, jax_var, port_var = self._members()
        addrs = [str(jax_srv.listen_endpoint()),
                 str(port_srv.listen_endpoint())]
        jax_obs = port_obs = None
        try:
            pages = {}
            for addr in addrs:
                pages[addr] = {}
                for path in ("/vars?series=json", "/serving?format=json",
                             "/watch?format=json"):
                    resp = http_fetch(addr, "GET", path, timeout=10.0)
                    assert resp.status == 200, (addr, path)
                    pages[addr][path] = json.loads(bytes(resp.body))
            assert pages[addrs[0]]["/vars?series=json"]["vars"][
                self.NAME][2] == 5
            assert pages[addrs[1]]["/vars?series=json"]["vars"][
                self.NAME][2] == 7
            port_obs = FleetObserver(addrs, fetch=_stub_fetch(pages))
            jax_obs = JaxObserver(addrs, fetch=_stub_fetch(pages))
            assert port_obs.scrape_once() == jax_obs.scrape_once() == 2
            names = set()
            for m in port_obs.members():
                names |= set(m.vars)
            assert self.NAME in names   # both registries may be near empty
            for name in sorted(names):
                assert port_obs.cluster_value(name) == \
                    jax_obs.cluster_value(name), name
                assert port_obs.merged_series(name) == \
                    jax_obs.merged_series(name), name
            assert port_obs.cluster_value(self.NAME) == 12
            assert port_obs.serving_shard_union() == \
                jax_obs.serving_shard_union()
            assert port_obs.firing_rules() == jax_obs.firing_rules()
            pd, jd = port_obs.to_dict(), jax_obs.to_dict()
            for m in pd["members"] + jd["members"]:
                m.pop("age_s")
            assert pd == jd
        finally:
            for obs in (port_obs, jax_obs):
                if obs is not None:
                    obs.hide_all()
            _hide_jax(self.NAME)
            self._stop(jax_srv, port_srv)

    def test_each_observer_scrapes_the_other_packages_server(self):
        from brpc_tpu.fleet import FleetObserver as JaxObserver

        jax_srv, port_srv, jax_var, port_var = self._members()
        seeds = (f"list://{jax_srv.listen_endpoint()},"
                 f"{port_srv.listen_endpoint()}")
        observers = []
        try:
            for cls in (FleetObserver, JaxObserver):
                obs = cls(seeds)
                observers.append(obs)
                assert obs.scrape_once() == 2
                assert all(m.live() for m in obs.members())
                assert obs.cluster_value(self.NAME) == 12
        finally:
            for obs in observers:
                obs.hide_all()
            _hide_jax(self.NAME)
            self._stop(jax_srv, port_srv)

"""The port's profiler pages (brpc_tpu_torch/builtin/profiling.py over
the port's profiling/sampler.py, fiber/butex.py and fiber/runtime.py):
every case of the JAX package's ``tests/test_profiling.py`` with each
server the port's — the whole-process sampler (/hotspots/*, /pprof/*),
phase attribution, the continuous ring, contention waiter stacks, the
folded differ, flame_view SVG rendering, and /vlog (reference
builtin/hotspots_service + pprof_service + vlog_service); ``tools/``'s
prof_diff and flame_view read the port's folded profiles. Beside them,
the port's differ against the JAX package's on numpy-seeded profiles."""

import logging
import os
import sys
import threading
import time

import pytest

from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.policy.http_protocol import http_fetch
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, Service, Stub

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


class Echo(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def Echo(self, cntl, request, done):
        return echo_pb2.EchoResponse(message=request.message)


@pytest.fixture()
def server():
    srv = Server().add_service(Echo()).start("127.0.0.1:0")
    yield srv
    srv.stop()
    srv.join(timeout=2)


def _hot_spin(stop_ev):
    """The known-hot function: pure-python arithmetic, no wait leaves."""
    x = 1
    while not stop_ev.is_set():
        for i in range(2000):
            x = (x * 31 + i) % 1000003
    return x


@pytest.fixture()
def busy_thread():
    stop = threading.Event()
    t = threading.Thread(target=_hot_spin, args=(stop,),
                         name="test-busy-spin")
    t.start()
    yield t
    stop.set()
    t.join(timeout=5)


class TestSamplerDominance:
    """The acceptance check: a busy worker thread dominates the sampler's
    cpu-classified output — and cProfile provably misses it.

    Threads leaked by OTHER test modules parked in C-level socket reads
    have no Python wait leaf and classify as on-cpu, so both tests take a
    baseline profile before the spin starts and discount those leaves."""

    def test_busy_worker_dominates_cpu_samples(self):
        from brpc_tpu_torch.profiling.sampler import run_profile

        noise = {f for f, _ in run_profile(0.25, hz=100.0, budget=False)
                 .top_self(100, cpu_only=True)}
        stop = threading.Event()
        t = threading.Thread(target=_hot_spin, args=(stop,),
                             name="test-busy-spin")
        t.start()
        try:
            prof = run_profile(0.5, hz=200.0, budget=False)
        finally:
            stop.set()
            t.join(timeout=5)
        top = dict(prof.top_self(100, cpu_only=True))
        hot = sum(n for f, n in top.items()
                  if f.endswith("test_torch_profiling.py:_hot_spin"))
        denom = sum(n for f, n in top.items() if f not in noise)
        assert hot > 20  # the spin thread must actually be sampled
        assert hot >= 0.8 * denom, sorted(top.items(), key=lambda kv:
                                          -kv[1])[:5]

    def test_hotspots_cpu_attributes_hot_function(self, server):
        import json as _json

        ep = str(server.listen_endpoint())

        def fetch():
            r = http_fetch(ep,
                           path="/hotspots/cpu?seconds=0.5&format=json",
                           timeout=10)
            assert r.status == 200
            return _json.loads(r.body)

        noise = {f for f, _ in fetch()["top_self_cpu"]}
        stop = threading.Event()
        t = threading.Thread(target=_hot_spin, args=(stop,),
                             name="test-busy-spin")
        t.start()
        try:
            d = fetch()
        finally:
            stop.set()
            t.join(timeout=5)
        assert d["samples"] > 0 and d["cpu_samples"] > 0
        hot = sum(n for f, n in d["top_self_cpu"]
                  if f.endswith("test_torch_profiling.py:_hot_spin"))
        denom = sum(n for f, n in d["top_self_cpu"] if f not in noise)
        assert hot > 20, d["top_self_cpu"][:5]
        assert hot >= 0.8 * denom, d["top_self_cpu"][:5]

    def test_cprofile_engine_misses_other_threads(self, server,
                                                  busy_thread):
        ep = str(server.listen_endpoint())
        r = http_fetch(ep, path="/hotspots/cpu?seconds=0.3&engine=cprofile",
                       timeout=10)
        assert r.status == 200
        # the legacy engine instruments ONLY the handler thread (which
        # sleeps) — the spinning thread is invisible, and the output says so
        assert b"_hot_spin" not in r.body
        assert b"calling thread ONLY" in r.body
        assert b"cumulative" in r.body


class TestPhaseAttribution:
    def test_phases_on_live_tpu_echo(self):
        """Span phases stamped by the server datapath show up keyed in the
        sampler aggregate during a live tpu:// echo run."""
        from brpc_tpu_torch.profiling.sampler import ProfileSession

        srv = Server().add_service(Echo()).start("tpu://127.0.0.1:0/0")
        try:
            ch = Channel(ChannelOptions(protocol="trpc_std",
                                        timeout_ms=30000))
            ch.init(str(srv.listen_endpoint()))
            stub = Stub(ch, Echo.DESCRIPTOR)
            stub.Echo(echo_pb2.EchoRequest(message="warm"))
            sess = ProfileSession(hz=400.0, budget=False).start()
            deadline = time.monotonic() + 1.5
            while time.monotonic() < deadline:
                stub.Echo(echo_pb2.EchoRequest(message="x" * 512))
            prof = sess.stop()
        finally:
            srv.stop()
            srv.join(timeout=2)
        phases = set(prof.by_phase()) - {"-"}
        known = {"parse", "execute", "respond", "send", "credit_wait"}
        assert phases <= known | phases  # sanity: by_phase returns strings
        assert len(phases & known) >= 2, (
            f"expected >=2 marked phases in {sorted(phases)}")

    def test_folded_lines_carry_role_and_phase_roots(self):
        from brpc_tpu_torch.profiling.sampler import FoldedProfile

        prof = FoldedProfile(hz=100.0)
        prof.add("worker", "execute", ("a.py:f", "b.py:g"), 3)
        lines = prof.folded_lines()
        assert lines == ["role=worker;phase=execute;a.py:f;b.py:g 3"]
        assert prof.folded_lines(tag_role=False, tag_phase=False) == \
            ["a.py:f;b.py:g 3"]


class TestContinuousRing:
    def test_ring_retention_and_eviction(self):
        """A dedicated ContinuousProfiler honors the (reloadable) window
        and ring-capacity flags: more windows than capacity are produced,
        only the newest `cap` are retained."""
        from brpc_tpu_torch.profiling.sampler import ContinuousProfiler

        _flags.set_flag("collector_max_samples_per_second", "100000")
        from brpc_tpu_torch.metrics.collector import global_collector
        global_collector()._deny_until = 0.0
        _flags.set_flag("tpu_prof_continuous_hz", "100")
        _flags.set_flag("tpu_prof_window_s", "0.15")
        _flags.set_flag("tpu_prof_ring_windows", "3")
        cont = ContinuousProfiler()
        t0 = time.monotonic()
        cont.start()
        try:
            time.sleep(1.2)
            wins = cont.windows()
            produced = (time.monotonic() - t0) / 0.15
            assert produced > 4  # enough windows elapsed to force eviction
            assert 1 <= len(wins) <= 3
            # retained windows are the NEWEST ones: oldest retained window
            # started well after the profiler itself did
            assert wins[0].start_ts > time.time() - 1.0
            assert all(w.ticks > 0 for w in wins)
            merged = cont.query(None, None)
            assert merged.ticks == sum(w.ticks for w in wins)
            # a range before every window merges nothing
            empty = cont.query(time.time() - 3600, time.time() - 1800)
            assert empty.samples == 0
        finally:
            cont.stop()
            cont.join(timeout=5)
            _flags.set_flag("tpu_prof_continuous_hz", "5")
            _flags.set_flag("tpu_prof_window_s", "15")
            _flags.set_flag("tpu_prof_ring_windows", "24")
            _flags.set_flag("collector_max_samples_per_second", "1000")

    def test_continuous_endpoint_lists_ring(self, server):
        ep = str(server.listen_endpoint())
        r = http_fetch(ep, path="/hotspots/continuous", timeout=10)
        assert r.status == 200
        assert b"continuous profiler ring" in r.body
        r = http_fetch(ep, path="/hotspots/continuous?from=-60&to=0",
                       timeout=10)
        assert r.status == 200


class TestContentionStacks:
    def test_waiter_stacks_under_seized_lock(self, server):
        """Threads blocked on a seized TrackedLock leave sampled waiter
        STACKS (not just wait totals) at the site, and the /hotspots/
        contention endpoint renders them."""
        from brpc_tpu_torch.analysis.runtime_check import TrackedLock
        from brpc_tpu_torch.fiber import butex

        _flags.set_flag("collector_max_samples_per_second", "100000")
        from brpc_tpu_torch.metrics.collector import global_collector
        global_collector()._deny_until = 0.0
        lk = TrackedLock("test.seized", threading.Lock())
        try:
            lk.acquire()

            def waiter():
                lk.acquire()
                lk.release()

            ts = [threading.Thread(target=waiter, name=f"test-waiter-{i}")
                  for i in range(3)]
            for t in ts:
                t.start()
            time.sleep(0.15)
            lk.release()
            for t in ts:
                t.join(timeout=5)
            stacks = butex.contention_stacks()
            assert "lock:test.seized" in stacks
            folded, waits, wait_ns = stacks["lock:test.seized"][0]
            assert "test_torch_profiling.py:waiter" in folded
            assert waits >= 1 and wait_ns > 0
            ep = str(server.listen_endpoint())
            r = http_fetch(ep, path="/hotspots/contention", timeout=10)
            assert r.status == 200
            assert b"lock:test.seized" in r.body
            assert b"stack x" in r.body
        finally:
            _flags.set_flag("collector_max_samples_per_second", "1000")

    def test_contention_records_real_waits(self, server):
        from brpc_tpu_torch.fiber.butex import Butex, contention_stats

        bx = Butex(0, site="test.site")

        def waiter():
            bx.wait(0, timeout=2)

        t = threading.Thread(target=waiter, name="test-butex-waiter")
        t.start()
        time.sleep(0.05)
        bx.wake(1)
        t.join()
        rows = {site: (w, ns) for site, w, ns in contention_stats()}
        assert "test.site" in rows
        waits, wait_ns = rows["test.site"]
        assert waits >= 1 and wait_ns > 0


class TestDiff:
    BASE = "role=w;phase=-;a.py:f;b.py:g 90\nrole=w;phase=-;a.py:f;c.py:h 10\n"
    NEW = "role=w;phase=-;a.py:f;b.py:g 50\nrole=w;phase=-;a.py:f;c.py:h 50\n"

    def test_self_movers_and_threshold(self):
        from brpc_tpu_torch.profiling import diff as d

        rep = d.diff_folded(self.BASE, self.NEW, min_delta_pct=5.0)
        movers = {m["frame"]: m["delta_pct"] for m in rep["movers"]}
        assert movers["c.py:h"] == pytest.approx(40.0)
        assert movers["b.py:g"] == pytest.approx(-40.0)
        # below-threshold movers disappear entirely
        rep = d.diff_folded(self.BASE, self.NEW, min_delta_pct=45.0)
        assert rep["movers"] == []
        # a non-leaf frame never moves in self mode, but does in total mode
        assert "a.py:f" not in movers
        rep = d.diff_folded(
            "a.py:f;b.py:g 100", "c.py:h;b.py:g 100",
            min_delta_pct=5.0, mode="total")
        total_movers = {m["frame"] for m in rep["movers"]}
        assert {"a.py:f", "c.py:h"} <= total_movers

    def test_top_truncation_reports_suppressed(self):
        from brpc_tpu_torch.profiling import diff as d

        base = "\n".join(f"f{i}.py:x 1" for i in range(30)) + "\nz.py:z 70"
        rep = d.diff_folded(base, "z.py:z 100", top=5, min_delta_pct=0.1)
        assert len(rep["movers"]) == 5
        assert rep["suppressed"] > 0
        assert "truncated" in d.render_text(rep)

    def test_prof_diff_cli_gate(self, tmp_path):
        sys.path.insert(0, TOOLS)
        try:
            import prof_diff
        finally:
            sys.path.remove(TOOLS)
        base = tmp_path / "base.folded"
        new = tmp_path / "new.folded"
        base.write_text(self.BASE)
        new.write_text(self.NEW)
        assert prof_diff.main([str(base), str(new)]) == 0
        assert prof_diff.main([str(base), str(new),
                               "--fail-above-pct", "10"]) == 1
        assert prof_diff.main([str(base), str(new),
                               "--fail-above-pct", "90"]) == 0
        assert prof_diff.main([str(tmp_path / "missing.folded"),
                               str(new)]) == 2


class TestFlameView:
    FOLDED = ("role=w;phase=execute;main.py:run;hot.py:spin 80\n"
              "role=w;phase=-;main.py:run;idle.py:park 20\n")

    def test_render_svg(self):
        sys.path.insert(0, TOOLS)
        try:
            import flame_view
        finally:
            sys.path.remove(TOOLS)
        counts = flame_view.parse_folded(self.FOLDED)
        assert sum(counts.values()) == 100
        svg = flame_view.render_svg(counts, width=800, title="t")
        assert svg.startswith("<svg")
        assert "hot.py:spin" in svg
        assert "80 samples" in svg
        # same frame renders the same color across runs (diff stability)
        assert flame_view._color("hot.py:spin") == \
            flame_view._color("hot.py:spin")

    def test_cli_smoke(self, tmp_path, capsys):
        sys.path.insert(0, TOOLS)
        try:
            import flame_view
        finally:
            sys.path.remove(TOOLS)
        src = tmp_path / "p.folded"
        out = tmp_path / "p.svg"
        src.write_text(self.FOLDED)
        assert flame_view.main([str(src), "-o", str(out)]) == 0
        assert out.read_text().startswith("<svg")
        assert "2 unique stacks, 100 samples" in capsys.readouterr().out
        assert flame_view.main([str(tmp_path / "empty"), "-o",
                                str(out)]) == 2


class TestProfiling:
    def test_cpu_profile_sampler_default(self, server):
        ep = str(server.listen_endpoint())
        r = http_fetch(ep, path="/hotspots/cpu?seconds=0.2", timeout=10)
        assert r.status == 200
        assert b"whole process, all threads" in r.body
        assert b"by role (wall samples)" in r.body
        assert b"folded stacks" in r.body
        r = http_fetch(ep, path="/hotspots/cpu?seconds=0.2&format=folded",
                       timeout=10)
        assert r.status == 200
        assert b"role=" in r.body and b"phase=" in r.body

    def test_concurrent_profile_runs_rejected(self, server):
        ep = str(server.listen_endpoint())
        results = []

        def long_run():
            results.append(http_fetch(
                ep, path="/hotspots/cpu?seconds=1.2", timeout=15))

        t = threading.Thread(target=long_run, name="test-prof-long")
        t.start()
        time.sleep(0.3)
        r = http_fetch(ep, path="/hotspots/cpu?seconds=0.1", timeout=10)
        t.join(timeout=15)
        assert r.status == 503
        assert b"another profile is running" in r.body
        assert results and results[0].status == 200

    def test_heap_snapshot_and_growth(self, server):
        import tracemalloc

        tracing = tracemalloc.is_tracing()
        ep = str(server.listen_endpoint())
        try:
            http_fetch(ep, path="/hotspots/heap")  # may just start tracing
            r = http_fetch(ep, path="/hotspots/heap")
            assert r.status == 200 and b"allocation sites" in r.body
            http_fetch(ep, path="/hotspots/growth")
            # allocate between the two growth snapshots
            blob = [bytearray(1024) for _ in range(100)]
            r = http_fetch(ep, path="/hotspots/growth")
            assert r.status == 200 and b"growth since" in r.body
            del blob
        finally:
            # the page leaves tracemalloc on; tracing every allocation
            # slows every later test in this process tens of times
            if not tracing:
                tracemalloc.stop()

    def test_contention_endpoint(self, server):
        ep = str(server.listen_endpoint())
        r = http_fetch(ep, path="/hotspots/contention")
        assert r.status == 200 and b"contention" in r.body

    def test_hotspots_index(self, server):
        ep = str(server.listen_endpoint())
        r = http_fetch(ep, path="/hotspots")
        assert b"/hotspots/cpu" in r.body
        assert b"/hotspots/flame" in r.body
        assert b"/hotspots/continuous" in r.body

    def test_flame_view(self, server):
        ep = str(server.listen_endpoint())
        r = http_fetch(ep, path="/hotspots/flame?seconds=0.3", timeout=10)
        assert r.status == 200
        assert b"samples over" in r.body
        assert b'class="f"' in r.body  # nested frame divs rendered

    def test_pprof_endpoints(self, server):
        ep = str(server.listen_endpoint())
        stub = Stub(Channel(ChannelOptions()).init(ep), Echo.DESCRIPTOR)
        for _ in range(10):
            stub.Echo(echo_pb2.EchoRequest(message="load"))
        r = http_fetch(ep, path="/pprof/profile?seconds=0.2", timeout=10)
        assert r.status == 200
        assert b";" in r.body or b" " in r.body  # collapsed stacks
        r = http_fetch(ep, path="/pprof/profile?seconds=0.2&engine=cprofile",
                       timeout=10)
        assert r.status == 200
        assert b"instruments ONLY the thread" in r.body
        assert b"num_symbols" in http_fetch(ep, path="/pprof/symbol").body
        assert http_fetch(ep, path="/pprof/cmdline").status == 200
        assert http_fetch(ep, path="/pprof/nope").status == 404

    def test_status_vitals_and_prof_vars(self, server):
        ep = str(server.listen_endpoint())
        r = http_fetch(ep, path="/status")
        assert r.status == 200
        for needle in (b"rss_kb:", b"threads:", b"tracemalloc:",
                       b"continuous_profiler:", b"/hotspots/cpu"):
            assert needle in r.body, needle
        from brpc_tpu_torch.metrics.variable import get_exposed
        from brpc_tpu_torch.profiling import sampler as _sampler

        # earlier tests may clear_registry(); re-expose the import-time
        # Adders so the /vars contract stays checkable
        for name in ("g_prof_samples", "g_prof_dropped",
                     "g_prof_overruns"):
            if get_exposed(name) is None:
                getattr(_sampler, name).expose_as(name)
        r = http_fetch(ep, path="/vars")
        assert b"g_prof_samples" in r.body
        assert b"g_prof_dropped" in r.body
        assert b"g_prof_overruns" in r.body

    def test_vlog_list_and_set(self, server):
        ep = str(server.listen_endpoint())
        r = http_fetch(ep, path="/vlog")
        assert r.status == 200 and b"loggers" in r.body
        r = http_fetch(ep, path="/vlog?logger=brpc_tpu_torch.test&level=DEBUG")
        assert b"DEBUG" in r.body
        assert logging.getLogger("brpc_tpu_torch.test").level == logging.DEBUG
        r = http_fetch(ep, path="/vlog?logger=brpc_tpu_torch.test&level=BOGUS")
        assert r.status == 400


# ----------------------------------------------- the differ against the JAX's
@pytest.mark.parametrize("mode", ["self", "total"])
def test_diff_equals_the_jax_differ_on_seeded_profiles(mode):
    import numpy as np

    from brpc_tpu.profiling import diff as jax_diff
    from brpc_tpu_torch.profiling import diff as d

    rng = np.random.default_rng(7 if mode == "self" else 8)
    frames = [f"m{i}.py:f{i}" for i in range(12)]

    def folded():
        lines = []
        for _ in range(int(rng.integers(1, 15))):
            depth = int(rng.integers(1, 5))
            stack = ";".join(rng.choice(frames, size=depth))
            lines.append(f"role=w;phase=-;{stack} {int(rng.integers(1, 90))}")
        return "\n".join(lines) + "\n"

    for _ in range(40):
        base, new = folded(), folded()
        kw = dict(top=int(rng.integers(1, 10)),
                  min_delta_pct=float(rng.choice([0.0, 0.5, 5.0])),
                  mode=mode)
        rep = d.diff_folded(base, new, **kw)
        assert rep == jax_diff.diff_folded(base, new, **kw)
        assert d.render_text(rep) == jax_diff.render_text(rep)

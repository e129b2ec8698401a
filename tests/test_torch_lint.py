"""The port's tpulint (brpc_tpu_torch/analysis) mirroring
``tests/test_lint.py``: every one of the 17 rules fires on a bad fixture,
stays quiet on the matching good one and honors suppression comments,
plus the meta-test that keeps the port's own tree at zero unsuppressed
findings and the CLI's exit codes.

Four rules read JAX names in the reference and read the PyTorch idiom the
port uses at the same places here: ``version-guard`` (the device-mesh
shim tpu/launch.py, and no JAX name anywhere), ``no-per-token-host-sync``
(``.item()``/``.cpu()``/``.tolist()``/``.numpy()``/
``torch.cuda.synchronize()``/``np.asarray`` in a loop),
``no-per-op-step-dispatch`` (``.to(device)``/``.cuda()`` and
``store.copy`` without ``transient=True`` in a loop) and
``draft-no-device-sync`` (no torch import or device call in the draft
lane). The other thirteen rules take the reference's fixtures as they
are, and each rule list equals the reference's.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from brpc_tpu_torch.analysis import list_rules, run_lint

REPO = Path(__file__).resolve().parent.parent

EXPECTED_RULES = {
    "no-blocking-in-poller", "acquire-release", "monotonic-clock",
    "lock-order", "version-guard", "metric-flag-hygiene", "bounded-spin",
    "named-thread", "cross-process-ownership", "metric-churn",
    "no-per-token-host-sync", "no-per-op-step-dispatch",
    "cow-before-write", "quiesce-before-migrate",
    "draft-no-device-sync", "shed-before-queue", "budget-gated-scrape",
}


def _lint(tmp_path, files, rules=None):
    """Write {relpath: source} fixtures under tmp_path and lint the dir."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return run_lint(str(tmp_path), rules=rules)


def _rules_hit(result):
    return {f.rule for f in result.findings}


# ---------------------------------------------------------------- registry
def test_all_rules_registered():
    assert {n for n, _ in list_rules()} == EXPECTED_RULES


def test_unknown_rule_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown lint rule"):
        run_lint(str(tmp_path), rules=["no-such-rule"])


def test_syntax_error_surfaces_as_finding(tmp_path):
    res = _lint(tmp_path, {"broken.py": "def f(:\n"})
    assert [f.rule for f in res.findings] == ["parse-error"]


# ------------------------------------------------- no-blocking-in-poller
class TestNoBlockingInPoller:
    def test_sleep_in_dispatcher_module_fires(self, tmp_path):
        res = _lint(tmp_path, {"rpc/event_dispatcher.py": """\
            import time
            def run_once(self):
                time.sleep(0.1)
            """}, rules=["no-blocking-in-poller"])
        assert len(res.findings) == 1
        assert res.findings[0].line == 3

    def test_untimed_acquire_in_cut_loop_fires(self, tmp_path):
        res = _lint(tmp_path, {"rpc/input_messenger.py": """\
            def cut(self):
                self._lock.acquire()
            """}, rules=["no-blocking-in-poller"])
        assert "no-blocking-in-poller" in _rules_hit(res)

    def test_timed_and_nonblocking_acquire_pass(self, tmp_path):
        res = _lint(tmp_path, {"rpc/input_messenger.py": """\
            def cut(self):
                self._lock.acquire(timeout=1.0)
                self._lock.acquire(blocking=False)
                self._cond.wait(0.5)
            """}, rules=["no-blocking-in-poller"])
        assert res.clean

    def test_same_code_outside_poller_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/server.py": """\
            import time
            def accept_loop(self):
                time.sleep(0.1)
                self._lock.acquire()
            """}, rules=["no-blocking-in-poller"])
        assert res.clean

    def test_poller_context_marker_extends_scope(self, tmp_path):
        res = _lint(tmp_path, {"anywhere.py": """\
            from brpc_tpu_torch.analysis.markers import poller_context
            @poller_context
            def on_data(self, body):
                self._lock.acquire()
            """}, rules=["no-blocking-in-poller"])
        assert len(res.findings) == 1
        assert res.findings[0].line == 4

    def test_suppression_comment_silences(self, tmp_path):
        res = _lint(tmp_path, {"rpc/event_dispatcher.py": """\
            import time
            def run_once(self):
                time.sleep(0.1)  # tpulint: disable=no-blocking-in-poller
            """}, rules=["no-blocking-in-poller"])
        assert res.clean and len(res.suppressed) == 1


# --------------------------------------------------------- acquire-release
class TestAcquireRelease:
    def test_bare_acquire_fires(self, tmp_path):
        res = _lint(tmp_path, {"tpu/transport.py": """\
            def send(self, win):
                got = win.acquire(4)
                self.post(got)
            """}, rules=["acquire-release"])
        assert len(res.findings) == 1
        assert "release" in res.findings[0].message

    def test_release_in_except_passes(self, tmp_path):
        res = _lint(tmp_path, {"tpu/transport.py": """\
            def send(self, win):
                got = win.acquire(4)
                try:
                    self.post(got)
                except BaseException:
                    win.release(got)
                    raise
            """}, rules=["acquire-release"])
        assert res.clean

    def test_release_in_finally_passes(self, tmp_path):
        res = _lint(tmp_path, {"butil/iobuf.py": """\
            def borrow(self, pool):
                pool.add_export()
                try:
                    self.use(pool)
                finally:
                    pool.drop_export()
            """}, rules=["acquire-release"])
        assert res.clean

    def test_release_hook_kwarg_passes(self, tmp_path):
        res = _lint(tmp_path, {"tpu/transport.py": """\
            def on_data(self, pool, view):
                pool.add_export()
                self.buf.append_user_data(view, release=self._hook)
            """}, rules=["acquire-release"])
        assert res.clean

    def test_wrapper_forwarding_ownership_passes(self, tmp_path):
        # a method NAMED acquire forwards ownership to its caller
        res = _lint(tmp_path, {"tpu/transport.py": """\
            def acquire(self, n):
                return self._inner.acquire(n)
            """}, rules=["acquire-release"])
        assert res.clean

    def test_out_of_scope_module_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/stream.py": """\
            def f(self, win):
                got = win.acquire(4)
            """}, rules=["acquire-release"])
        assert res.clean


# --------------------------------------------------------- monotonic-clock
class TestMonotonicClock:
    def test_wall_clock_in_trace_fires(self, tmp_path):
        res = _lint(tmp_path, {"trace/span.py": """\
            import time
            def stamp(self):
                self.t = time.time()
            """}, rules=["monotonic-clock"])
        assert len(res.findings) == 1

    def test_wall_clock_in_transport_fires(self, tmp_path):
        res = _lint(tmp_path, {"tpu/transport.py": """\
            import time as _time
            def stamp(self):
                return _time.time()
            """}, rules=["monotonic-clock"])
        assert len(res.findings) == 1

    def test_monotonic_passes(self, tmp_path):
        res = _lint(tmp_path, {"trace/span.py": """\
            import time
            def stamp(self):
                self.t = time.monotonic()
                self.n = time.perf_counter_ns()
            """}, rules=["monotonic-clock"])
        assert res.clean

    def test_wall_clock_outside_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"policy/auth.py": """\
            import time
            def now(self):
                return time.time()
            """}, rules=["monotonic-clock"])
        assert res.clean

    def test_suppression_on_comment_line_above(self, tmp_path):
        res = _lint(tmp_path, {"trace/span.py": """\
            import time
            def stamp(self):
                # display-only wall clock
                # tpulint: disable=monotonic-clock
                self.t = time.time()
            """}, rules=["monotonic-clock"])
        assert res.clean and len(res.suppressed) == 1


# -------------------------------------------------------------- lock-order
class TestLockOrder:
    def test_opposite_nesting_orders_fire(self, tmp_path):
        res = _lint(tmp_path, {"rpc/thing.py": """\
            class Thing:
                def f(self):
                    with self._a_lock:
                        with self._b_lock:
                            pass
                def g(self):
                    with self._b_lock:
                        with self._a_lock:
                            pass
            """}, rules=["lock-order"])
        assert len(res.findings) == 1
        assert "cycle" in res.findings[0].message

    def test_consistent_order_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/thing.py": """\
            class Thing:
                def f(self):
                    with self._a_lock:
                        with self._b_lock:
                            pass
                def g(self):
                    with self._a_lock:
                        with self._b_lock:
                            pass
            """}, rules=["lock-order"])
        assert res.clean

    def test_cycle_through_method_call_fires(self, tmp_path):
        # f holds a_lock while calling h (which takes b_lock);
        # g nests b_lock -> a_lock: cycle via one-level propagation
        res = _lint(tmp_path, {"tpu/thing.py": """\
            class Thing:
                def f(self):
                    with self._a_lock:
                        self.h()
                def h(self):
                    with self._b_lock:
                        pass
                def g(self):
                    with self._b_lock:
                        with self._a_lock:
                            pass
            """}, rules=["lock-order"])
        assert "lock-order" in _rules_hit(res)

    def test_sequential_acquisition_passes(self, tmp_path):
        res = _lint(tmp_path, {"tpu/thing.py": """\
            class Thing:
                def f(self):
                    with self._a_lock:
                        pass
                    with self._b_lock:
                        pass
                def g(self):
                    with self._b_lock:
                        pass
                    with self._a_lock:
                        pass
            """}, rules=["lock-order"])
        assert res.clean

    def test_outside_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"metrics/thing.py": """\
            class Thing:
                def f(self):
                    with self._a_lock:
                        with self._b_lock:
                            pass
                def g(self):
                    with self._b_lock:
                        with self._a_lock:
                            pass
            """}, rules=["lock-order"])
        assert res.clean


# ------------------------------------------------------------ version-guard
class TestVersionGuard:
    RULE = ["version-guard"]

    def test_jax_import_fires_anywhere(self, tmp_path):
        res = _lint(tmp_path, {"tpu/ring.py": "import jax\n",
                               "serving/model.py":
                                   "from jax import numpy as jnp\n"},
                    rules=self.RULE)
        assert sorted(f.rel for f in res.findings) == [
            "serving/model.py", "tpu/ring.py"]
        assert all("no JAX" in f.message for f in res.findings)

    def test_reference_package_import_fires(self, tmp_path):
        res = _lint(tmp_path, {"rpc/x.py": """\
            from brpc_tpu.rpc import errors
            import brpc_tpu.fleet.merge
            """}, rules=self.RULE)
        assert [f.line for f in res.findings] == [1, 2]

    def test_jax_names_fire(self, tmp_path):
        res = _lint(tmp_path, {"tpu/mesh.py": """\
            from somewhere import shard_map
            def f(fn, lax, mesh):
                g = shard_map(fn, mesh=mesh, check_vma=False)
                return lax.pvary(g, "sp")
            """}, rules=self.RULE)
        assert len(res.findings) == 3

    def test_device_mesh_outside_the_shim_fires(self, tmp_path):
        res = _lint(tmp_path, {"tpu/mesh.py": """\
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed import device_mesh
            def build(dist, axes):
                return dist.init_device_mesh("cpu", axes)
            """}, rules=self.RULE)
        assert [f.line for f in res.findings] == [1, 2, 4]
        assert "tpu/launch.py" in res.findings[0].message

    def test_shim_module_exempt(self, tmp_path):
        res = _lint(tmp_path, {"tpu/launch.py": """\
            from torch.distributed.device_mesh import init_device_mesh
            def build(axes):
                return init_device_mesh("cpu", axes)
            """}, rules=self.RULE)
        assert res.clean

    def test_jax_stays_forbidden_in_the_shim(self, tmp_path):
        res = _lint(tmp_path, {"tpu/launch.py": "import jaxlib\n"},
                    rules=self.RULE)
        assert not res.clean

    def test_plain_torch_usage_passes(self, tmp_path):
        res = _lint(tmp_path, {"tpu/ring.py": """\
            import torch
            import torch.distributed as dist
            def f(x, group):
                dist.all_reduce(x, group=group)
                return torch.softmax(x, -1)
            """}, rules=self.RULE)
        assert res.clean

    def test_suppression_honored(self, tmp_path):
        res = _lint(tmp_path, {"tpu/ring.py":
                               "import jax  # tpulint: disable=version-guard\n"},
                    rules=self.RULE)
        assert res.clean and len(res.suppressed) == 1


# ---------------------------------------------------- metric-flag-hygiene
class TestMetricFlagHygiene:
    def test_unnamed_g_metric_fires(self, tmp_path):
        res = _lint(tmp_path, {"mod.py": """\
            from brpc_tpu_torch.metrics.reducer import Adder
            g_orphan = Adder()
            """}, rules=["metric-flag-hygiene"])
        assert len(res.findings) == 1
        assert "never exposed" in res.findings[0].message

    def test_mismatched_registration_fires(self, tmp_path):
        res = _lint(tmp_path, {"mod.py": """\
            from brpc_tpu_torch.metrics.reducer import Adder
            g_reads = Adder("g_writes")
            """}, rules=["metric-flag-hygiene"])
        assert len(res.findings) == 1
        assert "mismatched" in res.findings[0].message

    def test_duplicate_exposure_fires(self, tmp_path):
        res = _lint(tmp_path, {
            "a.py": 'from m import Adder\ng_dup = Adder("g_dup")\n',
            "b.py": 'from m import Adder\ng_dup = Adder("g_dup")\n',
        }, rules=["metric-flag-hygiene"])
        assert len(res.findings) == 1
        assert "more than once" in res.findings[0].message

    def test_undeclared_flag_read_fires(self, tmp_path):
        res = _lint(tmp_path, {"mod.py": """\
            from brpc_tpu_torch import flags
            def f():
                return flags.get("never_defined_anywhere")
            """}, rules=["metric-flag-hygiene"])
        assert len(res.findings) == 1
        assert "FlagError" in res.findings[0].message

    def test_clean_registration_passes(self, tmp_path):
        res = _lint(tmp_path, {"mod.py": """\
            from brpc_tpu_torch import flags
            from brpc_tpu_torch.metrics.reducer import Adder
            from brpc_tpu_torch.metrics.status import PassiveStatus
            g_named = Adder("g_named")
            g_passive = PassiveStatus(lambda: 1).expose("g_passive")
            flags.define("my_knob", 3, "a knob")
            def f():
                return flags.get("my_knob")
            """}, rules=["metric-flag-hygiene"])
        assert res.clean


# ------------------------------------------------------------ bounded-spin
class TestBoundedSpin:
    def test_pure_busy_wait_fires(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            def wait_ready(self):
                while not self._ready:
                    pass
            """}, rules=["bounded-spin"])
        assert len(res.findings) == 1
        assert res.findings[0].line == 2

    def test_spin_budget_reference_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            def wait_ready(self, spin):
                while not self._ready:
                    if not spin.spin():
                        break
            """}, rules=["bounded-spin"])
        assert res.clean

    def test_park_in_body_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            import time
            def wait_ready(self):
                while not self._ready:
                    time.sleep(0.001)
            """}, rules=["bounded-spin"])
        assert res.clean

    def test_consuming_call_in_condition_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            import os
            def drain(self, fd):
                while os.read(fd, 4096):
                    pass
            """}, rules=["bounded-spin"])
        assert res.clean

    def test_progress_on_condition_variable_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            def count(self, n):
                while n > 0:
                    n -= 1
            """}, rules=["bounded-spin"])
        assert res.clean

    def test_mutating_receiver_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            def drain(self, q):
                while q:
                    q.popleft()
            """}, rules=["bounded-spin"])
        assert res.clean

    def test_break_in_body_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            def probe(self):
                while True:
                    if self._ready:
                        break
            """}, rules=["bounded-spin"])
        assert res.clean


# ------------------------------------------------------------ named-thread
class TestNamedThread:
    def test_anonymous_thread_fires(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            import threading
            def spawn(self):
                t = threading.Thread(target=self._run, daemon=True)
                t.start()
            """}, rules=["named-thread"])
        assert len(res.findings) == 1
        assert res.findings[0].line == 3
        assert "name=" in res.findings[0].message

    def test_bare_import_fires(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            from threading import Thread
            def spawn(self):
                Thread(target=self._run).start()
            """}, rules=["named-thread"])
        assert len(res.findings) == 1

    def test_named_thread_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            import threading
            def spawn(self):
                threading.Thread(target=self._run, name="rpc-healer",
                                 daemon=True).start()
            """}, rules=["named-thread"])
        assert res.clean

    def test_kwargs_splat_passes(self, tmp_path):
        # **kw may carry name= — can't prove absence statically
        res = _lint(tmp_path, {"rpc/foo.py": """\
            import threading
            def spawn(self, **kw):
                threading.Thread(target=self._run, **kw).start()
            """}, rules=["named-thread"])
        assert res.clean

    def test_unrelated_thread_class_passes(self, tmp_path):
        # a local class merely NAMED Thread is not threading.Thread
        res = _lint(tmp_path, {"rpc/foo.py": """\
            class Thread:
                pass
            def f():
                return Thread()
            """}, rules=["named-thread"])
        assert res.clean

    def test_suppression_comment_silences(self, tmp_path):
        res = _lint(tmp_path, {"rpc/foo.py": """\
            import threading
            def spawn(self):
                # tpulint: disable=named-thread
                threading.Thread(target=self._run).start()
            """}, rules=["named-thread"])
        assert res.clean and len(res.suppressed) == 1


# ------------------------------------------------- budget-gated-scrape
class TestBudgetGatedScrape:
    RULE = ["budget-gated-scrape"]

    def test_unbudgeted_sleep_loop_fires(self, tmp_path):
        res = _lint(tmp_path, {"fleet/observer.py": """\
            import time
            def run(self):
                while not self._stop.is_set():
                    self.scrape_once()
                    time.sleep(2.0)
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["budget-gated-scrape"]
        assert res.findings[0].line == 3
        assert "ask_to_be_sampled" in res.findings[0].message
        assert "flags.get" in res.findings[0].message

    def test_flag_read_without_budget_still_fires(self, tmp_path):
        res = _lint(tmp_path, {"fleet/observer.py": """\
            def run(self):
                while not self._stop.is_set():
                    self.scrape_once()
                    self._stop.wait(_flags.get("fleet_scrape_interval_s"))
            """}, rules=self.RULE)
        assert len(res.findings) == 1
        assert "ask_to_be_sampled" in res.findings[0].message
        assert "flags.get" not in res.findings[0].message

    def test_budget_without_flag_still_fires(self, tmp_path):
        res = _lint(tmp_path, {"fleet/observer.py": """\
            def run(self):
                while not self._stop.is_set():
                    if global_collector().ask_to_be_sampled():
                        self.scrape_once()
                    self._stop.wait(2.0)
            """}, rules=self.RULE)
        assert len(res.findings) == 1
        assert "flags.get" in res.findings[0].message

    def test_both_legs_pass(self, tmp_path):
        # the canonical observer loop: reloadable interval + budget draw
        res = _lint(tmp_path, {"fleet/observer.py": """\
            def run(self):
                while not self._stop.is_set():
                    if global_collector().ask_to_be_sampled():
                        self.scrape_once()
                    self._stop.wait(_flags.get("fleet_scrape_interval_s"))
            """}, rules=self.RULE)
        assert res.clean

    def test_wait_in_loop_condition_counts_as_periodic(self, tmp_path):
        res = _lint(tmp_path, {"fleet/poller.py": """\
            def run(self):
                while not self._stop.wait(1.0):
                    self.scrape_once()
            """}, rules=self.RULE)
        assert not res.clean

    def test_non_periodic_fleet_code_passes(self, tmp_path):
        res = _lint(tmp_path, {"fleet/merge.py": """\
            def merge(values):
                total = 0.0
                for v in values:
                    total += v
                return total
            """}, rules=self.RULE)
        assert res.clean

    def test_same_loop_outside_fleet_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"shard/worker.py": """\
            import time
            def run(self):
                while True:
                    self.pump()
                    time.sleep(0.5)
            """}, rules=self.RULE)
        assert res.clean

    def test_suppression_comment(self, tmp_path):
        res = _lint(tmp_path, {"fleet/observer.py": """\
            import time
            def run(self):
                while True:  # tpulint: disable=budget-gated-scrape
                    self.scrape_once()
                    time.sleep(2.0)
            """}, rules=self.RULE)
        assert res.clean and len(res.suppressed) == 1


# ------------------------------------------------------------- suppression
def test_disable_all_wildcard(tmp_path):
    res = _lint(tmp_path, {"trace/span.py": """\
        import time
        def stamp(self):
            self.t = time.time()  # tpulint: disable=all
        """})
    assert res.clean and res.suppressed


# ---------------------------------------------------------------- meta-test
def test_repo_tree_has_zero_unsuppressed_findings():
    """The port's own tree is clean: every suppression in it is a
    deliberate, commented exception."""
    res = run_lint(str(REPO / "brpc_tpu_torch"))
    assert res.clean, "\n" + "\n".join(f.format() for f in res.findings)
    for f in res.suppressed:
        src = (REPO / "brpc_tpu_torch" / f.rel).read_text().splitlines()
        above = src[f.line - 2].strip()
        assert above.startswith("#") and "tpulint" not in above, (
            f"{f.format()}: a suppression carries its reason on the "
            f"comment line above it")


def _cli(*args, env_extra=None):
    env = dict(PYTHONPATH=str(REPO), PATH="/usr/bin:/bin")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=120)


def test_cli_exit_codes(tmp_path):
    clean = _cli()
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 finding(s)" in clean.stderr
    clean = _cli(str(REPO / "brpc_tpu_torch"), "--format", "json")
    assert clean.returncode == 0
    assert json.loads(clean.stdout)["findings"] == []

    bad = tmp_path / "trace" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\nt = time.time()\n")
    dirty = _cli(str(tmp_path))
    assert dirty.returncode == 1
    assert "[monotonic-clock]" in dirty.stdout
    assert _cli("--rule", "no-such-rule", str(tmp_path)).returncode == 2


def test_cli_list_rules():
    out = _cli("--list-rules")
    assert out.returncode == 0
    for rule in EXPECTED_RULES:
        assert rule in out.stdout


def test_rule_names_equal_the_references():
    from brpc_tpu.analysis import list_rules as jax_rules

    assert [n for n, _ in list_rules()] == [n for n, _ in jax_rules()]


class TestCrossProcessOwnership:
    RULE = ["cross-process-ownership"]

    def test_pickle_import_flagged(self, tmp_path):
        res = _lint(tmp_path, {"shard/bad.py": """\
            import pickle
            def ship(ring, obj):
                ring.push(1, pickle.dumps(obj))
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["cross-process-ownership"]

    def test_from_pickle_import_flagged(self, tmp_path):
        res = _lint(tmp_path, {"shard/bad.py": """\
            from pickle import dumps
            """}, rules=self.RULE)
        assert not res.clean

    def test_mp_queue_import_flagged(self, tmp_path):
        res = _lint(tmp_path, {"shard/bad.py": """\
            from multiprocessing import Queue
            """}, rules=self.RULE)
        assert not res.clean
        assert "flat bytes" in res.findings[0].message

    def test_mp_queue_call_flagged(self, tmp_path):
        res = _lint(tmp_path, {"shard/bad.py": """\
            import multiprocessing
            def mk():
                return multiprocessing.Queue()
            """}, rules=self.RULE)
        assert not res.clean

    def test_tainted_iobuf_to_push_flagged(self, tmp_path):
        res = _lint(tmp_path, {"shard/bad.py": """\
            from brpc_tpu_torch.butil.iobuf import IOBuf
            def ship(ring, data):
                packet = IOBuf(data)
                ring.push(3, packet)
            """}, rules=self.RULE)
        assert not res.clean
        assert "packet" in res.findings[0].message

    def test_owned_attr_to_send_flagged(self, tmp_path):
        res = _lint(tmp_path, {"shard/bad.py": """\
            def ship(conn, sock):
                buf = sock.read_buf
                conn.send(buf)
            """}, rules=self.RULE)
        assert not res.clean

    def test_shared_memory_import_allowed(self, tmp_path):
        res = _lint(tmp_path, {"shard/ok.py": """\
            from multiprocessing import shared_memory, resource_tracker
            def attach(name):
                seg = shared_memory.SharedMemory(name=name)
                resource_tracker.unregister("/" + name, "shared_memory")
                return seg
            """}, rules=self.RULE)
        assert res.clean

    def test_handles_and_indices_pass(self, tmp_path):
        res = _lint(tmp_path, {"shard/ok.py": """\
            import struct
            def ship(ring, name, indices, total):
                body = struct.pack("!I", total) + name.encode()
                ring.push(7, body)
                ring.push(8, struct.pack(f"!{len(indices)}I", *indices))
            """}, rules=self.RULE)
        assert res.clean

    def test_outside_shard_scope_ignored(self, tmp_path):
        # the contract binds shard/ only; transport may pickle for dumps
        res = _lint(tmp_path, {"tpu/other.py": """\
            import pickle
            """}, rules=self.RULE)
        assert res.clean


# --------------------------------------------------------- metric-churn
class TestMetricChurn:
    RULE = ["metric-churn"]

    def test_adder_in_dispatch_function_fires(self, tmp_path):
        res = _lint(tmp_path, {"rpc/server_processing.py": """\
            from brpc_tpu_torch.metrics.reducer import Adder
            def process_rpc_request(server, sock, msg):
                errors = Adder("g_oops_per_request")
                errors.put(1)
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["metric-churn"]
        assert "Adder" in res.findings[0].message

    def test_latency_recorder_in_transport_method_fires(self, tmp_path):
        res = _lint(tmp_path, {"tpu/transport.py": """\
            from brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
            class TpuEndpoint:
                def on_data(self, frame):
                    rec = LatencyRecorder()
                    rec.record(1)
            """}, rules=self.RULE)
        assert not res.clean
        assert "TpuEndpoint.on_data" in res.findings[0].message

    def test_expose_in_batch_function_fires(self, tmp_path):
        res = _lint(tmp_path, {"batch/runtime.py": """\
            def flush(self, batch):
                self._qps_var.expose("g_batch_qps")
            """}, rules=self.RULE)
        assert not res.clean
        assert "expose" in res.findings[0].message

    def test_window_in_worker_loop_fires(self, tmp_path):
        res = _lint(tmp_path, {"shard/worker.py": """\
            from brpc_tpu_torch.metrics.window import Window
            def run(self):
                while True:
                    w = Window(self._adder, 10)
            """}, rules=self.RULE)
        assert not res.clean

    def test_module_level_construction_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/server_processing.py": """\
            from brpc_tpu_torch.metrics.reducer import Adder
            g_requests = Adder("g_requests")
            def process_rpc_request(server, sock, msg):
                g_requests.put(1)
            """}, rules=self.RULE)
        assert res.clean

    def test_same_code_outside_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/server.py": """\
            from brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
            def on_response(self):
                rec = LatencyRecorder()
            """}, rules=self.RULE)
        assert res.clean

    def test_suppression_honored(self, tmp_path):
        res = _lint(tmp_path, {"rpc/event_dispatcher.py": """\
            from brpc_tpu_torch.metrics.reducer import Adder
            def __init__(self):
                self.n = Adder()  # tpulint: disable=metric-churn
            """}, rules=self.RULE)
        assert res.clean
        assert len(res.suppressed) == 1


class TestNoPerTokenHostSync:
    RULE = ["no-per-token-host-sync"]

    def test_item_in_decode_loop_fires(self, tmp_path):
        res = _lint(tmp_path, {"serving/engine.py": """\
            def step(self, batch):
                for seq in batch:
                    tok = self.model.decode_one(seq)
                    seq.append(tok.item())
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["no-per-token-host-sync"]
        assert res.findings[0].line == 4

    @pytest.mark.parametrize("call", ["nxt.cpu()", "nxt.tolist()",
                                      "nxt.numpy()", "logits[0].item()",
                                      "torch.cuda.synchronize()"])
    def test_each_torch_sync_in_while_fires(self, tmp_path, call):
        res = _lint(tmp_path, {"serving/model.py": f"""\
            import torch
            def generate(self, seq):
                while not seq.done:
                    nxt = self._decode(seq)
                    {call}
            """}, rules=self.RULE)
        assert len(res.findings) == 1, call
        assert res.findings[0].line == 5

    def test_asarray_in_loop_fires(self, tmp_path):
        res = _lint(tmp_path, {"serving/engine.py": """\
            import numpy as np
            def drain(self, seqs):
                for s in seqs:
                    b = np.asarray(s.next_token)
            """}, rules=self.RULE)
        assert len(res.findings) == 1

    def test_one_sync_per_step_outside_loop_passes(self, tmp_path):
        # the engine's own discipline: build host inputs in the loop,
        # ONE materialization after the fused call
        res = _lint(tmp_path, {"serving/model.py": """\
            import numpy as np
            def decode_step(self, tokens, tables):
                slot_tables = np.zeros((8, 64))
                for i, t in enumerate(tables):
                    slot_tables[i] = self._slots_for(t)
                nxt = self._fn(tokens, slot_tables)
                return nxt.cpu().numpy()
            """}, rules=self.RULE)
        assert res.clean

    def test_device_side_ops_in_loop_pass(self, tmp_path):
        # tensor construction on the device and a host list's own
        # methods are not syncs
        res = _lint(tmp_path, {"serving/model.py": """\
            import torch
            def stage(self, chunks):
                for c in chunks:
                    x = torch.as_tensor(c, device=self.device)
                    self.push(x.item)
                    self.out.append(len(c))
            """}, rules=self.RULE)
        assert res.clean

    def test_same_code_outside_serving_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"tpu/device_lane.py": """\
            def pump(self, arrs):
                for a in arrs:
                    out = a.cpu()
            """}, rules=self.RULE)
        assert res.clean

    def test_sync_in_nested_def_not_charged_to_loop(self, tmp_path):
        res = _lint(tmp_path, {"serving/engine.py": """\
            def arm(self, seqs):
                for s in seqs:
                    def finish(r, s=s):
                        return r.item()
                    s.on_done = finish
            """}, rules=self.RULE)
        assert res.clean

    def test_nested_loops_report_once(self, tmp_path):
        res = _lint(tmp_path, {"serving/engine.py": """\
            def sweep(self, groups):
                for g in groups:
                    for s in g:
                        v = s.logits.tolist()
            """}, rules=self.RULE)
        assert len(res.findings) == 1

    def test_suppression_honored(self, tmp_path):
        res = _lint(tmp_path, {"serving/debug.py": """\
            def trace_tokens(self, seqs):
                for s in seqs:
                    print(s.tok.item())  # tpulint: disable=no-per-token-host-sync
            """}, rules=self.RULE)
        assert res.clean
        assert len(res.suppressed) == 1


class TestNoPerOpStepDispatch:
    RULE = ["no-per-op-step-dispatch"]

    def test_store_copy_in_loop_fires(self, tmp_path):
        res = _lint(tmp_path, {"serving/engine.py": """\
            def stage(self, handles):
                for h in handles:
                    out = self.store.copy(h)
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["no-per-op-step-dispatch"]
        assert res.findings[0].line == 3
        assert "coalesced" in res.findings[0].message

    def test_transient_copy_in_loop_passes(self, tmp_path):
        res = _lint(tmp_path, {"tpu/device_stream.py": """\
            def pump(self, handle):
                while self.live:
                    ok = self.store.copy(handle, transient=True)
            """}, rules=self.RULE)
        assert res.clean

    def test_stub_copy_rpc_in_loop_fires(self, tmp_path):
        res = _lint(tmp_path, {"serving/bench_lane.py": """\
            def blast(self, stub, req):
                for _ in range(1000):
                    stub.Copy(req)
            """}, rules=self.RULE)
        assert not res.clean
        assert "nbytes=-k" in res.findings[0].message

    @pytest.mark.parametrize("call", [
        "p.to(self.device)", "p.to(device=dev)", "p.cuda()",
        "torch.from_numpy(p).to(dev, non_blocking=True)", "p.to('cuda')"])
    def test_transfer_per_item_fires(self, tmp_path, call):
        res = _lint(tmp_path, {"serving/model.py": f"""\
            import torch
            def load(self, parts, dev):
                for p in parts:
                    self._parts.append({call})
            """}, rules=self.RULE)
        assert len(res.findings) == 1, call
        assert "transfer once" in res.findings[0].message

    @pytest.mark.parametrize("call", [
        "p.to(torch.float32)", "p.to(dtype=torch.bfloat16)",
        "p.to(self.dtype)", "torch.cuda.synchronize()"])
    def test_casts_in_loop_pass(self, tmp_path, call):
        res = _lint(tmp_path, {"serving/model.py": f"""\
            import torch
            def cast(self, parts):
                for p in parts:
                    self._parts.append({call})
            """}, rules=self.RULE)
        assert res.clean, call

    def test_single_dispatch_outside_loop_passes(self, tmp_path):
        res = _lint(tmp_path, {"serving/model.py": """\
            import numpy as np
            import torch
            def decode_step(self, tokens, tables):
                slot_tables = np.zeros((8, 64))
                for i, t in enumerate(tables):
                    slot_tables[i] = self._slots_for(t)
                pools = torch.from_numpy(slot_tables).to(self.device)
                return self.store.copy(self._h)
            """}, rules=self.RULE)
        assert res.clean

    def test_plain_list_copy_in_loop_passes(self, tmp_path):
        res = _lint(tmp_path, {"serving/engine.py": """\
            def snapshot(self, tables):
                out = []
                for t in tables:
                    out.append(t.copy())
                return out
            """}, rules=self.RULE)
        assert res.clean

    def test_same_code_outside_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/replay.py": """\
            def blast(self, stub, req, dev):
                for _ in range(1000):
                    stub.Copy(req)
                    req.to(dev)
            """}, rules=self.RULE)
        assert res.clean

    def test_dispatch_in_nested_def_not_charged_to_loop(self, tmp_path):
        res = _lint(tmp_path, {"serving/bench_lane.py": """\
            def arm(self, stub, reqs):
                for req in reqs:
                    def fire(r=req):
                        stub.Copy(r)
                    self._cbs.append(fire)
            """}, rules=self.RULE)
        assert res.clean

    def test_suppression_honored(self, tmp_path):
        res = _lint(tmp_path, {"serving/debug.py": """\
            def probe(self, handles):
                for h in handles:
                    self.store.copy(h)  # tpulint: disable=no-per-op-step-dispatch
            """}, rules=self.RULE)
        assert res.clean
        assert len(res.suppressed) == 1


# --------------------------------------------------------- cow-before-write
class TestCowBeforeWrite:
    RULE = ["cow-before-write"]

    def test_bare_pool_write_fires(self, tmp_path):
        res = _lint(tmp_path, {"serving/model.py": """\
            def prefill(self, tokens, table):
                kpool, vpool = self._fn(tokens, table)
                self.kv.update_pools(kpool, vpool)
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["cow-before-write"]
        assert res.findings[0].line == 3
        assert "cow-split" in res.findings[0].message

    def test_assert_writable_guard_passes(self, tmp_path):
        # the house contract: prove exclusivity before the scatter commits
        res = _lint(tmp_path, {"serving/model.py": """\
            def prefill(self, tokens, table):
                self.kv.assert_writable(table, 0, len(tokens))
                kpool, vpool = self._fn(tokens, table)
                self.kv.update_pools(kpool, vpool)
            """}, rules=self.RULE)
        assert res.clean

    def test_cow_split_call_passes(self, tmp_path):
        res = _lint(tmp_path, {"serving/engine.py": """\
            def step(self, seq, k, v):
                self.kv.cow_block(seq.seq_id, 0)
                self.kv.update_pools(k, v)
            """}, rules=self.RULE)
        assert res.clean

    def test_refcount_eq_one_check_passes(self, tmp_path):
        res = _lint(tmp_path, {"serving/custom_cache.py": """\
            def swap(self, block, k, v):
                if self._ref.get(block, 0) == 1:
                    self.update_pools(k, v)
            """}, rules=self.RULE)
        assert res.clean

    def test_cow_named_function_exempt(self, tmp_path):
        # the split implementations themselves ARE the guard
        res = _lint(tmp_path, {"serving/kv_cache.py": """\
            def _cow_copy_block_device(self, dst, src):
                k = self.k_pool
                self.update_pools(k, k)
            """}, rules=self.RULE)
        assert res.clean

    def test_same_code_outside_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"tpu/device_lane.py": """\
            def stage(self, k, v):
                self.kv.update_pools(k, v)
            """}, rules=self.RULE)
        assert res.clean

    def test_suppression_honored(self, tmp_path):
        res = _lint(tmp_path, {"serving/debug.py": """\
            def poke(self, k, v):
                self.kv.update_pools(k, v)  # tpulint: disable=cow-before-write
            """}, rules=self.RULE)
        assert res.clean
        assert len(res.suppressed) == 1


class TestQuiesceBeforeMigrate:
    RULE = ["quiesce-before-migrate"]

    def test_bare_export_fires(self, tmp_path):
        res = _lint(tmp_path, {"serving/migration.py": """\
            def migrate(self, seq, kv):
                table, ntokens = kv.export_chain(seq.seq_id)
                self._stream(table)
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["quiesce-before-migrate"]
        assert res.findings[0].line == 2
        assert "quiesce" in res.findings[0].message

    def test_quiesce_guard_passes(self, tmp_path):
        # the house contract: audit + mark read-only before the chain
        # leaves the shard
        res = _lint(tmp_path, {"serving/migration.py": """\
            def migrate(self, seq, kv):
                kv.quiesce_sequence(seq.seq_id)
                table, ntokens = kv.export_chain(seq.seq_id)
                self._stream(table)
            """}, rules=self.RULE)
        assert res.clean

    def test_export_named_function_exempt(self, tmp_path):
        # the quiesce/export implementations themselves ARE the contract
        res = _lint(tmp_path, {"serving/kv_cache.py": """\
            def export_chain(self, seq_id):
                return self.pools[0].export_chain(seq_id)
            """}, rules=self.RULE)
        assert res.clean

    def test_same_code_outside_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"tools/debug_dump.py": """\
            def dump(self, seq, kv):
                return kv.export_chain(seq.seq_id)
            """}, rules=self.RULE)
        assert res.clean

    def test_suppression_honored(self, tmp_path):
        res = _lint(tmp_path, {"serving/debug.py": """\
            def peek(self, seq, kv):
                return kv.export_chain(seq.seq_id)  # tpulint: disable=quiesce-before-migrate
            """}, rules=self.RULE)
        assert res.clean
        assert len(res.suppressed) == 1


class TestDraftNoDeviceSync:
    RULE = ["draft-no-device-sync"]

    @pytest.mark.parametrize("line", ["import torch", "import torch.cuda",
                                      "from torch import nn", "import jax"])
    def test_device_import_fires(self, tmp_path, line):
        res = _lint(tmp_path, {"serving/speculative.py": f"""\
            {line}

            def draft_tokens(history, k):
                return history[-k:]
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["draft-no-device-sync"]
        assert res.findings[0].line == 1
        assert "host-side" in res.findings[0].message

    def test_device_calls_fire(self, tmp_path):
        res = _lint(tmp_path, {"serving/speculative.py": """\
            def draft_tokens(history, k, model, torch):
                t = torch.tensor(history)
                out = model(t.cuda()).to("cpu")
                n = out[0].item()
                return out.numpy()
            """}, rules=self.RULE)
        assert len(res.findings) == 5
        assert "ONE launch" in res.findings[0].message

    def test_host_side_matcher_passes(self, tmp_path):
        # the house drafter: pure Python over committed token history
        res = _lint(tmp_path, {"serving/speculative.py": """\
            def draft_tokens(history, k, ngram_max=3):
                h = [int(t) for t in history]
                for n in range(min(ngram_max, len(h) - 1), 0, -1):
                    tail = h[-n:]
                    for j in range(len(h) - n - 1, -1, -1):
                        if h[j:j + n] == tail:
                            return h[j + n:j + n + k]
                return []
            """}, rules=self.RULE)
        assert res.clean

    def test_same_code_outside_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"serving/model.py": """\
            import torch

            def decode_fn(self, x):
                return x.cuda().item()
            """}, rules=self.RULE)
        assert res.clean

    def test_suppression_honored(self, tmp_path):
        res = _lint(tmp_path, {"serving/speculative.py": """\
            import torch  # tpulint: disable=draft-no-device-sync

            def draft_tokens(history, k):
                return history[-k:]
            """}, rules=self.RULE)
        assert res.clean
        assert len(res.suppressed) == 1


class TestShedBeforeQueue:
    RULE = ["shed-before-queue"]

    def test_unchecked_append_fires(self, tmp_path):
        res = _lint(tmp_path, {"serving/engine.py": """\
            def submit(self, seq):
                self._waiting.append(seq)
                self._cv.notify()
            """}, rules=self.RULE)
        assert [f.rule for f in res.findings] == ["shed-before-queue"]
        assert res.findings[0].line == 2
        assert "admission" in res.findings[0].message

    def test_tenant_lane_append_fires(self, tmp_path):
        # the per-tenant lanes are waiting queues too — a scheduler
        # helper that grows one without re-checking is the same bug
        res = _lint(tmp_path, {"serving/qos.py": """\
            def requeue(self, t, seq):
                t.waiting.append(seq)
            """}, rules=self.RULE)
        assert not res.clean

    def test_admission_check_guard_passes(self, tmp_path):
        res = _lint(tmp_path, {"serving/qos.py": """\
            def enqueue(self, seq):
                code = self.admission_check(seq.tenant_id, seq.priority)
                if code != 0:
                    return code
                t = self.tenant(seq.tenant_id)
                t.waiting.append(seq)
                return 0
            """}, rules=self.RULE)
        assert res.clean

    def test_can_admit_guard_passes(self, tmp_path):
        # the pre-QoS watermark check also satisfies the contract: the
        # append is still behind an admission predicate
        res = _lint(tmp_path, {"serving/engine.py": """\
            def submit(self, seq, need):
                if not self.kv.can_admit(need):
                    return 1
                self._waiting.append(seq)
                return 0
            """}, rules=self.RULE)
        assert res.clean

    def test_other_queues_exempt(self, tmp_path):
        # only the waiting lanes are admission-gated; adoption/pending
        # lists have their own ownership contracts
        res = _lint(tmp_path, {"serving/engine.py": """\
            def adopt(self, seq):
                self._adopted_pending.append(seq)
            """}, rules=self.RULE)
        assert res.clean

    def test_same_code_outside_scope_passes(self, tmp_path):
        res = _lint(tmp_path, {"rpc/stream.py": """\
            def push(self, frame):
                self._waiting.append(frame)
            """}, rules=self.RULE)
        assert res.clean

    def test_suppression_honored(self, tmp_path):
        res = _lint(tmp_path, {"serving/debug.py": """\
            def inject(self, seq):
                self._waiting.append(seq)  # tpulint: disable=shed-before-queue
            """}, rules=self.RULE)
        assert res.clean
        assert len(res.suppressed) == 1

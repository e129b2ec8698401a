"""The operator tools of the port (``brpc_tpu_torch/tools/``: trace_view,
vars_view, flame_view, prof_diff, trace_diff, chaos_run, tpulint) against
the JAX package's ``tools/`` of the same names.

Each tool is given the same numpy-seeded input files and arguments as
the reference tool and must print the same lines, write the same SVG
bytes or JSON, and exit with the same code; the reference's own cases
(``tests/test_profiling.py:307-358``, ``tests/test_series.py:588-621``,
``tests/test_fault.py:500-532``) run on the port's tools. The tools that
talk to a server (``--fetch``, chaos_run) do so against a port Server on
127.0.0.1:0. tpulint's rule descriptions name the port's own checks, so
only its rule names are held equal; its findings, JSON and exit codes
are.
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import fault, flags
from brpc_tpu_torch.metrics.series import VarSeries
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.tools import (chaos_run, flame_view, prof_diff,
                                  tpulint, trace_diff, trace_view,
                                  vars_view)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ref(name):
    return importlib.import_module(f"tools.{name}")


def run(fn, *args, stdin=None):
    """fn(*args) -> (its return value or SystemExit code, stdout,
    stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = fn(*args)
            except SystemExit as e:
                rc = e.code
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


def same(name, port_mod, *args, stdin=None, stderr=True):
    """The port tool's main and the reference's on the same arguments:
    equal exit codes and output; returns the port's."""
    got = run(port_mod.main, *args, stdin=stdin)
    want = run(ref(name).main, *args, stdin=stdin)
    assert got[:2] == want[:2]
    if stderr:
        assert got[2] == want[2]
    return got


@pytest.fixture
def echo_server():
    class Echo(rpc.Service):
        DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

        def Echo(self, cntl, request, done):
            return echo_pb2.EchoResponse(message=request.message)

    srv = rpc.Server().add_service(Echo()).start("127.0.0.1:0")
    yield srv
    srv.stop()
    srv.join(timeout=5)
    fault.disarm_all()
    flags.set_flag("fault_injection_enabled", False)


def hostport(srv):
    ep = srv.listen_endpoint()
    return f"{ep.host}:{ep.port}"


# ------------------------------------------------------------- trace_view
PHASES = ("queue_us", "parse_us", "credit_wait_us", "send_us",
          "batch_wait_us", "execute_us", "respond_us")


def rpcz_doc(seed, traces=4):
    """A seeded /rpcz?format=json export: per trace a server span and a
    client span under it, phases, events and an error code now and then."""
    rng = np.random.default_rng(seed)
    spans = []
    for t in range(traces):
        tid = f"{rng.integers(1 << 62):016x}"
        start = float(rng.integers(1_000_000, 2_000_000))
        lat = float(rng.integers(100, 20000))
        server = {"trace_id": tid, "span_id": f"s{t}", "kind": "server",
                  "service": "EchoService", "method": "Echo",
                  "start_us": start, "latency_us": lat,
                  "phases": {p: float(rng.integers(0, lat // 4))
                             for p in PHASES if rng.random() < 0.7},
                  "events": [{"offset_us": float(rng.integers(0, lat)),
                              "name": "note", "k": int(rng.integers(9))}],
                  "error_code": int(rng.choice([0, 0, 1008]))}
        client = {"trace_id": tid, "span_id": f"c{t}", "kind": "client",
                  "parent_span_id": f"s{t}", "service": "Down",
                  "method": "Call", "start_us": start + lat / 8,
                  "latency_us": lat / 2,
                  "phases": {"send_us": lat / 8, "execute_us": lat / 4}}
        spans += [server, client]
    return {"spans": spans}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_view_renders_as_the_reference(seed, tmp_path):
    doc = rpcz_doc(seed)
    path = tmp_path / "rpcz.json"
    path.write_text(json.dumps(doc))
    rc, out, _ = same("trace_view", trace_view, ["trace_view", str(path)])
    assert rc == 0 and out.count("\ntrace ") == 3 and "[note]" in out
    assert same("trace_view", trace_view, ["trace_view", "-"],
                stdin=json.dumps(doc))[1] == out
    # the usage text names the port's commands
    assert same("trace_view", trace_view, ["trace_view"],
                stderr=False)[0] == 2


def test_trace_view_empty_and_fetch(tmp_path, echo_server):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"spans": []}))
    assert same("trace_view", trace_view,
                ["trace_view", str(path)])[1] == "(no spans)\n"
    hp = hostport(echo_server)
    doc = trace_view._fetch(hp)
    assert isinstance(doc["spans"], list)
    assert run(trace_view.main, ["trace_view", "--fetch", hp])[0] == 0
    rc, _, err = run(trace_view.main, ["trace_view", "--fetch"])
    assert rc == 2 and "--fetch" in err
    with pytest.raises(RuntimeError, match="404"):
        trace_view._fetch(hp, "00000000000000ff")


# -------------------------------------------------------------- vars_view
def series(values):
    s = VarSeries()
    for v in values:
        s.append(v)
    return s.to_dict()


def vars_doc(seed):
    rng = np.random.default_rng(seed)
    names = ["g_serving_tokens", "g_serving_steps", "rpc_method_echo_qps",
             "g_latency"]
    doc = {"workers": int(rng.integers(0, 3)), "series": {}, "vars": {}}
    for i, n in enumerate(names):
        vals = ([float(x) for x in rng.random(int(rng.integers(1, 40)))]
                if n == "g_latency"
                else [int(x) for x in np.cumsum(rng.integers(0, 9, 30))])
        doc["series"][n] = series(vals)
        doc["vars"][n] = [["sum", "sum", "max", "wavg_qps"][i], "counter",
                          vals[-1]]
    doc["vars"]["g_latency_qps"] = ["sum", "gauge", float(rng.integers(50))]
    return doc


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("glob,tier", [("*", "second"),
                                       ("g_serving_*", "minute"),
                                       ("nothing*", "second")])
def test_vars_view_renders_as_the_reference(seed, glob, tier, tmp_path):
    doc = vars_doc(seed)
    assert vars_view.render(doc, glob, tier) == ref("vars_view").render(
        doc, glob, tier)
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(doc))
    rc, out, _ = same("vars_view", vars_view,
                      [str(path), "--name", glob, "--tier", tier])
    assert rc == 0 and out
    assert same("vars_view", vars_view, ["-", "--name", glob],
                stdin=json.dumps(doc))[0] == 0


@pytest.mark.parametrize("glob", ["*", "g_latency", "g_serving_*", "zzz"])
def test_vars_view_fleet_merges_as_the_reference(glob):
    docs = {"hosta:1": vars_doc(3), "hostb:2": vars_doc(4),
            "hostc:3": vars_doc(5)}
    assert vars_view.render_fleet(docs, glob, "second") == \
        ref("vars_view").render_fleet(docs, glob, "second")


def test_vars_view_reference_cases():
    """tests/test_series.py:588-660 on the port's tool."""
    doc = {"workers": 2, "series": {"qps_a": series(range(10))}}
    out = vars_view.render(doc, "*", "second")
    assert "qps_a" in out and "workers=2" in out
    assert "min=0" in out and "last=9" in out
    assert any(ch in out for ch in "▁▂▃▄▅▆▇█")
    assert "no vars match" in vars_view.render({"series": {}}, "*", "second")

    def member_doc(values, op="sum", ptype="counter"):
        return {"series": {"g_reqs": series(values)},
                "vars": {"g_reqs": [op, ptype, values[-1]]}}

    out = vars_view.render_fleet({"hosta:1": member_doc([1, 2, 3]),
                                  "hostb:2": member_doc([10, 20, 30])},
                                 "g_reqs", "second")
    assert "hosta:1" in out and "hostb:2" in out and "[sum]" in out
    assert "=merged" in out and "last=33" in out
    mk = lambda v: {"series": {"p99": dict(VarSeries().to_dict(),  # noqa
                                           second=[v], last=v)},
                    "vars": {"p99": ["max", "gauge", v]}}
    out = vars_view.render_fleet({"a:1": mk(900.0), "b:2": mk(100.0)},
                                 "p99", "second")
    assert "[max]" in out and "last=900" in out


def test_vars_view_usage_and_fetch(tmp_path, echo_server):
    assert same("vars_view", vars_view, [], stderr=False)[0] == 2
    assert same("vars_view", vars_view, [str(tmp_path / "x"), "--watch"],
                stderr=False)[0] == 2
    hp = hostport(echo_server)
    doc = vars_view.fetch(hp, "*")
    assert "series" in doc and "vars" in doc
    rc, out, _ = run(vars_view.main, ["--fetch", hp, "--name", "zzz_none"])
    assert (rc, out) == (0, "no vars match\n")
    rc, out, _ = run(vars_view.main, ["--fetch", hp, "--fetch", hp,
                                      "--name", "zzz_none"])
    assert (rc, out) == (0, "no vars match on any member\n")


# ------------------------------------------------------------- flame_view
FOLDED = ("role=w;phase=execute;main.py:run;hot.py:spin 80\n"
          "role=w;phase=-;main.py:run;idle.py:park 20\n")


def folded(seed, n=60):
    """Seeded folded stacks, frames with characters SVG must escape."""
    rng = np.random.default_rng(seed)
    frames = ["main.py:run", "a.py:<lambda>", "b.py:f&g", "c.py:\"q\"",
              "engine.py:_loop", "model.py:decode_step", "x" * 90]
    lines = ["# a comment", "", "not a stack line", "a.py:f notanumber"]
    for _ in range(n):
        depth = int(rng.integers(1, 7))
        st = ";".join(frames[int(i)] for i in rng.integers(0, len(frames),
                                                           depth))
        lines.append(f"{st} {int(rng.integers(1, 500))}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("text", [FOLDED, folded(0), folded(1, 300)])
@pytest.mark.parametrize("args", [[], ["--width", "800", "--min-pct",
                                       "0.5", "--title", "t<1>"]])
def test_flame_view_writes_the_references_svg(text, args, tmp_path):
    src = tmp_path / "p.folded"
    src.write_text(text)
    outs = []
    for name, mod in (("port", flame_view), ("ref", ref("flame_view"))):
        out = tmp_path / f"{name}.svg"
        rc, stdout, _ = run(mod.main, [str(src), "-o", str(out), *args])
        assert rc == 0
        outs.append((stdout.replace(str(out), "OUT"), out.read_bytes()))
    assert outs[0] == outs[1]
    assert outs[0][1].startswith(b"<svg")


def test_flame_view_reference_cases(tmp_path):
    """tests/test_profiling.py:329-358 on the port's tool."""
    counts = flame_view.parse_folded(FOLDED)
    assert sum(counts.values()) == 100
    assert counts == ref("flame_view").parse_folded(FOLDED)
    svg = flame_view.render_svg(counts, width=800, title="t")
    assert svg.startswith("<svg") and "hot.py:spin" in svg
    assert "80 samples" in svg
    assert flame_view._color("hot.py:spin") == \
        ref("flame_view")._color("hot.py:spin")
    src, out = tmp_path / "p.folded", tmp_path / "p.svg"
    src.write_text(FOLDED)
    rc, stdout, _ = run(flame_view.main, [str(src), "-o", str(out)])
    assert rc == 0 and "2 unique stacks, 100 samples" in stdout
    (tmp_path / "empty").write_text("# nothing\n")
    for bad in ("missing", "empty"):
        rc = same("flame_view", flame_view,
                  [str(tmp_path / bad), "-o", str(out)])[0]
        assert rc == 2


# -------------------------------------------------------------- prof_diff
BASE = "role=w;phase=-;a.py:f;b.py:g 90\nrole=w;phase=-;a.py:f;c.py:h 10\n"
NEW = "role=w;phase=-;a.py:f;b.py:g 50\nrole=w;phase=-;a.py:f;c.py:h 50\n"


@pytest.mark.parametrize("args", [
    [], ["--json"], ["--total"], ["--total", "--json"],
    ["--total", "--only-prefix", "phase="], ["--top", "3"],
    ["--min-delta-pct", "0"], ["--fail-above-pct", "10"],
    ["--fail-above-pct", "10", "--json"], ["--fail-above-pct", "90"]])
@pytest.mark.parametrize("pair", ["reference", "seeded"])
def test_prof_diff_reports_as_the_reference(args, pair, tmp_path):
    base, new = tmp_path / "base.folded", tmp_path / "new.folded"
    if pair == "reference":
        base.write_text(BASE)
        new.write_text(NEW)
    else:
        base.write_text(folded(2))
        new.write_text(folded(3))
    rc, out, _ = same("prof_diff", prof_diff, [str(base), str(new), *args])
    assert rc in (0, 1) and out


def test_prof_diff_reference_gate(tmp_path):
    """tests/test_profiling.py:307-327 on the port's tool."""
    base, new = tmp_path / "base.folded", tmp_path / "new.folded"
    base.write_text(BASE)
    new.write_text(NEW)
    assert prof_diff.main([str(base), str(new)]) == 0
    assert run(prof_diff.main, [str(base), str(new), "--fail-above-pct",
                                "10"])[0] == 1
    assert prof_diff.main([str(base), str(new), "--fail-above-pct",
                           "90"]) == 0
    assert same("prof_diff", prof_diff, [str(tmp_path / "missing.folded"),
                                         str(new)])[0] == 2


def test_prof_diff_fetches_a_live_profile(echo_server, tmp_path):
    base = tmp_path / "base.folded"
    base.write_text(BASE)
    rc, out, _ = run(prof_diff.main, [str(base), hostport(echo_server),
                                      "--seconds", "0.2", "--json"])
    assert rc == 0 and "movers" in json.loads(out)


# ------------------------------------------------------------- trace_diff
def span_export(seed, execute_scale=1.0, n=40):
    rng = np.random.default_rng(seed)
    spans = []
    for i in range(n):
        for method in ("Echo", "Other"):
            ex = float(rng.integers(1000, 3000)) * execute_scale
            q = float(rng.integers(10, 500))
            spans.append({"kind": "server", "service": "EchoService",
                          "method": method, "latency_us": ex + q,
                          "phases": {"execute_us": ex, "queue_us": q}})
        spans.append({"kind": "client", "service": "EchoService",
                      "method": "Echo", "latency_us": 10.0,
                      "phases": {"send_us": 10.0}})
    return {"spans": spans}


@pytest.mark.parametrize("args", [
    [], ["--json"], ["--percentile", "50"], ["--threshold", "5"],
    ["--min-delta-us", "0"], ["--min-samples", "100"], ["--kind", ""],
    ["--kind", "client", "--json"], ["--percentile", "0"]])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_trace_diff_reports_as_the_reference(args, scale, tmp_path):
    base, cur = tmp_path / "base.json", tmp_path / "cur.json"
    base.write_text(json.dumps(span_export(0)))
    cur.write_text(json.dumps(span_export(1, scale)))
    rc, out, _ = same("trace_diff", trace_diff,
                      [str(base), str(cur), *args])
    if "--percentile" in args and "0" in args:
        assert rc == 2
    elif scale > 1 and "--threshold" not in args and \
            "--min-samples" not in args and "client" not in args:
        assert rc == 1
    else:
        assert rc in (0, 1)


def test_trace_diff_as_a_command(tmp_path):
    base, cur = tmp_path / "base.json", tmp_path / "cur.json"
    base.write_text(json.dumps(span_export(0)))
    cur.write_text(json.dumps(span_export(1, 4.0)))
    outs = [subprocess.run(cmd + [str(base), str(cur), "--json"],
                           capture_output=True, text=True, timeout=120,
                           cwd=REPO)
            for cmd in ([sys.executable, "-m",
                         "brpc_tpu_torch.tools.trace_diff"],
                        [sys.executable, "tools/trace_diff.py"])]
    assert outs[0].returncode == outs[1].returncode == 1, outs[0].stderr
    assert json.loads(outs[0].stdout) == json.loads(outs[1].stdout)
    assert run(trace_diff.main, [str(base), str(tmp_path / "nope")])[0] == 2
    rc, _, err = run(trace_diff.main, ["--help"])
    assert rc == 0


# -------------------------------------------------------------- chaos_run
def scenario(tmp_path, extra=(), name="scenario.json"):
    steps = [{"op": "flag", "name": "fault_injection_enabled",
              "value": "true"},
             {"op": "arm", "point": "x.scenario", "mode": "always",
              "delay_ms": 1},
             {"op": "sleep", "seconds": 0.01},
             {"op": "expect_fired", "point": "x.scenario", "min": 0},
             *extra]
    path = tmp_path / name
    path.write_text(json.dumps({"steps": steps}))
    return str(path)


def test_chaos_run_scenario_replay_on_a_port_server(echo_server, tmp_path):
    """tests/test_fault.py:500-532 against a port Server."""
    fault.register("x.scenario", "chaos_run e2e target")
    addr = str(echo_server.listen_endpoint())
    path = scenario(tmp_path)
    summary = chaos_run.run_scenario(addr, path)
    assert summary["steps"] == 4
    assert summary == ref("chaos_run").run_scenario(addr, path)
    assert flags.get("fault_injection_enabled") is True
    assert fault.hit("x.scenario") == {"delay_ms": 1}   # really armed
    path = scenario(tmp_path, [{"op": "expect_fired", "point": "x.never",
                                "min": 1}])
    with pytest.raises(chaos_run.ScenarioError, match="x.never"):
        chaos_run.run_scenario(addr, path)
    path = scenario(tmp_path, [{"op": "nonsense"}])
    with pytest.raises(chaos_run.ScenarioError, match="unknown op"):
        chaos_run.run_scenario(addr, path)


def test_chaos_run_main_as_the_reference(echo_server, tmp_path):
    fault.register("x.scenario", "chaos_run e2e target")
    addr = str(echo_server.listen_endpoint())
    ok = scenario(tmp_path, [{"op": "disarm", "point": "x.scenario"},
                             {"op": "disarm_all"}])
    rc, out, _ = same("chaos_run", chaos_run, ["chaos_run", addr, ok])
    assert rc == 0 and out == f"chaos_run: OK (6 steps against {addr})\n"
    bad = scenario(tmp_path, [{"op": "expect_fired", "point": "x.never"}],
                   "bad.json")
    rc, out, err = same("chaos_run", chaos_run, ["chaos_run", addr, bad])
    assert rc == 1 and "FAILED" in err
    assert same("chaos_run", chaos_run, ["chaos_run", addr],
                stderr=False)[0] == 2
    assert same("chaos_run", chaos_run, ["chaos_run", addr, ok,
                                         "--dump-traces"],
                stderr=False)[0] == 2
    dumps = tmp_path / "traces"
    rc, out, _ = run(chaos_run.main, ["chaos_run", addr, ok, "--dump-traces",
                                      str(dumps), "--save-baseline",
                                      str(tmp_path / "base.json")])
    assert rc == 0 and (dumps / "traces.json").exists()
    assert "baseline of" in out
    rc, out, _ = run(chaos_run.main, ["chaos_run", addr, ok,
                                      "--diff-baseline",
                                      str(tmp_path / "base.json")])
    assert rc == 0 and "chaos_run: OK" in out


# ---------------------------------------------------------------- tpulint
@pytest.fixture
def dirty_tree(tmp_path):
    (tmp_path / "trace").mkdir()
    (tmp_path / "trace" / "bad.py").write_text(
        "import time\nt = time.time()\n")
    (tmp_path / "trace" / "quiet.py").write_text(
        "import time\n# the wall clock on purpose\n"
        "t = time.time()  # tpulint: disable=monotonic-clock\n")
    return str(tmp_path)


@pytest.mark.parametrize("args", [
    [], ["--format", "json"], ["--show-suppressed"],
    ["--rule", "monotonic-clock"], ["--rule", "no-such-rule"]])
def test_tpulint_lints_as_the_reference(args, dirty_tree):
    rc, out, err = same("tpulint", tpulint, [*args, dirty_tree])
    assert rc == (2 if "no-such-rule" in args else 1)


def test_tpulint_rules_and_default_path():
    names = [l.split()[0] for l in run(tpulint.main, ["--list-rules"])[1]
             .splitlines()]
    assert names == [l.split()[0] for l in
                     run(ref("tpulint").main, ["--list-rules"])[1]
                     .splitlines()]
    rc, _, err = run(tpulint.main, [])
    assert rc == 0 and "tpulint: 0 finding(s)" in err  # brpc_tpu_torch/
    out = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.tools.tpulint", "--format",
         "json"], capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(PYTHONPATH=REPO, PATH="/usr/bin:/bin"))
    assert out.returncode == 0 and json.loads(out.stdout)["findings"] == []

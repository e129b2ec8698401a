"""The port's ``policy/auth.py`` and ``trace/diff.py`` against the JAX
package's.

Auth: every case of ``tests/test_auth_retry_tools.py::TestAuth`` (shared
secret accepted, wrong or missing secret refused with EAUTH, HTTP, a
custom Authenticator) in all four pairings of {JAX, port} client x {JAX,
port} server on 127.0.0.1:0, and the credential string itself equal to
the reference's at the same second, so either package's client
authenticates to the other's server.

Trace diff: the reference's diff-engine cases on the port, then the same
numpy-seeded span exports and rpc_dump v2 directories (written by each
package's dumper) through both packages' loaders, diff and report: the
regressions and the rendered report are equal; and the port's
``python -m brpc_tpu_torch.trace.diff`` takes ``tools/trace_diff.py``'s
arguments and gives its exit codes and JSON.
"""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import brpc_tpu.policy.auth as jax_auth
import brpc_tpu.rpc as jax_rpc
import brpc_tpu_torch.policy.auth as port_auth
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu.proto import echo_pb2 as jax_echo
from brpc_tpu.trace import diff as jax_diff
from brpc_tpu_torch.proto import echo_pb2 as port_echo
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.trace import diff as port_diff

SIDES = {
    "jax": types.SimpleNamespace(rpc=jax_rpc, pb=jax_echo, auth=jax_auth),
    "port": types.SimpleNamespace(rpc=port_rpc, pb=port_echo,
                                  auth=port_auth),
}
PAIRINGS = [(c, s) for c in ("jax", "port") for s in ("jax", "port")]
IDS = [f"{c}-client-{s}-server" for c, s in PAIRINGS]
TIMEOUT_MS = 10000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _echo_impl(side):
    class EchoServiceImpl(side.rpc.Service):
        DESCRIPTOR = side.pb.DESCRIPTOR.services_by_name["EchoService"]

        def __init__(self):
            super().__init__()
            self.seen_users = []

        def Echo(self, cntl, request, done):
            if cntl.auth_context is not None:
                self.seen_users.append(cntl.auth_context.user)
            return side.pb.EchoResponse(message=request.message)

    return EchoServiceImpl()


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


class _Pair:
    """A server of one package with ``auth``, and stubs of the other."""

    def __init__(self, client, server, auth):
        self.c, self.s = SIDES[client], SIDES[server]
        self.impl = _echo_impl(self.s)
        self.server = self.s.rpc.Server(self.s.rpc.ServerOptions(auth=auth))
        self.server.add_service(self.impl).start("127.0.0.1:0")

    def stub(self, **opts):
        ch = self.c.rpc.Channel(self.c.rpc.ChannelOptions(
            timeout_ms=TIMEOUT_MS, **opts)).init(
            str(self.server.listen_endpoint()))
        return self.c.rpc.Stub(
            ch, self.c.pb.DESCRIPTOR.services_by_name["EchoService"])

    def echo(self, stub, msg):
        return stub.Echo(self.c.pb.EchoRequest(message=msg)).message

    def close(self):
        self.server.stop()
        self.server.join(timeout=2)


@pytest.fixture()
def pair():
    made = []

    def make(client, server, auth):
        p = _Pair(client, server, auth)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


# ------------------------------------------------------------------------ auth
@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
class TestAuth:
    def test_shared_secret_ok(self, pair, client, server):
        p = pair(client, server,
                 SIDES[server].auth.SharedSecretAuthenticator(b"s3cret"))
        stub = p.stub(auth=SIDES[client].auth.SharedSecretAuthenticator(
            b"s3cret", user="alice"))
        assert p.echo(stub, "m") == "m"
        assert p.impl.seen_users == ["alice"]

    def test_wrong_secret_rejected(self, pair, client, server):
        p = pair(client, server,
                 SIDES[server].auth.SharedSecretAuthenticator(b"right"))
        stub = p.stub(auth=SIDES[client].auth.SharedSecretAuthenticator(
            b"wrong"), max_retry=0)
        with pytest.raises(p.c.rpc.RpcError) as ei:
            p.echo(stub, "m")
        assert ei.value.error_code == errors.EAUTH
        assert p.impl.seen_users == []

    def test_missing_credential_rejected(self, pair, client, server):
        p = pair(client, server,
                 SIDES[server].auth.SharedSecretAuthenticator(b"k"))
        stub = p.stub(max_retry=0)
        with pytest.raises(p.c.rpc.RpcError) as ei:
            p.echo(stub, "m")
        assert ei.value.error_code == errors.EAUTH

    def test_auth_over_http(self, pair, client, server):
        p = pair(client, server,
                 SIDES[server].auth.SharedSecretAuthenticator(b"k"))
        stub = p.stub(auth=SIDES[client].auth.SharedSecretAuthenticator(
            b"k", user="bob"), protocol="http")
        assert p.echo(stub, "h") == "h"
        assert p.impl.seen_users == ["bob"]

    def test_custom_authenticator(self, pair, client, server):
        def allow_even(base):
            class AllowEven(base):
                def __init__(self):
                    self.n = 0

                def generate_credential(self):
                    self.n += 1
                    return str(self.n)

                def verify_credential(self, token, peer):
                    try:
                        return (SIDES[server].auth.AuthContext(
                            user=f"u{token}")
                            if int(token) % 2 == 0 else None)
                    except ValueError:
                        return None
            return AllowEven()

        p = pair(client, server,
                 allow_even(SIDES[server].auth.Authenticator))
        stub = p.stub(auth=allow_even(SIDES[client].auth.Authenticator),
                      max_retry=0)
        with pytest.raises(p.c.rpc.RpcError):  # first credential "1" is odd
            p.echo(stub, "m")
        assert p.echo(stub, "m") == "m"
        assert p.impl.seen_users == ["u2"]


def test_credentials_are_the_references_bytes(monkeypatch):
    """At the same second, the same secret and user give the same token in
    both packages, and each package verifies the other's."""
    rng = np.random.default_rng(7)
    for _ in range(20):
        secret = rng.integers(0, 256, int(rng.integers(1, 40)),
                              dtype=np.uint8).tobytes()
        user = f"user{int(rng.integers(0, 1000))}"
        now = float(rng.integers(1_600_000_000, 1_900_000_000))
        monkeypatch.setattr(time, "time", lambda: now)
        mine = port_auth.SharedSecretAuthenticator(secret, user=user)
        ref = jax_auth.SharedSecretAuthenticator(secret, user=user)
        token = mine.generate_credential()
        assert token == ref.generate_credential()
        assert mine.verify_credential(token, None).user == user
        assert ref.verify_credential(token, None).user == user
        forged = token[:-1] + ("1" if token.endswith("0") else "0")
        assert mine.verify_credential(forged, None) is None
    monkeypatch.setattr(time, "time", lambda: 2e9)
    assert port_auth.SharedSecretAuthenticator(b"k").verify_credential(
        "u:1:00", None) is None                    # outside the skew


# ------------------------------------------------------------------ the diff
def _profile(mod, method, n, **phase_us):
    prof = mod.MethodProfile(method)
    for _ in range(n):
        prof.add(dict(phase_us), sum(phase_us.values()))
    return prof


class TestDiffEngine:
    def test_percentile_nearest_rank(self):
        assert port_diff.percentile([], 0.99) == 0.0
        assert port_diff.percentile([5.0], 0.5) == 5.0
        vals = list(range(1, 101))
        assert port_diff.percentile(vals, 0.99) == 99
        assert port_diff.percentile(vals, 1.0) == 100

    def test_flags_the_moved_phase(self):
        base = {"S.M": _profile(port_diff, "S.M", 5, execute_us=1000.0,
                                parse_us=50.0)}
        new = {"S.M": _profile(port_diff, "S.M", 5, execute_us=40000.0,
                               parse_us=50.0)}
        regs = port_diff.diff_profiles(base, new)
        assert len(regs) == 1
        r = regs[0]
        assert r.method == "S.M" and r.phase == "execute_us"
        assert "execute p99" in r.describe()
        assert r.to_dict()["summary"] == r.describe()

    @pytest.mark.parametrize("b,n,kw,flagged", [
        (1000.0, 1000.0, {}, False),                     # identical
        (1000.0, 2500.0, {}, False),                     # under the floor
        (1000.0, 2500.0, {"min_delta_us": 500.0}, True),
        (100000.0, 120000.0, {}, False),                 # under 30%
        (100000.0, 120000.0, {"threshold": 0.1}, True),
    ])
    def test_floors(self, b, n, kw, flagged):
        base = {"S.M": _profile(port_diff, "S.M", 5, execute_us=b)}
        new = {"S.M": _profile(port_diff, "S.M", 5, execute_us=n)}
        assert bool(port_diff.diff_profiles(base, new, **kw)) == flagged

    def test_min_samples_and_missing_methods(self):
        base = {"S.M": _profile(port_diff, "S.M", 2, execute_us=100.0)}
        new = {"S.M": _profile(port_diff, "S.M", 2, execute_us=90000.0),
               "S.Other": _profile(port_diff, "S.Other", 9,
                                   execute_us=90000.0)}
        assert port_diff.diff_profiles(base, new) == []

    def test_render_report_marks_regressions(self):
        base = {"S.M": _profile(port_diff, "S.M", 5, execute_us=1000.0)}
        new = {"S.M": _profile(port_diff, "S.M", 5, execute_us=40000.0)}
        regs = port_diff.diff_profiles(base, new)
        out = port_diff.render_report(base, new, regs)
        assert "<-- REGRESSED" in out
        assert "1 phase regression(s):" in out
        assert "no phase regressions" in port_diff.render_report(
            base, base, [])


PHASES = ("queue_us", "parse_us", "credit_wait_us", "send_us",
          "execute_us", "respond_us")


def _seeded_spans(rng, slow=1.0):
    spans = []
    for method in ("Echo", "Generate", "Stats"):
        for _ in range(int(rng.integers(3, 30))):
            phases = {p: float(rng.integers(1, 5000))
                      * (slow if p == "execute_us" else 1.0)
                      for p in PHASES if rng.random() < 0.8}
            spans.append({"kind": ("server" if rng.random() < 0.8
                                   else "client"),
                          "service": "S", "method": method,
                          "phases": phases,
                          "latency_us": sum(phases.values())})
    return {"spans": spans}


def _both(path_or_doc, kind="server"):
    return (port_diff.load_profiles(path_or_doc, kind),
            jax_diff.load_profiles(path_or_doc, kind))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_span_exports_give_the_references_report(tmp_path, seed, q):
    rng = np.random.default_rng(seed)
    base_doc = _seeded_spans(rng)
    new_doc = _seeded_spans(rng, slow=float(rng.choice([1.0, 4.0, 20.0])))
    paths = []
    for name, doc in (("base.json", base_doc), ("new.json", new_doc)):
        (tmp_path / name).write_text(json.dumps(doc))
        paths.append(str(tmp_path / name))
    for kind in ("server", ""):
        pb, jb = _both(paths[0], kind)
        pn, jn = _both(paths[1], kind)
        assert {m: p.phases for m, p in pb.items()} == \
            {m: p.phases for m, p in jb.items()}
        pr = port_diff.diff_profiles(pb, pn, q=q, min_delta_us=100.0)
        jr = jax_diff.diff_profiles(jb, jn, q=q, min_delta_us=100.0)
        assert [r.to_dict() for r in pr] == [r.to_dict() for r in jr]
        assert port_diff.render_report(pb, pn, pr, q) == \
            jax_diff.render_report(jb, jn, jr, q)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dump_directories_give_the_references_profiles(tmp_path, writer):
    """rpc_dump v2 directories written by either package's dumper load to
    the same profiles in both packages."""
    if writer == "port":
        from brpc_tpu_torch.proto import rpc_meta_pb2
        from brpc_tpu_torch.trace import span as sp
        from brpc_tpu_torch.trace.rpc_dump import RpcDumper
    else:
        from brpc_tpu.proto import rpc_meta_pb2
        from brpc_tpu.trace import span as sp
        from brpc_tpu.trace.rpc_dump import RpcDumper
    rng = np.random.default_rng(31)
    dumper = RpcDumper(str(tmp_path))
    for i in range(12):
        meta = rpc_meta_pb2.RpcMeta()
        meta.request.service_name = "EchoService"
        meta.request.method_name = ("Echo", "Other")[i % 2]
        span = sp.Span(1, 2 + i, 0, sp.KIND_SERVER, "S", "M")
        for p in PHASES[:4]:
            span.add_phase(p, float(rng.integers(1, 9000)))
        span.end_mono_us = span.start_mono_us + float(
            rng.integers(1000, 20000))
        dumper.commit(dumper.begin(meta, b"body"), span)
    dumper.close()
    port_p, jax_p = _both(str(tmp_path))
    assert sorted(port_p) == sorted(jax_p) == ["EchoService.Echo",
                                               "EchoService.Other"]
    for m in port_p:
        assert port_p[m].count == jax_p[m].count == 6
        assert port_p[m].phases == jax_p[m].phases


def test_the_cli_takes_the_reference_tools_arguments(tmp_path):
    def spans(name, execute_us):
        doc = {"spans": [
            {"kind": "server", "service": "S", "method": "M",
             "phases": {"execute_us": execute_us}, "latency_us": execute_us}
            for _ in range(5)]}
        (tmp_path / name).write_text(json.dumps(doc))
        return str(tmp_path / name)

    base, same, bad = (spans("base.json", 1000.0), spans("same.json", 1100.0),
                       spans("bad.json", 50000.0))
    assert port_diff.main([base, same]) == 0
    assert port_diff.main([base, str(tmp_path / "nope.json")]) == 2
    assert port_diff.main([base, same, "--percentile", "0"]) == 2
    out = subprocess.run(
        [sys.executable, "-m", "brpc_tpu_torch.trace.diff", base, bad,
         "--json", "--threshold", "0.5"], capture_output=True, text=True,
        timeout=60, cwd=ROOT)
    assert out.returncode == 1, out.stderr
    doc = json.loads(out.stdout)
    assert doc["regressions"][0]["phase"] == "execute_us"
    assert doc["methods_compared"] == ["S.M"]
    assert doc["threshold"] == 0.5
    ref = subprocess.run(
        [sys.executable, "tools/trace_diff.py", base, bad, "--json",
         "--threshold", "0.5"], capture_output=True, text=True, timeout=60,
        cwd=ROOT)
    assert ref.returncode == 1 and json.loads(ref.stdout) == doc

"""The port's ``tools/rpc_view`` against the JAX package's: ``--dump``
renders byte-equal on the same directories (the committed corpora, a v1
plus v2 mix written by the port's dumper, an empty one) and fails alike
on a missing one; a page fetched over the binary protocol and over
HTTP from either package's server; ``--set`` on a flag page; the proxy
browsing either package's server; the usage error."""

import io
import os
from contextlib import redirect_stdout

import pytest

import brpc_tpu.rpc as jax_rpc
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu.proto import echo_pb2 as jax_echo
from brpc_tpu_torch import flags as port_flags
from brpc_tpu_torch.policy.http_protocol import http_fetch
from brpc_tpu_torch.proto import echo_pb2 as port_echo
from brpc_tpu_torch.proto import rpc_meta_pb2
from brpc_tpu_torch.tools import rpc_view as port_view
from brpc_tpu_torch.trace.rpc_dump import RpcDumper, pack_record
from tools import rpc_view as jax_view

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(autouse=True)
def _cold_run_to_completion():
    """Run-to-completion classifies handlers by (service, method) name
    across the process (ROADMAP Queue 3): these tests' fast
    EchoService.Echo traffic would leave the name classified cheap for
    the next test on this worker, whose slow EchoService.Echo then runs
    inline. Each test here leaves both packages' classification cold."""
    from brpc_tpu.rpc import run_to_completion as jax_rtc
    from brpc_tpu_torch.rpc import run_to_completion as port_rtc

    yield
    jax_rtc._reset_for_test()
    port_rtc._reset_for_test()


def _main(tool, args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tool.main(args)
    return rc, buf.getvalue()


def _mixed_dump(path):
    """Two v2 records of one method and a v1 record of another."""
    meta = rpc_meta_pb2.RpcMeta()
    meta.request.service_name = "EchoService"
    meta.request.method_name = "Legacy"
    with open(os.path.join(path, "requests.9.dump"), "wb") as f:
        f.write(pack_record(meta, b"v1"))
    dumper = RpcDumper(path)
    meta.request.method_name = "Echo"
    for _ in range(2):
        dumper.commit(dumper.begin(meta, b"bodybytes"), None)
    dumper.close()


@pytest.mark.parametrize("what", ["serving_corpus",
                                  "serving_corpus_overload",
                                  "serving_corpus_spec", "mixed", "empty"])
def test_dump_rendering_is_byte_equal(what, tmp_path):
    if what == "mixed":
        _mixed_dump(str(tmp_path))
        path = str(tmp_path)
    elif what == "empty":
        path = str(tmp_path)
    else:
        path = os.path.join(DATA, what)
    ours = _main(port_view, ["--dump", path])
    theirs = _main(jax_view, ["--dump", path])
    assert ours == theirs and ours[0] == 0
    if what == "mixed":
        assert "records: 3 (v1/v2; 0 with phase timelines)" in ours[1]


def test_a_missing_dump_fails_alike(tmp_path):
    missing = str(tmp_path / "nope")
    assert _main(port_view, ["--dump", missing])[0] == 1
    assert _main(jax_view, ["--dump", missing])[0] == 1


def test_a_server_or_a_dump_is_required(capsys):
    with pytest.raises(SystemExit):
        port_view.main([])
    assert "server is required" in capsys.readouterr().err


def _echo_server(side):
    rpc, pb = (jax_rpc, jax_echo) if side == "jax" else (port_rpc,
                                                         port_echo)

    class Echo(rpc.Service):
        DESCRIPTOR = pb.DESCRIPTOR.services_by_name["EchoService"]

        def Echo(self, cntl, request, done):
            return pb.EchoResponse(message=request.message)

    return rpc.Server().add_service(Echo()).start("127.0.0.1:0")


@pytest.fixture(params=["jax", "port"])
def server(request):
    srv = _echo_server(request.param)
    yield srv
    srv.stop()
    srv.join(timeout=2)


def test_fetch_over_the_binary_protocol_and_http(server):
    ep = str(server.listen_endpoint())
    for extra in ([], ["--http"]):
        rc, out = _main(port_view, [ep, "status", *extra])
        assert rc == 0 and "EchoService" in out, out
    assert _main(port_view, [ep, "no_such_page"])[0] == 1


def test_set_a_flag_through_its_page():
    srv = _echo_server("port")
    before = port_flags.get("idle_timeout_s")
    try:
        rc, out = _main(port_view, [str(srv.listen_endpoint()),
                                    "flags/idle_timeout_s", "--set", "7"])
        assert rc == 0, out
        assert port_flags.get("idle_timeout_s") == 7
    finally:
        port_flags.set_flag("idle_timeout_s", str(before))
        srv.stop()
        srv.join(timeout=2)


def test_the_proxy_browses_the_target(server):
    proxy = port_view.serve("127.0.0.1:0", str(server.listen_endpoint()),
                            block=False)
    try:
        pep = str(proxy.listen_endpoint())
        resp = http_fetch(pep, "GET", "/status", timeout=5)
        assert resp.status == 200
        body = resp.body.decode()
        assert "EchoService" in body
        assert str(server.listen_endpoint()) in body
        assert http_fetch(pep, "GET", "/vars", timeout=5).status == 200
        resp = http_fetch(pep, "GET", "/index", timeout=5)
        assert resp.status == 200 and b"/status" in resp.body
    finally:
        proxy.stop()
        proxy.join(timeout=2)

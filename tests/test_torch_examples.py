"""The port's copies of the examples of its lanes (brpc_tpu_torch/examples/
{echo,streaming_echo,device_data,device_stream,tpu_transfer,
collective_fanout,batched_inference,llm_server}) and of the host-only
examples ({parallel_echo,selective_echo,partition_echo,backup_request,
multi_threaded_echo,http,dashboard_proxy,grpc_echo,redis_kv,mongo_kv,
rtmp_live}), run as
the JAX package's tests/test_examples.py runs the originals: server and
client pairs as fresh interpreters on random ports, with the device
examples on ``--device cpu``, their outputs held to the same strings.
Each device server also prints its copy kernels' launches on SIGTERM
(all 0 here: a CPU tensor takes the plain copy). None of them may load
JAX, the JAX package or protobuf.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}
PKG = "brpc_tpu_torch.examples"

# run inside each example's interpreter: its own main, then the modules
# it loaded that the port must never load
_GUARD = ("import runpy, sys; sys.argv = [{mod!r}] + {args!r}; "
          "rc = 0\n"
          "try:\n"
          "    runpy.run_module({mod!r}, run_name='__main__')\n"
          "except SystemExit as e:\n"
          "    rc = e.code or 0\n"
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'brpc_tpu') or "
          "m.startswith('google.protobuf'))\n"
          "print('foreign modules', bad, flush=True)\n"
          "sys.exit(rc or (1 if bad else 0))")


def _cmd(example, args):
    mod = f"{PKG}.{example}"
    return [sys.executable, "-c", _GUARD.format(mod=mod, args=list(args))]


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_client(example, args, timeout=120):
    proc = subprocess.run(_cmd(example, args), env=ENV, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "foreign modules []" in proc.stdout
    return proc.stdout


class Server:
    """A server example in a fresh interpreter; ``address`` is what its
    first line names after " on "."""

    def __init__(self, example, args):
        self.proc = subprocess.Popen(_cmd(example, args), env=ENV, cwd=REPO,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        deadline = time.time() + 60
        while time.time() < deadline:
            line = self.proc.stdout.readline()
            if " on " in line:
                self.address = line.split(" on ", 1)[1].split(" ")[0].strip()
                return
            if not line and self.proc.poll() is not None:
                break
        self.proc.kill()
        pytest.fail(f"{example} never came up")

    def stop(self):
        """SIGTERM, then everything the server printed after its first
        line."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        return self.proc.returncode, out


def _launches(out):
    lines = [l for l in out.splitlines() if l.startswith("launches ")]
    assert lines, out
    return json.loads(lines[-1].split(" ", 1)[1])


def test_echo():
    port = free_port()
    srv = Server("echo.server", ["--port", str(port), "--run_seconds", "30"])
    try:
        out = run_client("echo.client",
                         ["--server", f"127.0.0.1:{port}", "-n", "3"])
        assert "hello 2" in out and "attachment" in out
    finally:
        srv.stop()


def test_streaming_echo():
    port = free_port()
    srv = Server("streaming_echo.server",
                 ["--port", str(port), "--run_seconds", "30"])
    try:
        out = run_client("streaming_echo.client",
                         ["--server", f"127.0.0.1:{port}", "-n", "30"])
        assert "echoed 30 messages" in out
    finally:
        srv.stop()


def test_tpu_transfer():
    out = run_client("tpu_transfer.client",
                     ["--device", "cpu", "--sizes", "4096,65536", "-n", "4"])
    assert "MB/s" in out
    assert _launches(out)["hbm_copy"] == 0  # the CPU takes the plain copy


def test_device_stream():
    srv = Server("device_stream.server",
                 ["--listen", "127.0.0.1:0", "--device", "cpu"])
    try:
        out = run_client("device_stream.client",
                         ["--server", srv.address, "-n", "4",
                          "--block-kb", "64", "--window-kb", "128"])
        assert "consumed on-device" in out
    finally:
        rc, sout = srv.stop()
    assert rc == 0, sout
    assert "foreign modules []" in sout
    assert _launches(sout)["hbm_copy_batched"] == 0


def test_device_data():
    srv = Server("device_data.server",
                 ["--listen", "tpu://127.0.0.1:0/0", "--device", "cpu"])
    try:
        out = run_client("device_data.client",
                         ["--server", srv.address, "--mb", "1",
                          "--copies", "3", "--pump-rounds", "2"])
        assert "content verified" in out
        assert "checksum=" in out
    finally:
        rc, sout = srv.stop()
    assert rc == 0, sout
    assert "foreign modules []" in sout
    assert _launches(sout)["hbm_copy"] == 0


def test_collective_fanout():
    out = run_client("collective_fanout.client", ["--cpu"])
    assert "mesh detected: True" in out and "OK" in out


def test_collective_fanout_defaults_to_the_cards():
    """Without ``--cpu`` the sub-channels are the cards': with no card
    the example raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    proc = subprocess.run(_cmd("collective_fanout.client", []), env=ENV,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_device_examples_default_to_the_card():
    """Without ``--device`` a device example's store is the card's: with
    no card it raises instead of running on the CPU."""
    from brpc_tpu_torch.examples import device_store

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError):
        device_store()


def test_multi_threaded_echo():
    port = free_port()
    srv = Server("echo.server", ["--port", str(port), "--run_seconds", "30"])
    try:
        out = run_client("multi_threaded_echo.client",
                         ["--server", f"127.0.0.1:{port}", "--threads", "4",
                          "--seconds", "2"])
        assert "qps=" in out and "final:" in out
    finally:
        srv.stop()


@pytest.mark.parametrize("example,args,expect", [
    ("parallel_echo", ["-n", "2"], ("[srv0]", "[srv1]", "[srv2]")),
    ("selective_echo", ["-n", "6"], ("killed srv0",)),
    ("partition_echo", ["-n", "2"], ("p0", "p2")),
    ("backup_request", ["-n", "4"], ("backup=yes", "fast")),
    ("dashboard_proxy", [], ("over trpc_std OK",)),
], ids=["parallel_echo", "selective_echo", "partition_echo",
        "backup_request", "dashboard_proxy"])
def test_host_example(example, args, expect):
    """The single-file host examples, held to the JAX package's
    tests/test_examples.py strings."""
    out = run_client(f"{example}.client", args)
    for text in expect:
        assert text in out, out


def _batch_report(out):
    lines = [l for l in out.splitlines() if l.startswith("batch ")]
    assert lines, out
    return json.loads(lines[-1].split(" ", 1)[1])


def test_batched_inference(tmp_path):
    """The batched-inference pair on the CPU, the server holding the JAX
    example's W (``--weights``): a 32-request burst with one poisoned
    request coalesces (fewer forward calls than requests, g_batch_size
    above 1) and the poisoned request fails alone."""
    import numpy as np

    from examples.batched_inference.server import \
        BatchedInferenceService as JaxInference

    w = tmp_path / "W.npy"
    np.save(w, np.asarray(JaxInference()._W, np.float32))
    port = free_port()
    srv = Server("batched_inference.server",
                 ["--port", str(port), "--device", "cpu",
                  "--weights", str(w)])
    try:
        out = run_client("batched_inference.client",
                         ["--server", f"127.0.0.1:{port}", "-n", "32",
                          "--poison", "1"])
        assert "33 responses" in out
        assert "poisoned requests failed alone: 1/1 EREQUEST" in out
        assert "rode a multi-request batch" in out
    finally:
        rc, sout = srv.stop()
    assert rc == 0, sout
    assert "foreign modules []" in sout
    report = _batch_report(sout)
    assert report["items"] >= 33
    assert report["calls"] < report["items"]
    assert report["g_batch_size"] > 1


def test_batched_inference_defaults_to_the_card():
    """Without ``--device`` the model is on the card: with no card the
    server raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    proc = subprocess.run(_cmd("batched_inference.server",
                               ["--port", str(free_port())]),
                          env=ENV, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_http():
    """The HTTP example's one port: JSON RPC (the handler sees the HTTP
    request), pb over HTTP through ``Channel(protocol="http")``, and the
    builtin pages, as its docstring's curl lines show."""
    from brpc_tpu_torch.policy.http_protocol import http_fetch
    from brpc_tpu_torch.proto import echo_pb2
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Stub

    port = free_port()
    srv = Server("http.server", ["--port", str(port), "--run_seconds", "30"])
    try:
        ep = f"127.0.0.1:{port}"
        resp = http_fetch(ep, "POST", "/EchoService/Echo",
                          body=b'{"message":"hi"}', timeout=10)
        assert resp.status == 200 and json.loads(resp.body) == \
            {"message": "hi"}
        stub = Stub(Channel(ChannelOptions(protocol="http",
                                           timeout_ms=10000)).init(ep),
                    echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
        assert stub.Echo(echo_pb2.EchoRequest(message="pb")).message == "pb"
        status = http_fetch(ep, "GET", "/status", timeout=10)
        assert status.status == 200 and b"[EchoService]" in status.body
    finally:
        _, out = srv.stop()
    assert "via HTTP POST /EchoService/Echo" in out


def test_llm_server_answers_json_and_serving():
    """The llm_server example on ``--device cpu``: Generate over JSON
    answers on its port, and ``/serving`` reports the engine's tokens."""
    from brpc_tpu_torch.policy.http_protocol import http_fetch

    port = free_port()
    srv = Server("llm_server.server",
                 ["--port", str(port), "--run_seconds", "60",
                  "--device", "cpu"])
    try:
        ep = f"127.0.0.1:{port}"
        resp = http_fetch(ep, "POST", "/LlmService/Generate",
                          body=b'{"prompt_len": 16, "max_new_tokens": 8}',
                          timeout=60)
        assert resp.status == 200, resp.body
        assert len(json.loads(resp.body)["tokens"]) == 8
        page = json.loads(http_fetch(ep, "GET", "/serving?format=json",
                                     timeout=10).body)
        assert [e["tokens_generated"] for e in page["engines"]] == [8]
    finally:
        srv.stop()


def test_grpc_echo():
    port = free_port()
    srv = Server("grpc_echo.server",
                 ["--port", str(port), "--run_seconds", "30"])
    try:
        out = run_client("grpc_echo.client",
                         ["--server", f"127.0.0.1:{port}", "-n", "3"])
        assert "grpc 2" in out and "SERVING" in out
    finally:
        srv.stop()


def test_redis_kv():
    """The redis example answers SET / GET / DEL / DBSIZE on its port,
    driven by the port's redis client Channel."""
    from brpc_tpu_torch.policy.redis_protocol import (RedisRequest,
                                                      redis_method)
    from brpc_tpu_torch.rpc import Channel, ChannelOptions

    port = free_port()
    srv = Server("redis_kv.server",
                 ["--port", str(port), "--run_seconds", "30"])
    try:
        ch = Channel(ChannelOptions(protocol="redis", timeout_ms=10000))
        ch.init(f"127.0.0.1:{port}")
        resp = ch.call_method(redis_method(), RedisRequest()
                              .add_command("set", "k", "v")
                              .add_command("get", "k")
                              .add_command("dbsize")
                              .add_command("del", "k")
                              .add_command("get", "k"))
        got = [resp.reply(i).value for i in range(resp.reply_size)]
        assert got == ["OK", b"v", 1, 1, None], got
    finally:
        srv.stop()


def test_rtmp_live():
    out = run_client("rtmp_live.client", ["-n", "6"])
    assert "relayed" in out and "OK" in out


def test_mongo_kv():
    out = run_client("mongo_kv.client", ["-n", "3"])
    assert "find key2" in out and "OK" in out

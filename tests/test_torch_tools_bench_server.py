"""The port's ``tools/bench_server`` and corpus recorders as users start
them (``python -m brpc_tpu_torch.tools.<name>``, fresh interpreters, the
CPU asked for with ``--torch-device cpu``), held against the JAX
package's tools: the LISTEN line and an echo in each listener mode, the
stop on stdin's close and the stderr reports; two shard workers serving
the echo with neither JAX, the JAX package nor protobuf in them; the
``--batch`` checksums against the JAX service's with the JAX weights
carried across; ``--serving``'s tokens against the JAX engine's; the
device data service; each recorder's corpus against the committed one;
and, with no card, every device entry point refusing to start."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu_torch.proto import device_lane_pb2, echo_pb2, serving_pb2
from brpc_tpu_torch.tools import bench_server, rpc_replay
from tools import bench_server as jax_bench_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
ECHO = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]
# a checksum ("%.4f" of the output row's sum) against the JAX service's:
# relative to max(1, |jax|), plus one last digit of the two texts
BATCH_RTOL = 1e-4
BATCH_ROUND = 1e-4
NO_MODULES = ("import sys\nbad = sorted(m for m in sys.modules if "
              "m.split('.')[0] in ('jax', 'jaxlib', 'brpc_tpu') or "
              "m.startswith('google.protobuf'))\nassert not bad, bad\n")


class BenchServer:
    """``bench_server`` in a child process; ``stop()`` closes its stdin
    and returns (exit code, stdout, stderr)."""

    def __init__(self, *args):
        env = dict(os.environ, PYTHONPATH=REPO)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "brpc_tpu_torch.tools.bench_server",
             *args], cwd=REPO, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line.startswith("LISTEN "):
            self.stop()
            raise AssertionError(f"no LISTEN line: {line!r} "
                                 f"{self.proc.stderr.read()}")
        self.ep = line.split()[1]

    def stop(self):
        try:
            out, err = self.proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, err = self.proc.communicate()
        return self.proc.returncode, out, err


def _echo(ep, message="m", payload=b"p", attachment=b"a"):
    stub = port_rpc.Stub(port_rpc.Channel(port_rpc.ChannelOptions(
        timeout_ms=30000)).init(ep), ECHO)
    cntl = port_rpc.Controller()
    cntl.request_attachment = attachment
    resp = stub.Echo(echo_pb2.EchoRequest(message=message, payload=payload),
                     controller=cntl)
    return resp, cntl.response_attachment


@pytest.mark.parametrize("mode", [[], ["--native"],
                                  ["--native", "--native_echo"],
                                  ["--native", "--inline"]],
                         ids=lambda m: "-".join(m) or "python")
def test_listen_echo_and_stop(mode):
    srv = BenchServer("--torch-device", "cpu", *mode)
    try:
        resp, att = _echo(srv.ep)
        assert (resp.message, resp.payload) == ("m", b"p")
        if "--native_echo" not in mode:
            assert att == b"a"
    finally:
        rc, out, err = srv.stop()
    assert rc == 0, err
    assert "# rtc inline_requests=" in err and "# launches {" in err


def test_null_needs_native():
    with pytest.raises(SystemExit) as e:
        bench_server.main(["--null"])
    assert e.value.code == 2


def _children(pid):
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{task}/children") as f:
            out += [int(x) for x in f.read().split()]
    return out


def test_shard_workers_serve_the_echo_without_jax_or_protobuf():
    """The shard factory bench_server names is the port's, and the two
    workers it spawns answer the tunnel's echoes with neither JAX nor
    protobuf mapped; a fresh interpreter resolving that factory as a
    worker does loads neither JAX, the JAX package nor protobuf."""
    with open(bench_server.__file__) as f:
        tree = ast.parse(f.read())
    factories = [n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and n.value.endswith(":echo_services")]
    assert factories == ["brpc_tpu_torch.shard.testing:echo_services"]
    mod, _, attr = factories[0].partition(":")
    res = subprocess.run(
        [sys.executable, "-c", f"import importlib\n"
         f"svcs = getattr(importlib.import_module({mod!r}), {attr!r})()\n"
         f"assert svcs\n" + NO_MODULES],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    srv = BenchServer("--listen", "tpu://127.0.0.1:0/0", "--shard-workers",
                      "2", "--torch-device", "cpu")
    try:
        for i in range(8):
            resp, _ = _echo(srv.ep, message=f"s{i}")
            assert resp.message == f"s{i}"
        workers = []
        for pid in _children(srv.proc.pid):
            with open(f"/proc/{pid}/cmdline") as f:
                if "brpc_tpu_torch.shard.worker" in f.read():
                    workers.append(pid)
        assert len(workers) == 2, workers
        for pid in workers:
            with open(f"/proc/{pid}/maps") as f:
                maps = f.read()
            assert "google/protobuf" not in maps and "/jax" not in maps
            assert "brpc_tpu/native/_" not in maps
    finally:
        rc, _, err = srv.stop()
    assert rc == 0, err


def _jax_weights():
    """The JAX bench server's W and b, drawn with its own jax.random
    calls (tools/bench_server.py, BatchBenchService)."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    W = jax.random.normal(k1, (32, 256, 256), jnp.float32) * (
        1.0 / np.sqrt(256))
    b = jax.random.normal(k2, (32, 256), jnp.float32) * .01
    return np.asarray(W), np.asarray(b)


def test_batch_checksums_equal_the_jax_services(tmp_path):
    W, b = _jax_weights()
    np.savez(tmp_path / "w.npz", W=W, b=b)
    jax_svc = jax_bench_server.BatchBenchService()
    rng = np.random.default_rng(11)
    rows = [rng.standard_normal(256).astype(np.float32) for _ in range(4)]
    srv = BenchServer("--batch", "--torch-device", "cpu", "--batch-weights",
                      str(tmp_path / "w.npz"))
    try:
        ch = port_rpc.Channel(port_rpc.ChannelOptions(
            timeout_ms=30000)).init(srv.ep)
        for x in rows:
            req = echo_pb2.EchoRequest(payload=x.tobytes())
            want = float(jax_svc.Infer(None, req, None).message)
            for method in ("Infer", "InferBatched"):
                md = port_rpc.MethodDescriptor(
                    "BatchBench", method, echo_pb2.EchoRequest,
                    echo_pb2.EchoResponse)
                got = float(ch.call_method(md, req).message)
                assert abs(got - want) <= (BATCH_RTOL * max(1.0, abs(want))
                                           + BATCH_ROUND), (method, got,
                                                            want)
        bad = port_rpc.MethodDescriptor("BatchBench", "Infer",
                                        echo_pb2.EchoRequest,
                                        echo_pb2.EchoResponse)
        with pytest.raises(port_rpc.RpcError):
            ch.call_method(bad, echo_pb2.EchoRequest(payload=b"short"))
    finally:
        rc, _, err = srv.stop()
    assert rc == 0, err


def test_the_batch_mlp_is_the_plain_scan():
    """BatchMLP with the default weights (a torch.Generator seeded 0)
    against the same layers in float64 numpy."""
    W, b = bench_server.default_weights()
    x = np.random.default_rng(3).standard_normal((3, 256)).astype(np.float32)
    got = bench_server.BatchMLP(W, b)(torch.from_numpy(x)).numpy()
    h = x.astype(np.float64)
    for l in range(W.shape[0]):
        h = np.maximum(h @ W[l] + b[l], 0.0)
    assert np.allclose(got, h, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        bench_server.BatchMLP(W[:2], b)


def _jax_serving_engine():
    cfg = JaxModelConfig(attn="reference", vocab=256, d_model=32,
                         n_heads=2, n_layers=2)
    kv = JaxKV(JaxKVConfig(16, 256), cfg.n_layers, cfg.kv_dim)
    return JaxEngine(JaxModel(cfg, kv), kv, JaxEngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.005)).start()


def test_serving_tokens_equal_the_jax_engines():
    import threading

    reqs = [(16, 4), (32, 8), (17, 6)]
    jax_eng = _jax_serving_engine()
    try:
        want = []
        for plen, max_new in reqs:
            ev, box = threading.Event(), {}
            jax_eng.submit(jax_eng.model.synth_prompt(plen), max_new,
                           done=lambda r, box=box, ev=ev: (box.update(r=r),
                                                           ev.set()))
            assert ev.wait(120)
            want.append(list(box["r"].tokens))
    finally:
        jax_eng.stop()
    srv = BenchServer("--serving", "--torch-device", "cpu")
    try:
        stub = port_rpc.Stub(port_rpc.Channel(port_rpc.ChannelOptions(
            timeout_ms=60000)).init(srv.ep),
            serving_pb2.DESCRIPTOR.services_by_name["LlmService"])
        got = [list(stub.Generate(serving_pb2.GenerateRequest(
            prompt_len=plen, max_new_tokens=max_new)).tokens)
            for plen, max_new in reqs]
    finally:
        rc, _, err = srv.stop()
    assert rc == 0, err
    assert got == want
    assert '"flash_attention": 0' in err  # the CPU runs the plain version
    # the warm-up's 32 requests and these 3, each a prefix miss or a hit
    line = [l for l in err.splitlines() if l.startswith("# serving ")][0]
    prefix = json.loads(line.split(" ", 2)[2])
    assert prefix["prefix_miss_seqs"] + prefix["prefix_hit_seqs"] == 35


def test_the_device_data_service_on_the_cpu():
    srv = BenchServer("--device", "--torch-device", "cpu")
    try:
        ch = port_rpc.Channel(port_rpc.ChannelOptions(
            timeout_ms=30000)).init(srv.ep)
        stub = port_rpc.Stub(ch, device_lane_pb2.DESCRIPTOR.services_by_name[
            "DeviceDataService"])
        data = bytes(range(256)) * 16
        c = port_rpc.Controller()
        c.request_attachment = data
        h = stub.Put(device_lane_pb2.DeviceHandle(), controller=c).handle
        g = port_rpc.Controller()
        stub.Get(device_lane_pb2.DeviceHandle(handle=h), controller=g)
        assert g.response_attachment == data
        assert _echo(srv.ep)[0].message == "m"
    finally:
        rc, _, err = srv.stop()
    assert rc == 0, err


RECORDERS = {"record_serving_corpus": "serving_corpus",
             "record_serving_corpus_overload": "serving_corpus_overload",
             "record_serving_corpus_spec": "serving_corpus_spec"}


def _records(path):
    return [(i.md.service_name, i.md.method_name, i.payload, i.attachment,
             i.tenant, i.priority) for i in rpc_replay.load_items(path)[0]]


@pytest.mark.parametrize("tool", sorted(RECORDERS))
def test_each_recorder_rewrites_the_committed_corpus(tool, tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", f"brpc_tpu_torch.tools.{tool}", "--out",
         str(tmp_path), "--torch-device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("recorded ")
    got = _records(str(tmp_path))
    want = _records(os.path.join(DATA, RECORDERS[tool]))
    # in arrival order within each tenant: the overload schedule fires a
    # prod and a batch request at the same offsets, which may arrive
    # either way round; one tenant's requests are 10 ms or more apart
    for tenant in {r[4] for r in want}:
        assert [r for r in got if r[4] == tenant] == \
            [r for r in want if r[4] == tenant]
    assert len(got) == len(want)


@pytest.mark.parametrize("cmd", [
    ["bench_server", "--serving"], ["bench_server", "--batch"],
    ["bench_server", "--device"], ["record_serving_corpus"],
    ["record_serving_corpus_overload"], ["record_serving_corpus_spec"]],
    ids=lambda c: "-".join(c))
def test_with_no_card_the_device_entry_points_refuse(cmd, tmp_path):
    """Each entry point's default device is the card: with none it raises
    before it listens or writes a record (no CPU fallback)."""
    import importlib

    from brpc_tpu_torch import flags as port_flags
    from brpc_tpu_torch.metrics import collector  # noqa: F401 (its flag)

    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would start")
    tool = importlib.import_module(f"brpc_tpu_torch.tools.{cmd[0]}")
    args = cmd[1:] + (["--out", str(tmp_path)] if cmd[0].startswith(
        "record") else ["--listen", "127.0.0.1:0"])
    saved = {k: port_flags.get(k) for k in (
        "rpcz_sample_ratio", "rpc_dump_ratio",
        "collector_max_samples_per_second")}
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(args)
    finally:
        for k, v in saved.items():
            port_flags.set_flag(k, str(v))
    assert not os.listdir(tmp_path)

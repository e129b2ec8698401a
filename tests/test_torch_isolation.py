"""The port stands alone: brpc_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package (brpc_tpu or brpc_tpu.*), nor
protobuf: the card's machine has none, and every wire message of the port
(the RPC front's and DeviceDataService's) is a table of its own message
runtime."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "brpc_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "brpc_tpu"


def _imports(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_protobuf_import(path):
    bad = [(line, mod) for line, mod in _imports(path)
           if mod == "google" or mod.startswith("google.protobuf")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_forbidden_matches_exact_module_names():
    assert _forbidden("brpc_tpu") and _forbidden("brpc_tpu.serving.model")
    assert _forbidden("jax.numpy")
    assert not _forbidden("brpc_tpu_torch.serving")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, brpc_tpu_torch.serving, brpc_tpu_torch.tpu.pallas_ops,"
            " brpc_tpu_torch.tpu._build, brpc_tpu_torch.serving.weights,"
            " brpc_tpu_torch.tpu.train, brpc_tpu_torch.tpu.ring,"
            " brpc_tpu_torch.tpu.bench_kernels, brpc_tpu_torch.tpu.device_lane,"
            " brpc_tpu_torch.tpu.tpusocket, brpc_tpu_torch.tpu.transport,"
            " brpc_tpu_torch.tpu.device_stream, brpc_tpu_torch.tpu.mesh,"
            " brpc_tpu_torch.rpc.circuit_breaker,"
            " brpc_tpu_torch.analysis.runtime_check\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'brpc_tpu'))\n"
            "assert not bad, bad\n")
    _run(code)


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_data_plane_and_chip_smoke_load_no_protobuf():
    _run("import sys, brpc_tpu_torch.tpu.bench_kernels,"
         " brpc_tpu_torch.tpu.device_lane, brpc_tpu_torch.serving, chip_smoke\n"
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
         "assert not bad, bad\n")


def test_rpc_front_answers_a_generate_with_no_protobuf_or_jax():
    """The RPC front runs on the port's own message runtime: a Server with
    LlmServingService answers one streamed Generate on the CPU, and the
    process has loaded neither protobuf nor JAX."""
    _run(
        "import sys, threading\n"
        "import brpc_tpu_torch.rpc as rpc\n"
        "import brpc_tpu_torch.serving.service as service\n"
        "from brpc_tpu_torch.proto import serving_pb2\n"
        "from brpc_tpu_torch.rpc.stream import StreamOptions, stream_create\n"
        "from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,"
        " ModelConfig, PagedKVCache, ServingEngine, TinyTransformer)\n"
        "cfg = ModelConfig(vocab=64, d_model=16, n_heads=2, n_layers=1)\n"
        "kv = PagedKVCache(KVCacheConfig(16, 16), cfg.n_layers, cfg.kv_dim,"
        " device='cpu')\n"
        "eng = ServingEngine(TinyTransformer(cfg, kv), kv,"
        " EngineConfig(idle_wait_s=0.005)).start()\n"
        "srv = rpc.Server().add_service(service.LlmServingService(eng))"
        ".start('127.0.0.1:0')\n"
        "ch = rpc.Channel().init(str(srv.listen_endpoint()))\n"
        "stub = rpc.Stub(ch, serving_pb2.DESCRIPTOR.services_by_name"
        "['LlmService'])\n"
        "frames, last = [], threading.Event()\n"
        "def on_received(sid, msgs):\n"
        "    for m in msgs:\n"
        "        d = serving_pb2.TokenDelta.FromString(m)\n"
        "        frames.extend(d.tokens)\n"
        "        if d.done: last.set()\n"
        "cntl = rpc.Controller()\n"
        "cntl.stream_id = stream_create(StreamOptions("
        "on_received=on_received))\n"
        "resp = stub.Generate(serving_pb2.GenerateRequest(prompt_len=20,"
        " max_new_tokens=8), controller=cntl)\n"
        "assert last.wait(10) and frames == list(resp.tokens), resp\n"
        "assert len(resp.tokens) == 8 and resp.finish_reason == 'length'\n"
        "srv.stop(); srv.join(); eng.stop()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n")


def test_device_data_service_answers_with_no_protobuf():
    """DeviceDataService's messages are tables of the port's runtime: a
    Put, a Copy and a Stats through its in-process entry load neither
    protobuf nor JAX."""
    _run(
        "import sys\n"
        "from brpc_tpu_torch.proto import device_lane_pb2 as pb\n"
        "from brpc_tpu_torch.tpu import device_lane as dl\n"
        "code, resp, _ = dl._tpusock_call('cpu', None, pb.DeviceHandle()"
        ".SerializeToString(), bytes(range(64)), 'Put')\n"
        "h = pb.DeviceHandle.FromString(resp)\n"
        "assert code == 0 and h.nbytes == 64, (code, h)\n"
        "code, resp, _ = dl._tpusock_call('cpu', None, pb.DeviceHandle("
        "handle=h.handle).SerializeToString(), b'', 'Copy')\n"
        "assert code == 0 and pb.DeviceHandle.FromString(resp).nbytes == 64\n"
        "code, resp, _ = dl._tpusock_call('cpu', None, pb.DeviceStatsRequest("
        "fence=True).SerializeToString(), b'', 'Stats')\n"
        "assert pb.DeviceStats.FromString(resp).handles == 2, resp\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n")


def test_the_tpu_lane_answers_over_the_tunnel_with_no_protobuf_or_jax():
    """The tpu:// lane stands alone: a child process of the port serves
    EchoService and DeviceDataService on tpu://127.0.0.1:0/0, this one
    calls both through the cross-process tunnel (a 1 MiB echo in the
    shared-memory blocks, a Put and a Get), and also echoes in process
    through tpu://localhost/0; neither process loads protobuf or JAX."""
    _run(
        "import subprocess, sys\n"
        "import brpc_tpu_torch.rpc as rpc\n"
        "from brpc_tpu_torch.proto import device_lane_pb2 as dpb, echo_pb2\n"
        "from brpc_tpu_torch.tpu import mesh, transport\n"
        "mesh.use_cpu()\n"
        "child = subprocess.Popen([sys.executable,"
        " 'brpc_tpu_torch/bench/tpu_lane.py', '--serve', '--cpu'],"
        " stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)\n"
        "ep = child.stdout.readline().split()[1]\n"
        "assert ep.startswith('tpu://127.0.0.1:'), ep\n"
        "ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=30000)).init(ep)\n"
        "echo = rpc.Stub(ch, echo_pb2.DESCRIPTOR.services_by_name"
        "['EchoService'])\n"
        "data = bytes(range(256)) * 4096\n"
        "b0 = transport.g_tunnel_borrowed_bytes.get_value()\n"
        "assert echo.Echo(echo_pb2.EchoRequest(message='m',"
        " payload=data)).payload == data\n"
        "assert transport.g_tunnel_borrowed_bytes.get_value() - b0 >="
        " len(data)\n"
        "dsvc = rpc.Stub(ch, dpb.DESCRIPTOR.services_by_name"
        "['DeviceDataService'])\n"
        "c = rpc.Controller(); c.request_attachment = data[:5000]\n"
        "h = dsvc.Put(dpb.DeviceHandle(), controller=c).handle\n"
        "g = rpc.Controller()\n"
        "dsvc.Get(dpb.DeviceHandle(handle=h), controller=g)\n"
        "assert g.response_attachment == data[:5000]\n"
        "local = rpc.Stub(rpc.Channel().init('tpu://localhost/0'),"
        " echo_pb2.DESCRIPTOR.services_by_name['EchoService'])\n"
        "assert local.Echo(echo_pb2.EchoRequest(payload=data[:99]))"
        ".payload == data[:99]\n"
        "out, _ = child.communicate(timeout=60)\n"
        "assert child.returncode == 0, out\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n"
        "served = [x for x in out.splitlines() if x.startswith('SERVED ')]\n"
        "assert '\"foreign_modules\": []' in served[0], served\n")

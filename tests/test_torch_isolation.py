"""The port stands alone: brpc_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package (brpc_tpu or brpc_tpu.*), nor
protobuf: the card's machine has none, and every wire message of the port
(the RPC front's and DeviceDataService's) is a table of its own message
runtime."""

import ast
import os
import re
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
    # ``tools`` is the JAX package's top-level tools directory: under
    # pytest, ``from tools import ...`` silently loads the reference's
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tools") or top == "brpc_tpu"


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
    assert _forbidden("tools") and _forbidden("tools.rpc_press")
    assert not _forbidden("brpc_tpu_torch.serving")
    assert not _forbidden("brpc_tpu_torch.tools.rpc_press")


_FACTORY = re.compile(r"^[A-Za-z_][\w.]*:[A-Za-z_]\w*$")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_string_import_path_names_a_forbidden_module(path):
    """A ``"module:attr"`` string (a shard factory, a worker entry) is an
    import the AST walk above does not see: none may name JAX, the JAX
    package or the top-level ``tools``."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = [(n.lineno, n.value) for n in ast.walk(tree)
           if isinstance(n, ast.Constant) and isinstance(n.value, str)
           and _FACTORY.match(n.value)
           and _forbidden(n.value.partition(":")[0])]
    assert not bad, f"{os.path.relpath(path, REPO)} names {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, brpc_tpu_torch.serving, brpc_tpu_torch.tpu.pallas_ops,"
            " brpc_tpu_torch.tpu._build, brpc_tpu_torch.serving.weights,"
            " brpc_tpu_torch.tpu.train, brpc_tpu_torch.tpu.ring,"
            " brpc_tpu_torch.tpu.bench_kernels, brpc_tpu_torch.tpu.device_lane,"
            " brpc_tpu_torch.tpu.tpusocket, brpc_tpu_torch.tpu.transport,"
            " brpc_tpu_torch.tpu.device_stream, brpc_tpu_torch.tpu.mesh,"
            " brpc_tpu_torch.rpc.circuit_breaker,"
            " brpc_tpu_torch.rpc.combo_channels,"
            " brpc_tpu_torch.rpc.health_check,"
            " brpc_tpu_torch.policy.naming,"
            " brpc_tpu_torch.policy.load_balancers,"
            " brpc_tpu_torch.proto.collective_pb2,"
            " brpc_tpu_torch.graft_entry,"
            " brpc_tpu_torch.analysis.runtime_check,"
            " brpc_tpu_torch.serving.router, brpc_tpu_torch.serving.qos,"
            " brpc_tpu_torch.batch, brpc_tpu_torch.policy.retry,"
            " brpc_tpu_torch.bench.qos_replay\n"
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


def test_the_walk_reaches_this_slices_modules():
    """The import checks above walk every module of the package: the
    router, QoS, the batcher, the retry policies and their examples and
    benches among them."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    want = {"serving/router.py", "serving/qos.py", "batch/__init__.py",
            "batch/policy.py", "batch/metrics.py", "batch/queue.py",
            "batch/runtime.py", "policy/retry.py", "bench/batch_lane.py",
            "bench/qos_replay.py", "examples/batched_inference/server.py",
            "examples/batched_inference/client.py",
            "examples/parallel_echo/client.py",
            "examples/selective_echo/client.py",
            "examples/partition_echo/client.py",
            "examples/backup_request/client.py",
            "examples/multi_threaded_echo/client.py"}
    assert want <= rel, sorted(want - rel)


def test_routed_qos_generate_and_a_batched_call_load_no_protobuf_or_jax():
    """A Generate through ShardedLlmChannel onto a QoS engine, and a
    batched echo through the batcher, with neither protobuf nor JAX
    loaded."""
    _run(
        "import sys\n"
        "import brpc_tpu_torch.rpc as rpc\n"
        "import brpc_tpu_torch.serving.service as service\n"
        "from brpc_tpu_torch.batch import make_batched\n"
        "from brpc_tpu_torch.proto import echo_pb2, serving_pb2\n"
        "from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,"
        " ModelConfig, PagedKVCache, QosConfig, ServingEngine,"
        " ShardedLlmChannel, TinyTransformer)\n"
        "cfg = ModelConfig(vocab=64, d_model=16, n_heads=2, n_layers=1)\n"
        "kv = PagedKVCache(KVCacheConfig(16, 16), cfg.n_layers, cfg.kv_dim,"
        " device='cpu')\n"
        "eng = ServingEngine(TinyTransformer(cfg, kv), kv,"
        " EngineConfig(idle_wait_s=0.005, qos=QosConfig("
        "tenants={'prod': 2.0}))).start()\n"
        "srv = rpc.Server().add_service(service.LlmServingService(eng))"
        ".start('127.0.0.1:0')\n"
        "ch = ShardedLlmChannel(f'list://{srv.listen_endpoint()} 0/1', 1)\n"
        "c = rpc.Controller(); c.tenant_id = 'prod'; c.priority = 1\n"
        "resp = ch.generate(serving_pb2.GenerateRequest(prompt_len=20,"
        " max_new_tokens=4), controller=c, timeout_ms=30000)\n"
        "assert len(resp.tokens) == 4, resp\n"
        "assert eng.qos.snapshot()['tenants']['prod']['admitted'] == 1\n"
        "class Svc(rpc.Service):\n"
        "    pass\n"
        "svc = Svc()\n"
        "svc.add_method('Echo', make_batched('t', lambda b: ["
        "echo_pb2.EchoResponse(message=r.message) for r in b.requests]),"
        " echo_pb2.EchoRequest, echo_pb2.EchoResponse)\n"
        "bsrv = rpc.Server().add_service(svc).start('127.0.0.1:0')\n"
        "md = rpc.MethodDescriptor('Svc', 'Echo', echo_pb2.EchoRequest,"
        " echo_pb2.EchoResponse)\n"
        "out = rpc.Channel(rpc.ChannelOptions(timeout_ms=30000)).init("
        "str(bsrv.listen_endpoint())).call_method(md,"
        " echo_pb2.EchoRequest(message='b'))\n"
        "assert out.message == 'b', out\n"
        "bsrv.stop(); bsrv.join(); srv.stop(); srv.join(); eng.stop()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n")


HTTP_SLICE = {
    "json2pb.py", "policy/http_protocol.py", "policy/http_server.py",
    "rpc/progressive.py", "butil/vlog.py", "profiling/diff.py",
    "fleet/__init__.py", "fleet/merge.py", "builtin/__init__.py",
    "builtin/services.py", "builtin/profiling.py", "builtin/series_plot.py",
    "builtin/grpc_health.py", "builtin/view_service.py",
    "proto/health_pb2.py", "proto/builtin_view_pb2.py",
    "proto/jsonpb_test_pb2.py", "proto/jsonpb_test2_pb2.py",
    "examples/http/server.py", "examples/dashboard_proxy/client.py",
    "tools/rpc_view.py"}


def test_the_walk_reaches_the_http_slices_modules():
    """The import checks above walk HTTP, json2pb, the progressive
    attachment, the builtin services, their message tables and the
    examples over them."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert HTTP_SLICE <= rel, sorted(HTTP_SLICE - rel)


def test_importing_the_http_slice_loads_no_protobuf_or_jax():
    mods = sorted("brpc_tpu_torch." + m[:-3].replace("/", ".")
                  .replace(".__init__", "") for m in HTTP_SLICE)
    _run(f"import sys\nimport {', '.join(mods)}\n"
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
         "assert not bad, bad\n")


def test_an_http_generate_and_a_serving_fetch_load_no_protobuf_or_jax():
    """Generate over JSON and over binary pb through the HTTP front, a
    ``/serving`` and a ``/status`` fetch, and the Health service over
    trpc_std, with neither protobuf nor JAX loaded."""
    _run(
        "import json, sys\n"
        "import brpc_tpu_torch.rpc as rpc\n"
        "import brpc_tpu_torch.serving.service as service\n"
        "from brpc_tpu_torch.policy.http_protocol import http_fetch\n"
        "from brpc_tpu_torch.proto import health_pb2, serving_pb2\n"
        "from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,"
        " ModelConfig, PagedKVCache, ServingEngine, TinyTransformer)\n"
        "cfg = ModelConfig(vocab=64, d_model=16, n_heads=2, n_layers=1)\n"
        "kv = PagedKVCache(KVCacheConfig(16, 16), cfg.n_layers, cfg.kv_dim,"
        " device='cpu')\n"
        "eng = ServingEngine(TinyTransformer(cfg, kv), kv,"
        " EngineConfig(idle_wait_s=0.005)).start()\n"
        "srv = rpc.Server().add_service(service.LlmServingService(eng))"
        ".start('127.0.0.1:0')\n"
        "ep = str(srv.listen_endpoint())\n"
        "r = http_fetch(ep, 'POST', '/LlmService/Generate', body=json.dumps("
        "{'prompt_len': 20, 'max_new_tokens': 4}).encode(), timeout=30)\n"
        "assert r.status == 200 and len(json.loads(r.body)['tokens']) == 4,"
        " r.body\n"
        "ch = rpc.Channel(rpc.ChannelOptions(protocol='http',"
        " timeout_ms=30000)).init(ep)\n"
        "resp = rpc.Stub(ch, serving_pb2.DESCRIPTOR.services_by_name"
        "['LlmService']).Generate(serving_pb2.GenerateRequest(prompt_len=20,"
        " max_new_tokens=4))\n"
        "assert list(resp.tokens) == json.loads(r.body)['tokens'], resp\n"
        "page = json.loads(http_fetch(ep, 'GET', '/serving?format=json')"
        ".body)\n"
        "assert page['engines'][-1]['tokens_generated'] == 8, page\n"
        "assert b'Generate: count=2' in http_fetch(ep, 'GET', '/status')"
        ".body\n"
        "h = rpc.Stub(rpc.Channel().init(ep), health_pb2.DESCRIPTOR"
        ".services_by_name['Health']).Check(health_pb2.HealthCheckRequest())\n"
        "assert h.status == health_pb2.HealthCheckResponse.SERVING\n"
        "srv.stop(); srv.join(); eng.stop()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n")


NATIVE_SLICE = {"native/__init__.py", "rpc/native_transport.py",
                "bench/native_lane.py",
                "examples/transport_sweep/client.py"}


def test_the_walk_reaches_the_native_slices_modules():
    """The import checks above walk the native core's loader, the engine's
    Python veneer, its bench and the transport sweep example; the C++
    sources sit beside the loader."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert NATIVE_SLICE <= rel, sorted(NATIVE_SLICE - rel)
    for src in ("core.cpp", "dataplane.cpp", "hpack_tables.h"):
        assert os.path.exists(os.path.join(PKG, "native", src))


def test_a_native_generate_loads_no_protobuf_or_jax():
    """A unary and a streamed Generate through a native_dataplane server
    and a native_transport Channel over the engine's tunnel, with neither
    protobuf nor JAX loaded, and no reference library mapped."""
    _run(
        "import sys, threading\n"
        "import brpc_tpu_torch.rpc as rpc\n"
        "import brpc_tpu_torch.rpc.stream as st\n"
        "import brpc_tpu_torch.serving.service as service\n"
        "from brpc_tpu_torch.proto import serving_pb2\n"
        "from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,"
        " ModelConfig, PagedKVCache, ServingEngine, TinyTransformer)\n"
        "cfg = ModelConfig(vocab=64, d_model=16, n_heads=2, n_layers=1)\n"
        "kv = PagedKVCache(KVCacheConfig(16, 16), cfg.n_layers, cfg.kv_dim,"
        " device='cpu')\n"
        "eng = ServingEngine(TinyTransformer(cfg, kv), kv,"
        " EngineConfig(idle_wait_s=0.005)).start()\n"
        "srv = rpc.Server(rpc.ServerOptions(native_dataplane=True))\n"
        "srv.add_service(service.LlmServingService(eng))"
        ".start('tpu://127.0.0.1:0/0')\n"
        "ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=30000,"
        " native_transport=True)).init(str(srv.listen_endpoint()))\n"
        "stub = rpc.Stub(ch, serving_pb2.DESCRIPTOR.services_by_name"
        "['LlmService'])\n"
        "r = stub.Generate(serving_pb2.GenerateRequest(prompt_len=8,"
        " max_new_tokens=3))\n"
        "assert len(r.tokens) == 3, r\n"
        "done = threading.Event()\n"
        "sid = st.stream_create(st.StreamOptions(on_received=lambda s, m:"
        " done.set()))\n"
        "c = rpc.Controller(); c.stream_id = sid\n"
        "r2 = stub.Generate(serving_pb2.GenerateRequest(prompt_len=8,"
        " max_new_tokens=3), controller=c)\n"
        "assert list(r2.tokens) == list(r.tokens)\n"
        "assert done.wait(10)\n"
        "maps = open('/proc/self/maps').read()\n"
        "srv.stop(); srv.join(); eng.stop()\n"
        "assert 'brpc_tpu/native/_' not in maps\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n")


def test_a_native_server_without_a_compiler_raises_and_opens_no_listener(
        tmp_path):
    """With no g++ on PATH and an empty build directory, a native
    dataplane server's start raises NativeBuildError and the process holds
    no listening socket: nothing falls back to the Python acceptor."""
    code = (
        "import os, sys\n"
        "from brpc_tpu_torch import native\n"
        f"native.BUILD_DIR = {str(tmp_path / 'build')!r}\n"
        "import brpc_tpu_torch.rpc as rpc\n"
        "def listening():\n"
        "    inodes = set()\n"
        "    for fd in os.listdir('/proc/self/fd'):\n"
        "        try:\n"
        "            link = os.readlink(f'/proc/self/fd/{fd}')\n"
        "        except OSError:\n"
        "            continue\n"
        "        if link.startswith('socket:['):\n"
        "            inodes.add(link[8:-1])\n"
        "    n = 0\n"
        "    for table in ('tcp', 'tcp6'):\n"
        "        for line in open(f'/proc/self/net/{table}').readlines()[1:]:\n"
        "            f = line.split()\n"
        "            if f[3] == '0A' and f[9] in inodes:\n"
        "                n += 1\n"
        "    return n\n"
        "srv = rpc.Server(rpc.ServerOptions(native_dataplane=True))\n"
        "for addr in ('127.0.0.1:0', 'tpu://127.0.0.1:0/0'):\n"
        "    try:\n"
        "        srv.start(addr)\n"
        "    except native.NativeBuildError as e:\n"
        "        print('RAISED', str(e)[:60].replace(chr(10), ' '))\n"
        "    else:\n"
        "        print('STARTED')\n"
        "    assert srv._listen_sock is None and srv._native_lid is None\n"
        "    assert srv.listen_endpoint() is None\n"
        "    assert listening() == 0, listening()\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1] == "OK" and "STARTED" not in lines, lines
    assert sum(x.startswith("RAISED") for x in lines) == 2, lines


PROTOCOL_SLICE = {
    "policy/h2.py", "policy/hpack.py", "policy/grpc_protocol.py",
    "policy/redis_protocol.py", "policy/mongo_protocol.py",
    "policy/bson.py", "policy/rtmp.py", "policy/amf0.py",
    "policy/thrift_protocol.py", "policy/memcache.py", "policy/nshead.py",
    "examples/grpc_echo/server.py", "examples/grpc_echo/client.py",
    "examples/redis_kv/server.py", "examples/mongo_kv/client.py",
    "examples/rtmp_live/client.py"}


def test_the_walk_reaches_the_protocol_slices_modules():
    """The import checks above walk h2, HPACK, gRPC, the six other wire
    protocols, their codecs and the examples over them."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert PROTOCOL_SLICE <= rel, sorted(PROTOCOL_SLICE - rel)


def test_importing_the_protocol_slice_loads_no_protobuf_or_jax():
    mods = sorted("brpc_tpu_torch." + m[:-3].replace("/", ".")
                  for m in PROTOCOL_SLICE)
    _run(f"import sys\nimport {', '.join(mods)}\n"
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
         "assert not bad, bad\n")


def test_a_grpc_generate_on_both_lanes_loads_no_protobuf_or_jax():
    """Unary Generates over gRPC on the Python h2 lane and on the engine's
    h2 lane, a Health Check over gRPC and a redis round trip on the same
    port, with neither protobuf nor JAX loaded."""
    _run(
        "import sys\n"
        "import brpc_tpu_torch.rpc as rpc\n"
        "import brpc_tpu_torch.serving.service as service\n"
        "from brpc_tpu_torch.policy import redis_protocol as rp\n"
        "from brpc_tpu_torch.proto import health_pb2, serving_pb2\n"
        "from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,"
        " ModelConfig, PagedKVCache, ServingEngine, TinyTransformer)\n"
        "cfg = ModelConfig(vocab=64, d_model=16, n_heads=2, n_layers=1)\n"
        "kv = PagedKVCache(KVCacheConfig(16, 16), cfg.n_layers, cfg.kv_dim,"
        " device='cpu')\n"
        "eng = ServingEngine(TinyTransformer(cfg, kv), kv,"
        " EngineConfig(idle_wait_s=0.005)).start()\n"
        "svc = rp.RedisService()\n"
        "svc.add_command_handler('ping', lambda a: rp.RedisReply("
        "rp.REPLY_STRING, 'PONG'))\n"
        "toks = []\n"
        "for native in (False, True):\n"
        "    srv = rpc.Server(rpc.ServerOptions(native_dataplane=native,"
        " redis_service=svc))\n"
        "    srv.add_service(service.LlmServingService(eng))"
        ".start('127.0.0.1:0')\n"
        "    ep = str(srv.listen_endpoint())\n"
        "    ch = rpc.Channel(rpc.ChannelOptions(protocol='grpc',"
        " timeout_ms=30000, native_transport=native)).init(ep)\n"
        "    r = rpc.Stub(ch, serving_pb2.DESCRIPTOR.services_by_name"
        "['LlmService']).Generate(serving_pb2.GenerateRequest(prompt_len=8,"
        " max_new_tokens=3))\n"
        "    toks.append(list(r.tokens))\n"
        "    h = rpc.Stub(ch, health_pb2.DESCRIPTOR.services_by_name"
        "['Health']).Check(health_pb2.HealthCheckRequest())\n"
        "    assert h.status == health_pb2.HealthCheckResponse.SERVING\n"
        "    rc = rpc.Channel(rpc.ChannelOptions(protocol='redis',"
        " timeout_ms=30000)).init(ep)\n"
        "    resp = rc.call_method(rp.redis_method(),"
        " rp.RedisRequest().add_command('ping'))\n"
        "    assert resp.reply(0).value == 'PONG', resp.reply(0)\n"
        "    srv.stop(); srv.join()\n"
        "eng.stop()\n"
        "assert len(toks[0]) == 3 and toks[0] == toks[1], toks\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n")


HOST_SLICE = {
    "shard/__init__.py", "shard/wire.py", "shard/ring.py",
    "shard/subwindow.py", "shard/fleet.py", "shard/worker.py",
    "shard/plane.py", "shard/testing.py", "fleet/observer.py",
    "fleet/slo.py", "policy/auth.py", "trace/diff.py", "analysis/core.py",
    "analysis/rules.py", "analysis/__main__.py"}


def test_every_reference_module_has_a_port_at_the_same_path():
    """Each ``brpc_tpu/**/*.py`` has a file at the same relative path
    under ``brpc_tpu_torch/``, the last host modules among them."""
    ref = os.path.join(REPO, "brpc_tpu")
    missing = []
    for dirpath, dirnames, filenames in os.walk(ref):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ref)
                if not os.path.exists(os.path.join(PKG, rel)):
                    missing.append(rel)
    assert not missing, sorted(missing)
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert HOST_SLICE <= rel, sorted(HOST_SLICE - rel)


def test_a_sharded_server_an_observer_and_auth_load_no_protobuf_or_jax():
    """A sharded tunnel server answers through its workers, a fleet
    observer scrapes it, an authenticated call goes through, and neither
    this process nor a worker has loaded protobuf or JAX."""
    _run(
        "import sys\n"
        "from brpc_tpu_torch import flags\n"
        "import brpc_tpu_torch.rpc as rpc\n"
        "from brpc_tpu_torch.fleet import FleetObserver\n"
        "from brpc_tpu_torch.policy.auth import SharedSecretAuthenticator\n"
        "from brpc_tpu_torch.proto import echo_pb2\n"
        "from brpc_tpu_torch.shard.testing import ShardEchoService\n"
        "E = echo_pb2.DESCRIPTOR.services_by_name['EchoService']\n"
        "flags.set_flag('tpu_shard_workers', 1)\n"
        "srv = rpc.Server().add_service(ShardEchoService())"
        ".start('tpu://127.0.0.1:0/0')\n"
        "assert srv._shard_plane.wait_ready(30)\n"
        "pid = srv._shard_plane.workers[0].pid\n"
        "stub = rpc.Stub(rpc.Channel().init(str(srv.listen_endpoint())), E)\n"
        "assert stub.Echo(echo_pb2.EchoRequest(message='s')).message == 's'\n"
        "assert srv._shard_plane.forwarded == 1\n"
        "maps = open(f'/proc/{pid}/maps').read()\n"
        "assert 'google/protobuf' not in maps and '/jax' not in maps\n"
        "obs = FleetObserver([str(srv.listen_endpoint()).split('/')[2]])\n"
        "assert obs.scrape_once() == 1, obs.members()[0].last_error\n"
        "srv.stop(); srv.join()\n"
        "flags.set_flag('tpu_shard_workers', 0)\n"
        "auth = SharedSecretAuthenticator(b'k')\n"
        "a = rpc.Server(rpc.ServerOptions(auth=auth))"
        ".add_service(ShardEchoService()).start('127.0.0.1:0')\n"
        "ch = rpc.Channel(rpc.ChannelOptions(auth=auth))"
        ".init(str(a.listen_endpoint()))\n"
        "assert rpc.Stub(ch, E).Echo(echo_pb2.EchoRequest(message='a'))"
        ".message == 'a'\n"
        "a.stop(); a.join()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n")


TOOLS_SLICE = {
    "tools/__init__.py", "tools/rpc_press.py", "tools/rpc_replay.py",
    "tools/rpc_view.py", "tools/bench_server.py",
    "tools/record_serving_corpus.py", "tools/record_serving_corpus_overload.py",
    "tools/record_serving_corpus_spec.py", "bench/qos_replay.py",
    "bench/qos_stalls.py",
    # the kernel and operator tools
    "tools/kernel_bench.py", "tools/causal_sweep.py", "tools/qgrid_sweep.py",
    "tools/trace_diff.py", "tools/prof_diff.py", "tools/trace_view.py",
    "tools/vars_view.py", "tools/flame_view.py", "tools/chaos_run.py",
    "tools/tpulint.py",
    # the last tools: the fuzzer, the probe and the generators
    "tools/fuzz.py", "tools/subinterp_probe.py", "tools/_proto_schema.py",
    "tools/gen_hpack_tables.py", "tools/gen_press_echo_desc.py",
    "tools/gen_rpc_meta_proto.py", "tools/gen_serving_proto.py"}


def test_the_walk_reaches_the_tools_slices_modules():
    """The import checks above walk the traffic, kernel and operator
    tools and the benches over them."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    assert TOOLS_SLICE <= rel, sorted(TOOLS_SLICE - rel)


def test_every_reference_tool_is_ported_or_queued():
    """Each ``tools/*.py`` of the JAX package has a file of the same name
    under ``brpc_tpu_torch/tools/``: ROADMAP.md's Queue 1 of tools still
    to port is empty, so a tool cannot go missing unnoticed."""
    missing = [f for f in sorted(os.listdir(os.path.join(REPO, "tools")))
               if f.endswith(".py")
               and not os.path.exists(os.path.join(PKG, "tools", f))]
    assert not missing, missing


def test_the_tools_load_no_protobuf_or_jax():
    """Every module of the tools slices imports, and a port press, a
    replay of the committed corpus, an operator tool's fetch, a lint run,
    a fuzz of the h2 parser and a generator's descriptor, with neither
    protobuf nor JAX loaded."""
    mods = sorted("brpc_tpu_torch." + m[:-3].replace("/", ".")
                  .replace(".__init__", "") for m in TOOLS_SLICE)
    _run(f"import sys\nimport {', '.join(mods)}\n"
         "import brpc_tpu_torch.rpc as rpc\n"
         "from brpc_tpu_torch.proto import echo_pb2\n"
         "from brpc_tpu_torch.tools import rpc_press, rpc_replay\n"
         "class E(rpc.Service):\n"
         "    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name['EchoService']\n"
         "    def Echo(self, cntl, request, done):\n"
         "        return echo_pb2.EchoResponse(message=request.message)\n"
         "srv = rpc.Server().add_service(E()).start('127.0.0.1:0')\n"
         "ep = str(srv.listen_endpoint())\n"
         "assert rpc_press.main(['--server', ep, '--descriptor-set',"
         " 'tests/data/press_echo.desc', '--full-method',"
         " 'press.test.EchoService.Echo', '--qps', '50', '--duration',"
         " '0.2', '--quiet']) == 0\n"
         "items, skipped = rpc_replay.load_items('tests/data/serving_corpus')\n"
         "assert len(items) == 12 and not skipped\n"
         "from brpc_tpu_torch.tools import tpulint, trace_view, vars_view\n"
         "assert trace_view._fetch(ep)['spans'] is not None\n"
         "assert 'series' in vars_view.fetch(ep, 'g_*')\n"
         "assert tpulint.main(['--list-rules']) == 0\n"
         "from brpc_tpu_torch.tools import fuzz, gen_serving_proto\n"
         "assert fuzz.run_target('h2', 100) == 100\n"
         "assert gen_serving_proto.build()\n"
         "srv.stop(); srv.join()\n"
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'brpc_tpu', 'tools') or "
         "m.startswith('google.protobuf'))\n"
         "assert not bad, bad\n")

"""The port's in-process ``tpu://host/n`` lane (brpc_tpu_torch.tpu.tpusocket)
and DeviceDataService on the port's Server, against the JAX package's.

The reference's cases of ``tests/test_tpu.py::TestTpuSocket`` and
``tests/test_device_lane.py``'s RPC cases run through both packages'
Channels; the JAX lane runs on the conftest's eight CPU devices, the
port's on the CPU through ``mesh.use_cpu(8)`` (the one place a caller
asks for the CPU). Then ``DeviceDataService`` answers one script of
Put / Copy / Copy -k / Pump / Get / Free / Stats on each package's Server
over TCP and over the ``tpu://`` tunnel, and in process through
``tpu://localhost/0``. Tolerance 0: serialized responses, attachments,
error codes and the ``g_device_*`` deltas must be equal, with one
recorded exception: a Pump over 600 rows crosses the JAX copy's unwritten
tail (ROADMAP Queue 3), where the port's checksum is the payload's and
the JAX one is not.

Every test fences both stores before it ends (a JAX process whose last
device op was an unfenced transient copy can abort at exit).
"""

import threading

import numpy as np
import pytest
import torch

import brpc_tpu.rpc as jax_rpc
import brpc_tpu_torch.rpc as port_rpc
from brpc_tpu.proto import device_lane_pb2 as jax_dpb
from brpc_tpu.proto import echo_pb2 as jax_echo
from brpc_tpu.tpu import device_lane as jax_dl
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.proto import device_lane_pb2 as port_dpb
from brpc_tpu_torch.proto import echo_pb2 as port_echo
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.tpu import device_lane as port_dl
from brpc_tpu_torch.tpu import mesh, pallas_ops, tpusocket

SIDES = {"jax": (jax_rpc, jax_echo, jax_dpb, jax_dl),
         "port": (port_rpc, port_echo, port_dpb, port_dl)}
ADDERS = ("g_device_resident_bytes", "g_device_moved_bytes",
          "g_device_fused_launches", "g_device_fused_ops",
          "g_device_host_syncs")


@pytest.fixture(autouse=True)
def _close_new_tunnels():
    """Close the client tunnels a test dialed, in both packages, when it
    ends: a stale cached tunnel would otherwise outlive its server in
    this process and be found by a later test's cache lookup."""
    from brpc_tpu.tpu import transport as jax_tr
    from brpc_tpu_torch.tpu import transport as port_tr

    before = {tr: set(tr._remote_sockets) for tr in (jax_tr, port_tr)}
    yield
    for tr, keys in before.items():
        with tr._remote_lock:
            new = [(k, vs) for k, vs in tr._remote_sockets.items()
                   if k not in keys]
            for k, _ in new:
                del tr._remote_sockets[k]
        for _, vs in new:
            vs.endpoint.close()


@pytest.fixture(autouse=True)
def cpu_ordinals():
    mesh.use_cpu(8)
    yield
    jax_dl.global_store().fence()
    port_dl.global_store("cpu").fence()
    mesh.use_cpu(0)


def _payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _echo_stub(side, target):
    rpc, pb = SIDES[side][:2]
    ch = rpc.Channel(rpc.ChannelOptions(protocol="trpc_std",
                                        timeout_ms=10000)).init(target)
    return rpc.Stub(ch, pb.DESCRIPTOR.services_by_name["EchoService"])


# ---------------------------------------------------------------------------
# tests/test_tpu.py::TestTpuSocket, both packages
# ---------------------------------------------------------------------------
def test_echo_through_device():
    payload = bytes(range(256)) * 64
    out = []
    for side in ("jax", "port"):
        pb = SIDES[side][1]
        resp = _echo_stub(side, "tpu://localhost/0").Echo(
            pb.EchoRequest(message="via-hbm", payload=payload))
        assert resp.message == "via-hbm" and resp.payload == payload
        out.append(resp.SerializeToString())
    assert out[0] == out[1]


@pytest.mark.parametrize("size", [0, 13, 4096, 4097, 1 << 20])
def test_attachment_rides_device(size):
    att = _payload(size, seed=size) if size else b"DEVICE-ATTACH"
    out = []
    for side in ("jax", "port"):
        rpc, pb = SIDES[side][:2]
        cntl = rpc.Controller()
        cntl.request_attachment = att
        resp = _echo_stub(side, "tpu://localhost/1").Echo(
            pb.EchoRequest(message="a", payload=att[:7]), controller=cntl)
        assert cntl.response_attachment == att
        out.append((resp.SerializeToString(), cntl.response_attachment))
    assert out[0] == out[1]


def test_echo_launches_the_copy_kernel_once_per_nonempty_call(monkeypatch):
    """On a card the echo is host -> card, one hbm_copy launch, card ->
    host; an empty echo launches nothing. Recorded here through a stub
    of the wrapper (the card itself is held in chip_smoke.py)."""
    from brpc_tpu_torch.tpu import bench_kernels

    seen = []

    def hbm_copy(x):
        seen.append((x.dtype, x.numel()))
        return x.clone()

    monkeypatch.setattr(bench_kernels, "hbm_copy", hbm_copy)
    stub = _echo_stub("port", "tpu://localhost/0")
    cntl = port_rpc.Controller()
    cntl.request_attachment = b"tail"
    stub.Echo(port_echo.EchoRequest(message="m", payload=b"12345"),
              controller=cntl)
    stub.Echo(port_echo.EchoRequest(message="empty"))
    assert seen == [(torch.uint8, 9)]
    assert cntl.response_attachment == b"tail"


def test_unknown_device_method():
    codes = []
    for side in ("jax", "port"):
        rpc, pb = SIDES[side][:2]
        ch = rpc.Channel().init("tpu://localhost/0")
        md = rpc.MethodDescriptor("NoSvc", "NoMeth", pb.EchoRequest,
                                  pb.EchoResponse)
        with pytest.raises(rpc.RpcError) as ei:
            ch.call_method(md, pb.EchoRequest(message="x"))
        codes.append(ei.value.error_code)
    assert codes == [errors.ENOMETHOD] * 2


def test_custom_device_method():
    import jax.numpy as jnp

    from brpc_tpu.tpu.tpusocket import register_device_method as jax_reg

    def make(pb, reverse):
        def handler(device, meta, payload, attachment):
            req = pb.EchoRequest()
            req.ParseFromString(payload)
            resp = pb.EchoResponse(message=req.message[::-1],
                                   payload=reverse(req.payload, device))
            return errors.OK, resp.SerializeToString(), b""
        return handler

    jax_reg("RevService", "Reverse", make(
        jax_echo, lambda b, d: bytes(np.asarray(
            jnp.asarray(bytearray(b), dtype=jnp.uint8)[::-1]))))
    tpusocket.register_device_method("RevService", "Reverse", make(
        port_echo, lambda b, d: torch.frombuffer(bytearray(b),
                                                 dtype=torch.uint8)
        .to(d).flip(0).cpu().numpy().tobytes()))
    out = []
    for side in ("jax", "port"):
        rpc, pb = SIDES[side][:2]
        ch = rpc.Channel().init("tpu://localhost/2")
        md = rpc.MethodDescriptor("RevService", "Reverse", pb.EchoRequest,
                                  pb.EchoResponse)
        resp = ch.call_method(md, pb.EchoRequest(message="abc",
                                                 payload=b"1234"))
        assert resp.message == "cba" and resp.payload == b"4321"
        out.append(resp.SerializeToString())
    assert out[0] == out[1]


def test_device_crash_fault_answers_einternal_and_the_socket_survives():
    from brpc_tpu_torch import fault, flags

    stub = _echo_stub("port", "tpu://localhost/3")
    flags.set_flag("fault_injection_enabled", "true")
    fault.arm("tpu.device.crash")
    try:
        with pytest.raises(port_rpc.RpcError) as ei:
            stub.Echo(port_echo.EchoRequest(message="boom"))
    finally:
        fault.disarm("tpu.device.crash")
        flags.set_flag("fault_injection_enabled", "false")
    assert ei.value.error_code == errors.EINTERNAL
    assert stub.Echo(port_echo.EchoRequest(message="ok")).message == "ok"


# ---------------------------------------------------------------------------
# tests/test_device_lane.py's RPC cases, both packages
# ---------------------------------------------------------------------------
def test_tpusocket_device_service_inprocess():
    blob = b"\x42" * 8192
    out = []
    for side in ("jax", "port"):
        rpc, _, dpb, _ = SIDES[side]
        ch = rpc.Channel(rpc.ChannelOptions(protocol="trpc_std",
                                            timeout_ms=10000))
        ch.init("tpu://localhost/0")
        stub = rpc.Stub(ch, dpb.DESCRIPTOR.services_by_name[
            "DeviceDataService"])
        cntl = rpc.Controller()
        cntl.request_attachment = blob
        put = stub.Put(dpb.DeviceHandle(), controller=cntl)
        assert put.nbytes == len(blob)
        cp = stub.Copy(dpb.DeviceHandle(handle=put.handle))
        cg = rpc.Controller()
        got = stub.Get(dpb.DeviceHandle(handle=cp.handle), controller=cg)
        assert cg.response_attachment == blob
        out.append((put.nbytes, cp.nbytes, got.nbytes,
                    cg.response_attachment))
    assert out[0] == out[1]


def test_tpusocket_pipelined_echo_overlap():
    n = 12
    out = []
    for side in ("jax", "port"):
        pb = SIDES[side][1]
        stub = _echo_stub(side, "tpu://localhost/0")
        done_ev = threading.Event()
        results, lock = [], threading.Lock()

        def make_done(i):
            def done(cntl):
                with lock:
                    results.append((i, cntl.error_code,
                                    cntl.response.payload if cntl.response
                                    else b""))
                    if len(results) == n:
                        done_ev.set()
            return done

        for i in range(n):
            stub.Echo(pb.EchoRequest(message=str(i),
                                     payload=bytes([i]) * 4096),
                      done=make_done(i))
        assert done_ev.wait(30)
        for i, code, payload in results:
            assert code == errors.OK and payload == bytes([i]) * 4096
        out.append(sorted(results))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# tpu:// naming: cuda unless the CPU was asked for, never a fallback
# ---------------------------------------------------------------------------
def test_ordinals_resolve_to_the_cards_and_raise_without_one(monkeypatch):
    ep = EndPoint.parse
    assert mesh.resolve_device(ep("tpu://localhost/7")) == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="ordinal 8"):
        mesh.resolve_device(ep("tpu://localhost/8"))
    with pytest.raises(ValueError, match="not a tpu endpoint"):
        mesh.resolve_device(ep("127.0.0.1:80"))
    mesh.use_cpu(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.resolve_device(ep("tpu://localhost/0"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpusocket.TpuSocket(ep("tpu://localhost/0"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.resolve_device(ep("tpu://h/1")) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="ordinal 2"):
        mesh.resolve_device(ep("tpu://h/2"))
    with pytest.raises(ValueError):
        mesh.use_cpu(-1)


# ---------------------------------------------------------------------------
# DeviceDataService on each package's Server: one script, equal answers
# ---------------------------------------------------------------------------
PUMP_ROWS = 600   # crosses the JAX copy's 512-row blocks


def _rpc_script(dpb):
    """(method, request, attachment) in one order both services run."""
    H = dpb.DeviceHandle
    return [
        ("Put", H(), _payload(3 * 8192 + 11, seed=8)),        # handle 1
        ("Put", H(), bytes(range(256)) * 512),                # handle 2
        ("Put", H(), _payload(PUMP_ROWS * 8192, seed=12)),    # handle 3
        ("Copy", H(handle=1, nbytes=0), b""),                 # handle 4
        ("Copy", H(handle=1, nbytes=-1), b""),
        ("Copy", H(handle=2, nbytes=-40), b""),               # 32 + 8
        ("Copy", H(handle=77, nbytes=0), b""),                # ENOMETHOD
        ("Pump", dpb.PumpRequest(handle=2, rounds=3), b""),
        ("Pump", dpb.PumpRequest(handle=3, rounds=1), b""),   # the tail
        ("Get", H(handle=4), b""),
        ("Get", H(handle=77), b""),                           # ENOMETHOD
        ("Stats", dpb.DeviceStatsRequest(fence=False), b""),
        ("Free", H(handle=4), b""),
        ("Free", H(handle=4), b""),                           # handle 0
        ("Stats", dpb.DeviceStatsRequest(fence=True), b""),
    ]


TAIL_CALL = 8


def _adders(dl):
    return [getattr(dl, name).get_value() for name in ADDERS]


def _run_script(side, target):
    """The script through ``side``'s Channel; returns (results, g_device
    deltas)."""
    rpc, _, dpb, dl = SIDES[side]
    ch = rpc.Channel(rpc.ChannelOptions(protocol="trpc_std",
                                        timeout_ms=60000)).init(target)
    stub = rpc.Stub(ch, dpb.DESCRIPTOR.services_by_name["DeviceDataService"])
    before = _adders(dl)
    results = []
    for method, req, att in _rpc_script(dpb):
        cntl = rpc.Controller()
        cntl.request_attachment = att
        try:
            resp = getattr(stub, method)(req, controller=cntl)
        except rpc.RpcError as e:
            results.append((e.error_code, b"", b""))
            continue
        results.append((0, resp.SerializeToString(),
                        cntl.response_attachment))
    return results, [a - b for a, b in zip(_adders(dl), before)]


def _tail_checksum():
    words = np.frombuffer(_payload(PUMP_ROWS * 8192, seed=12), np.int32)
    return int(np.array([words[0], words[-1]], np.int32).sum(
        dtype=np.int32))


def _check_pair(jax_out, port_out):
    (jres, jdelta), (pres, pdelta) = jax_out, port_out
    assert pdelta == jdelta
    assert [r[0] for r in pres].count(errors.ENOMETHOD) == 2
    jtail, ptail = (port_dpb.PumpResult.FromString(r[TAIL_CALL][1])
                    for r in (jres, pres))
    # the port copies every row; the JAX loop leaves rows 512..599 unwritten
    assert ptail.checksum == _tail_checksum()
    assert jtail.checksum != _tail_checksum()
    assert ptail.moved_bytes == jtail.moved_bytes == 4 * PUMP_ROWS * 8192
    keep = [i for i in range(len(pres)) if i != TAIL_CALL]
    assert [pres[i] for i in keep] == [jres[i] for i in keep]
    assert pres[9][2] == _rpc_script(port_dpb)[0][2]  # Get == the Put


def _servers(address):
    """A fresh store and Server per package on ``address``."""
    out = {}
    for side in ("jax", "port"):
        rpc, _, _, dl = SIDES[side]
        store = dl.DeviceStore() if side == "jax" else dl.DeviceStore("cpu")
        srv = rpc.Server()
        srv.add_service(dl.DeviceDataService(store))
        out[side] = (srv.start(address), store)
    return out


@pytest.mark.parametrize("address", ["127.0.0.1:0", "tpu://127.0.0.1:0/0"],
                         ids=["tcp", "tunnel"])
def test_device_data_service_on_the_server_matches_jax(address):
    servers = _servers(address)
    try:
        out = [_run_script(side, str(servers[side][0].listen_endpoint()))
               for side in ("jax", "port")]
    finally:
        for srv, store in servers.values():
            srv.stop()
            srv.join()
            store.fence()
    _check_pair(*out)
    assert str(servers["port"][0].listen_endpoint()).startswith(
        "tpu://" if address.startswith("tpu") else "127.0.0.1:")


def test_device_data_service_in_process_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_dl, "_store", jax_dl.DeviceStore())
    monkeypatch.setattr(jax_dl, "_tpusock_svc", None)
    monkeypatch.setattr(port_dl, "_stores", {})
    monkeypatch.setattr(port_dl, "_tpusock_svcs", {})
    out = [_run_script(side, "tpu://localhost/0")
           for side in ("jax", "port")]
    _check_pair(*out)


def test_copy_kernel_counts_stay_zero_on_the_cpu():
    """On the CPU the wrappers take their plain versions and count no
    launch, whatever the lane runs."""
    before = pallas_ops.launches.snapshot()
    _run_script("port", "tpu://localhost/0")
    stub = _echo_stub("port", "tpu://localhost/0")
    stub.Echo(port_echo.EchoRequest(message="m", payload=b"x" * 100))
    assert pallas_ops.launches.snapshot() == before

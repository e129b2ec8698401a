"""The port's device data plane (brpc_tpu_torch.tpu.device_lane) against
the JAX package's: DeviceStore copy / copy_coalesced / pump / fence /
stats, and DeviceDataService with its in-process call.

The same numpy-seeded payload bytes are put into both stores (the JAX
one on JAX's CPU device, its pump's Pallas loop in interpret mode; the
port's on ``device="cpu"``, every copy its plain version). Tolerance 0:
bytes, checksums, moved bytes, step_dispatch deltas, stats and the
services' serialized responses must be equal.

Every test that queues transient copies fences both stores before it
ends: a JAX process whose last device op was an unfenced transient copy
can abort at exit (ROADMAP Queue 3).
"""

import numpy as np
import pytest

from brpc_tpu.proto import device_lane_pb2 as jax_pb
from brpc_tpu.tpu import device_lane as jax_dl
from brpc_tpu_torch import errors as port_errors
from brpc_tpu_torch.proto import device_lane_pb2 as port_pb
from brpc_tpu_torch.tpu import device_lane as port_dl

BLOB = bytes(range(256)) * 512  # 128 KiB: 16 pump rows of 2048 int32


def _payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture
def stores():
    j, p = jax_dl.DeviceStore(), port_dl.DeviceStore("cpu")
    yield j, p
    j.fence()
    p.fence()


def _both(stores, fn):
    """fn(store, step_dispatch) on each store; returns the two results."""
    j, p = stores
    return (fn(j, jax_dl.step_dispatch), fn(p, port_dl.step_dispatch))


def test_pump_checksum_and_moved_bytes_match_jax(stores):
    out = _both(stores, lambda s, _: [s.pump(s.put(BLOB)[0], r)
                                      for r in (1, 3)])
    assert out[0] == out[1] == [(50396924, 524288), (50396924, 1572864)]


def test_pump_refuses_short_payloads_and_unknown_handles(stores):
    out = _both(stores, lambda s, _: (s.pump(s.put(bytes(8191))[0], 1),
                                      s.pump(999, 1),
                                      s.pump(s.put(bytes(8192))[0], 1)))
    assert out[0] == out[1] == (None, None, (0, 4 * 8192))


@pytest.mark.parametrize("rounds,clamped", [(0, 1), (-5, 1),
                                            (200000, 100000)])
def test_pump_rounds_clamp_like_jax(stores, rounds, clamped):
    payload = _payload(8192, seed=rounds & 0xff)
    out = _both(stores, lambda s, _: s.pump(s.put(payload)[0], rounds))
    assert out[0] == out[1]
    assert out[1][1] == 4 * clamped * 8192


def test_pump_takes_the_whole_rows_of_a_ragged_payload(stores):
    payload = _payload(3 * 8192 + 100, seed=5)
    out = _both(stores, lambda s, _: s.pump(s.put(payload)[0], 2))
    assert out[0] == out[1] and out[1][1] == 4 * 2 * 3 * 8192


def test_copy_round_trip_and_chain_of_eight(stores):
    payload = _payload(65536 + 7, seed=1)

    def run(s, _):
        h, n = s.put(payload)
        first = s.copy(h)
        chain = [first]
        for _ in range(7):
            chain.append(s.copy(chain[-1][0]))
        return (n, chain, s.get(first[0]), s.get(chain[-1][0]),
                s.get(h), s.stats())

    out = _both(stores, run)
    assert out[0] == out[1]
    n, chain, a, b, c, stats = out[1]
    assert a == b == c == payload
    assert [x[1] for x in chain] == [n] * 8
    assert stats == (9, 9 * n, 2 * 8 * n)


def test_copy_notes_one_launch_and_refuses_unknown_handles(stores):
    def run(s, sd):
        h, _ = s.put(_payload(1024, seed=2))
        before = sd.snapshot()
        s.copy(h)
        return sd.delta(before, sd.snapshot()), s.copy(12345)

    out = _both(stores, run)
    assert out[0] == out[1] == ((1, 1, 0), None)


def test_transient_copy_queues_and_fences(stores):
    payload = _payload(4096, seed=3)

    def run(s, sd):
        h, n = s.put(payload)
        s.fence()
        before = sd.snapshot()
        res = [s.copy(h, transient=True) for _ in range(3)]
        s.fence()
        return res, s.stats(), sd.delta(before, sd.snapshot())[1]

    out = _both(stores, run)
    assert out[0] == out[1]
    res, stats, ops = out[1]
    assert res == [(0, 4096)] * 3
    assert stats == (1, 4096, 3 * 2 * 4096) and ops == 3
    rings = [_ring_bytes(s) for s in stores]
    assert rings[0] == rings[1] == [payload] * 3


def _ring_bytes(store):
    """The store's transient ring, oldest first, as bytes."""
    return [bytes(np.asarray(t)) for t in store._transient]


def test_transient_ring_matches_jax_and_keeps_the_last_32(stores):
    a, b = _payload(1000, seed=10), _payload(1000, seed=11)

    def run(s, _):
        ha, _ = s.put(a)
        hb, _ = s.put(b)
        s.copy_coalesced(ha, 5)  # each call drained whole by the fence
        s.fence()
        s.copy_coalesced(hb, 30)
        s.fence()
        s.copy(ha, transient=True)
        s.fence()
        return _ring_bytes(s)

    out = _both(stores, run)
    assert out[0] == out[1] == [a] + [b] * 30 + [a]


@pytest.mark.parametrize("count,launches,ops", [(100, 4, 100), (0, 1, 1),
                                                (5000, 128, 4096)])
def test_copy_coalesced_dispatch_delta_matches_jax(stores, count, launches,
                                                   ops):
    def run(s, sd):
        h, n = s.put(_payload(1024, seed=4))
        s.fence()
        before = sd.snapshot()
        res = s.copy_coalesced(h, count)
        s.fence()
        return res, sd.delta(before, sd.snapshot()), s.stats()

    out = _both(stores, run)
    assert out[0] == out[1]
    res, delta, stats = out[1]
    assert res == (0, 1024 * ops) and delta == (launches, ops, 0)
    assert stats == (1, 1024, 2 * 1024 * ops)
    assert stores[1].copy_coalesced(999, 3) is None


def test_dispatcher_groups_by_shape_and_dtype(stores):
    _, p = stores
    small, _ = p.put(bytes(100))
    large, _ = p.put(bytes(300))
    p.fence()
    before = port_dl.step_dispatch.snapshot()
    for _ in range(3):  # queued alternately, dispatched by group
        p.copy(small, transient=True)
        p.copy(large, transient=True)
    p.fence()
    launches, ops, _ = port_dl.DispatchCounter.delta(
        before, port_dl.step_dispatch.snapshot())
    # each group of 3 runs as 2 + 1, unless the dispatcher woke between
    # the calls and took the queue in smaller pieces
    assert ops == 6 and 4 <= launches <= 6
    assert sorted(t.numel() for t in p._transient) == [100] * 3 + [300] * 3


def test_dispatcher_survives_a_failed_batch(stores, monkeypatch):
    _, p = stores
    h, _ = p.put(bytes(64))
    p.fence()
    calls = []

    def broken(xs):
        calls.append(len(xs))
        raise RuntimeError("launch failed")

    monkeypatch.setattr(port_dl.bench_kernels, "hbm_copy_batched", broken)
    before = port_dl.step_dispatch.snapshot()
    p.copy_coalesced(h, 8)
    with pytest.raises(RuntimeError, match="dropped") as failed:
        p.fence()  # the dispatcher is idle and reports the lost batch
    assert isinstance(failed.value.__cause__, RuntimeError)
    assert calls == [8]
    assert port_dl.DispatchCounter.delta(
        before, port_dl.step_dispatch.snapshot()) == (0, 0, 0)
    p.fence()  # the error is reported once
    monkeypatch.undo()
    p.copy_coalesced(h, 2)  # the same thread, still alive, runs the next
    p.fence()
    assert port_dl.DispatchCounter.delta(
        before, port_dl.step_dispatch.snapshot()) == (1, 2, 0)


def test_stats_match_after_the_same_operations(stores):
    def run(s, _):
        a, _ = s.put(_payload(20000, seed=6))
        b, _ = s.put(BLOB)
        c, _ = s.copy(a)
        s.copy(b, transient=True)
        s.copy_coalesced(a, 7)
        s.pump(b, 2)
        s.free(c)
        s.free(4242)
        s.fence()
        return s.stats()

    out = _both(stores, run)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# DeviceDataService
# ---------------------------------------------------------------------------
class _Cntl:
    def __init__(self, attachment=b""):
        self.request_attachment = attachment
        self.response_attachment = b""
        self.error = None

    def set_failed(self, code, text=""):
        self.error = code


def _call(svc, method, request_bytes, attachment=b""):
    """(error code, serialized response, response attachment)."""
    req = svc.find_method(method).request_class()
    req.ParseFromString(request_bytes)
    cntl = _Cntl(attachment)
    resp = svc.find_method(method).fn(cntl, req, None)
    return cntl.error, resp.SerializeToString(), cntl.response_attachment


def _script(pb):
    """(method, serialized request, attachment) of every method and its
    failures, in one order both services run."""
    blob = _payload(3 * 8192 + 11, seed=8)
    H = pb.DeviceHandle
    return [
        ("Put", H(), blob),
        ("Put", H(), BLOB),
        ("Copy", H(handle=1, nbytes=0), b""),      # a new handle
        ("Copy", H(handle=1, nbytes=-1), b""),     # transient
        ("Copy", H(handle=2, nbytes=-5), b""),     # 5 coalesced
        ("Copy", H(handle=77, nbytes=0), b""),     # ENOMETHOD
        ("Copy", H(handle=77, nbytes=-3), b""),    # ENOMETHOD
        ("Pump", pb.PumpRequest(handle=2, rounds=3), b""),
        ("Pump", pb.PumpRequest(handle=1, rounds=0), b""),
        ("Pump", pb.PumpRequest(handle=77, rounds=1), b""),
        ("Get", H(handle=3), b""),
        ("Get", H(handle=77), b""),
        ("Stats", pb.DeviceStatsRequest(fence=False), b""),
        ("Free", H(handle=3), b""),
        ("Free", H(handle=3), b""),                # already gone: handle 0
        ("Stats", pb.DeviceStatsRequest(fence=True), b""),
    ]


def _check_script(jax_results, port_results):
    assert jax_results == port_results
    codes = [r[0] for r in port_results]
    assert codes.count(port_errors.ENOMETHOD) == 4
    assert port_errors.ENOMETHOD == jax_dl.errors.ENOMETHOD == 1002
    assert port_results[10][2] == _script(port_pb)[0][2]  # Get == Put


def test_service_responses_match_jax_byte_for_byte(stores):
    j, p = stores
    svcs = (jax_dl.DeviceDataService(j), port_dl.DeviceDataService(p))
    results = [[_call(svc, m, req.SerializeToString(), att)
                for m, req, att in _script(pb)]
               for svc, pb in zip(svcs, (jax_pb, port_pb))]
    _check_script(*results)


def test_service_method_tables_match(stores):
    j, p = stores
    jsvc, psvc = jax_dl.DeviceDataService(j), port_dl.DeviceDataService(p)
    names = ["Put", "Copy", "Pump", "Get", "Free", "Stats"]
    assert psvc.DESCRIPTOR.full_name == jsvc.DESCRIPTOR.full_name == \
        "brpc_tpu.device.DeviceDataService"
    for name in names:
        je, pe = jsvc.find_method(name), psvc.find_method(name)
        assert pe.name == je.name == name
        assert (pe.request_class.DESCRIPTOR.full_name,
                pe.response_class.DESCRIPTOR.full_name) == \
            (je.request_class.DESCRIPTOR.full_name,
             je.response_class.DESCRIPTOR.full_name)
    assert psvc.find_method("Nope") is None


def test_tpusock_calls_match_jax(monkeypatch):
    monkeypatch.setattr(jax_dl, "_store", jax_dl.DeviceStore())
    monkeypatch.setattr(jax_dl, "_tpusock_svc", None)
    monkeypatch.setattr(port_dl, "_stores", {})
    monkeypatch.setattr(port_dl, "_tpusock_svcs", {})
    try:
        results = [
            [jax_dl._tpusock_call(None, None, req.SerializeToString(), att,
                                  m) for m, req, att in _script(jax_pb)],
            [port_dl._tpusock_call("cpu", None, req.SerializeToString(),
                                   att, m)
             for m, req, att in _script(port_pb)]]
    finally:
        jax_dl._store.fence()
        port_dl.global_store("cpu").fence()
    # a failed call carries no response bytes
    for code, resp, att in results[1]:
        assert code in (0, port_errors.ENOMETHOD)
        assert code == 0 or (resp, att) == (b"", b"")
    _check_script(*results)


def test_the_two_proto_copies_share_one_descriptor():
    assert port_pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    msg = port_pb.PumpResult(checksum=-2, moved_bytes=1 << 40)
    assert jax_pb.PumpResult.FromString(msg.SerializeToString()) == \
        jax_pb.PumpResult(checksum=-2, moved_bytes=1 << 40)


def test_service_and_tpusock_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_dl.DeviceDataService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_dl._tpusock_call(None, None, b"", b"", "Stats")

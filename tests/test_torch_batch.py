"""Adaptive request batching on the port (brpc_tpu_torch/batch/): every
case of the JAX package's ``tests/test_batch.py`` on the port (queue
mechanics: flush on size, deadline and poll boundary; padding and
bucketing; per-item error isolation; ELIMIT backpressure; an end-to-end
batched echo through the port's Server and Channel, the batched method
answering through ``done`` from the flush thread), the policy's buckets
and the context's stacking held against the JAX package's on the same
inputs, and the batched_inference example's service on the CPU with the
JAX example's W: its answers equal the JAX example's forward within 1e-5
relative error.

No verdict waits on wall time: every wait polls a predicate under a
bound. The deadline flush is seen through the flush's reason, not a
clock.
"""

import threading
import time

import numpy as np
import pytest

from brpc_tpu.batch import BatchContext as JaxBatchContext
from brpc_tpu.batch import BatchPolicy as JaxBatchPolicy
from brpc_tpu_torch.batch import (
    BatchContext,
    BatchPolicy,
    batched_method,
    flush_poll_batch,
    make_batched,
)
from brpc_tpu_torch.batch import metrics as bmetrics
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Server,
    Service,
    Stub,
    errors,
)
from brpc_tpu_torch.rpc.controller import Controller

ECHO_DESC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


def _drive(bm, n, results, start=0):
    """Admit n requests through the dispatch-path contract; done callbacks
    collect (index, response)."""
    cntls = []
    for i in range(start, start + n):
        c = Controller()
        cntls.append(c)

        def done(resp=None, _i=i, _c=c):
            results.append((_i, resp, _c.error_code))

        ret = bm(c, f"req{i}", done)
        assert ret is None  # async per the dispatch contract
        if c.failed():      # dispatcher would send the error itself
            results.append((i, None, c.error_code))
    return cntls


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


class TestPolicy:
    def test_default_buckets_pow2(self):
        p = BatchPolicy(max_batch_size=32)
        assert p.bucket_shapes == (1, 2, 4, 8, 16, 32)
        assert p.bucket_for(1) == 1
        assert p.bucket_for(3) == 4
        assert p.bucket_for(17) == 32
        assert p.bucket_for(99) == 32  # capped at the largest bucket

    def test_custom_buckets_cover_max(self):
        p = BatchPolicy(max_batch_size=24, bucket_shapes=(4, 8))
        # the largest bucket must carry a full batch
        assert p.bucket_shapes == (4, 8, 24)
        assert p.bucket_for(9) == 24

    def test_max_queue_at_least_batch(self):
        p = BatchPolicy(max_batch_size=64, max_queue=8)
        assert p.max_queue == 64


class TestContext:
    def _items(self, payloads):
        class _Item:
            def __init__(self, req):
                self.request = req
                self.cntl = Controller()
                self.done = lambda resp=None: None
                self.enqueue_us = 0
                self.settled = False
        return [_Item(p) for p in payloads]

    def test_stack_pads_to_bucket(self):
        import numpy as np

        ctx = BatchContext(self._items([[1.0, 2.0], [3.0, 4.0]]), 4, "size")
        out = ctx.stack([it.request for it in ctx.items])
        assert out.shape == (4, 2)
        assert out[1].tolist() == [3.0, 4.0]
        assert np.all(out[2:] == 0)

    def test_stack_isolates_ragged_row(self):
        ctx = BatchContext(
            self._items([[1.0, 2.0], [1.0, 2.0, 3.0], [5.0, 6.0]]),
            4, "size")
        out = ctx.stack([it.request for it in ctx.items])
        assert out.shape == (4, 2)
        assert ctx.failed(1) and not ctx.failed(0) and not ctx.failed(2)
        assert ctx._errors[1][0] == errors.EREQUEST


class TestQueueFlush:
    def test_flush_on_size(self):
        batches, results = [], []
        bm = make_batched(
            "t.size",
            lambda b: batches.append((b.size, b.reason)) or ["ok"] * b.size,
            max_batch_size=4, max_delay_us=500000, flush_on_poll_batch=False)
        _drive(bm, 4, results)
        # the size trigger fires inside the fourth admission, not the
        # 500 ms deadline
        assert _wait(lambda: len(results) == 4, 30.0), results
        assert batches == [(4, "size")]
        assert bm.queue.depth() == 0

    def test_flush_on_deadline(self):
        batches, results = [], []
        bm = make_batched(
            "t.dl",
            lambda b: batches.append((b.size, b.reason)) or ["ok"] * b.size,
            max_batch_size=64, max_delay_us=30000, flush_on_poll_batch=False)
        _drive(bm, 3, results)
        assert bm.queue.depth() == 3  # parked: size cap far away
        assert _wait(lambda: len(results) == 3, 30.0), results
        # nothing but the queue's timer flushes this queue: the batch came
        # from the deadline, not a size or poll flush
        assert batches == [(3, "deadline")]

    def test_flush_on_poll_boundary(self):
        from brpc_tpu_torch.rpc import input_messenger

        batches, results = [], []
        bm = make_batched(
            "t.poll", lambda b: batches.append(b.size) or ["ok"] * b.size,
            max_batch_size=64, max_delay_us=500000)
        _drive(bm, 5, results)
        assert bm.queue.depth() == 5
        # registering installed the messenger hook; the dispatcher calls it
        # after every cut loop
        assert input_messenger.poll_batch_hook is flush_poll_batch
        flush_poll_batch()
        assert _wait(lambda: len(results) == 5, 30.0), results
        assert batches == [5]
        flush_poll_batch()  # idle boundary: no-op
        assert batches == [5]

    def test_bucket_padding_recorded(self):
        seen = []
        bm = make_batched(
            "t.bucket",
            lambda b: seen.append((b.size, b.bucket)) or ["ok"] * b.size,
            max_batch_size=8, max_delay_us=5000, flush_on_poll_batch=False)
        results = []
        _drive(bm, 3, results)
        assert _wait(lambda: len(results) == 3, 30.0)
        assert seen == [(3, 4)]  # 3 live items padded to the 4-bucket

    def test_pad_waste_recorded_per_bucket(self):
        """Every flush records bucket - size into the per-bucket pad-waste
        recorder, surfaced on /vars as g_batch_pad_waste_<bucket> — the
        signal for tuning bucket_shapes against real traffic."""
        from brpc_tpu_torch.metrics.variable import get_exposed

        bm = make_batched(
            "t.waste", lambda b: ["ok"] * b.size,
            max_batch_size=8, max_delay_us=5000, flush_on_poll_batch=False)
        results = []
        _drive(bm, 3, results)           # size 3 -> bucket 4 -> waste 1
        assert _wait(lambda: len(results) == 3, 30.0)
        waste_sum, waste_count = bmetrics.pad_waste_buckets()[4].get_value()
        assert waste_count >= 1 and waste_sum >= 1
        var = get_exposed("g_batch_pad_waste_4")
        assert var is not None
        rendered = var.describe()
        assert "count=" in rendered, rendered


class TestIsolation:
    def test_one_bad_request_fails_alone(self):
        def vec(batch):
            if any(r == "req1" for r in batch.requests):
                raise ValueError("poisoned")
            return [r.upper() for r in batch.requests]

        results = []
        bm = make_batched("t.iso", vec, max_batch_size=4, max_delay_us=0,
                          flush_on_poll_batch=False)
        _drive(bm, 4, results)
        bm.queue.flush()
        assert _wait(lambda: len(results) == 4, 30.0), results
        by_idx = {i: (resp, code) for i, resp, code in results}
        assert by_idx[1] == (None, errors.EINTERNAL)
        for i in (0, 2, 3):  # survivors re-ran as singletons
            assert by_idx[i] == (f"REQ{i}", 0)

    def test_fail_marks_single_item(self):
        def vec(batch):
            out = []
            for i, r in enumerate(batch.requests):
                if r.endswith("2"):
                    batch.fail(i, errors.EREQUEST, "bad tensor")
                    out.append(None)
                else:
                    out.append(r)
            return out

        results = []
        bm = make_batched("t.fail", vec, max_batch_size=4, max_delay_us=0,
                          flush_on_poll_batch=False)
        _drive(bm, 4, results)
        bm.queue.flush()
        assert _wait(lambda: len(results) == 4, 30.0), results
        by_idx = {i: (resp, code) for i, resp, code in results}
        assert by_idx[2] == (None, errors.EREQUEST)
        assert all(by_idx[i][1] == 0 for i in (0, 1, 3))

    def test_short_response_list_is_internal_error(self):
        results = []
        bm = make_batched("t.short", lambda b: [b.requests[0]],
                          max_batch_size=2, max_delay_us=0,
                          flush_on_poll_batch=False)
        _drive(bm, 2, results)
        bm.queue.flush()
        assert _wait(lambda: len(results) == 2, 30.0)
        by_idx = {i: code for i, _, code in results}
        assert by_idx[0] == 0 and by_idx[1] == errors.EINTERNAL


class TestBackpressure:
    def test_elimit_past_outstanding_cap(self):
        gate = threading.Event()

        def vec(batch):
            gate.wait(10)
            return ["ok"] * batch.size

        results = []
        bm = make_batched("t.bp", vec, max_batch_size=2, max_delay_us=0,
                          max_queue=4, flush_on_poll_batch=False)
        try:
            cntls = _drive(bm, 7, results)
            codes = [c.error_code for c in cntls]
            assert codes.count(errors.ELIMIT) == 3
            assert codes.count(0) == 4
            assert bm.queue.rejected == 3
        finally:
            gate.set()
        assert _wait(lambda: len(results) == 7, 30.0), results
        # slots free once batches settle: admission works again
        c = Controller()
        bm(c, "late", lambda resp=None: None)
        assert c.error_code == 0
        bm.queue.flush()

    def test_limiter_spec_admission(self):
        gate = threading.Event()

        def vec(batch):
            gate.wait(10)
            return ["ok"] * batch.size

        bm = make_batched("t.lim", vec, max_batch_size=8, max_delay_us=0,
                          flush_on_poll_batch=False, limiter="constant:2")
        results = []
        try:
            cntls = _drive(bm, 4, results)
            codes = [c.error_code for c in cntls]
            assert codes == [0, 0, errors.ELIMIT, errors.ELIMIT]
        finally:
            gate.set()
        bm.queue.flush()
        assert _wait(lambda: len(results) == 4, 30.0)


class TestObservability:
    def test_vars_exposed_and_recorded(self):
        from brpc_tpu_torch.metrics import dump_exposed

        before = bmetrics.batch_size_recorder.get_value()[1]
        results = []
        bm = make_batched("t.vars", lambda b: ["ok"] * b.size,
                          max_batch_size=2, max_delay_us=0,
                          flush_on_poll_batch=False)
        _drive(bm, 2, results)
        assert _wait(lambda: len(results) == 2, 30.0)
        snapshot = dump_exposed()
        assert "g_batch_size" in snapshot
        assert "g_batch_queue_delay_us" in snapshot
        assert bmetrics.batch_size_recorder.get_value()[1] == before + 1

    def test_span_annotation(self):
        notes = []

        class _Span:
            def annotate(self, text):
                notes.append(text)

        results = []
        bm = make_batched("t.span", lambda b: ["ok"] * b.size,
                          max_batch_size=2, max_delay_us=0,
                          flush_on_poll_batch=False)
        c = Controller()
        c.span = _Span()
        bm(c, "x", lambda resp=None: results.append(resp))
        bm(Controller(), "y", lambda resp=None: results.append(resp))
        assert _wait(lambda: len(results) == 2, 30.0)
        assert len(notes) == 1
        assert "size=2" in notes[0] and "reason=size" in notes[0]
        assert "queue=t.span" in notes[0]


# ---------------------------------------------------------------- end to end
class BatchedEchoService(Service):
    """EchoService whose Echo is vectorized through @batched_method —
    DESCRIPTOR-driven wiring: Service.__init__'s getattr() binds the
    descriptor, which builds the per-instance BatchQueue."""

    DESCRIPTOR = ECHO_DESC

    def __init__(self):
        self.batch_sizes = []
        self.gate = None
        super().__init__()

    @batched_method(max_batch_size=8, max_delay_us=40000,
                    flush_on_poll_batch=False, max_queue=8)
    def Echo(self, batch):
        if self.gate is not None:
            self.gate.wait(10)
        self.batch_sizes.append(batch.size)
        out = []
        for i, req in enumerate(batch.requests):
            if req.message == "poison":
                batch.fail(i, errors.EREQUEST, "poisoned request")
                out.append(None)
            else:
                out.append(echo_pb2.EchoResponse(message=req.message.upper(),
                                                 payload=req.payload))
        return out


@pytest.fixture()
def batched_echo_server():
    impl = BatchedEchoService()
    server = Server().add_service(impl).start("127.0.0.1:0")
    yield server, impl
    if impl.gate is not None:
        impl.gate.set()
    server.stop()
    server.join(timeout=2)


def _async_burst(stub, messages, timeout=15.0):
    """Fire all messages without waiting, then collect (message, resp,
    code) per call."""
    ev = threading.Event()
    out = []
    lock = threading.Lock()

    def mk(msg):
        def done(cntl):
            with lock:
                out.append((msg, getattr(cntl, "_response", None),
                            cntl.error_code))
                if len(out) == len(messages):
                    ev.set()
        return done

    for m in messages:
        stub.Echo(echo_pb2.EchoRequest(message=m), done=mk(m))
    assert ev.wait(timeout), f"only {len(out)}/{len(messages)} completed"
    return out


class TestEndToEnd:
    def test_batched_echo_coalesces(self, batched_echo_server):
        server, impl = batched_echo_server
        ch = Channel(ChannelOptions(timeout_ms=15000)).init(
            str(server.listen_endpoint()))
        stub = Stub(ch, ECHO_DESC)
        msgs = [f"m{i}" for i in range(8)]
        out = _async_burst(stub, msgs)
        by_msg = {m: (r, c) for m, r, c in out}
        for m in msgs:
            resp, code = by_msg[m]
            assert code == 0 and resp.message == m.upper()
        assert sum(impl.batch_sizes) == 8
        # a pipelined burst against a 40ms deadline must coalesce
        assert max(impl.batch_sizes) >= 2, impl.batch_sizes

    def test_batched_echo_sync_call(self, batched_echo_server):
        server, impl = batched_echo_server
        ch = Channel(ChannelOptions(timeout_ms=15000)).init(
            str(server.listen_endpoint()))
        stub = Stub(ch, ECHO_DESC)
        resp = stub.Echo(echo_pb2.EchoRequest(message="solo"))
        assert resp.message == "SOLO"
        assert impl.batch_sizes and impl.batch_sizes[-1] == 1

    def test_poisoned_request_fails_alone_e2e(self, batched_echo_server):
        server, impl = batched_echo_server
        ch = Channel(ChannelOptions(timeout_ms=15000)).init(
            str(server.listen_endpoint()))
        stub = Stub(ch, ECHO_DESC)
        out = _async_burst(stub, ["a", "poison", "b", "c"])
        codes = {m: c for m, _, c in out}
        assert codes["poison"] == errors.EREQUEST
        assert codes["a"] == 0 and codes["b"] == 0 and codes["c"] == 0
        resps = {m: r for m, r, _ in out}
        assert resps["a"].message == "A"

    def test_backpressure_elimit_e2e(self, batched_echo_server):
        server, impl = batched_echo_server
        impl.gate = threading.Event()
        ch = Channel(ChannelOptions(timeout_ms=20000)).init(
            str(server.listen_endpoint()))
        stub = Stub(ch, ECHO_DESC)
        # max_queue=8: a 12-call burst must shed at least the overflow
        # while the handler is gated; the rest complete after release
        ev = threading.Event()
        out = []
        lock = threading.Lock()

        def done(cntl):
            with lock:
                out.append(cntl.error_code)
                if len(out) == 12:
                    ev.set()

        for i in range(12):
            stub.Echo(echo_pb2.EchoRequest(message=f"q{i}"), done=done)
        # the burst lands while the gate is closed: 8 admitted calls hold
        # every outstanding slot, so the other 4 come back ELIMIT before
        # any admitted one can; then open the gate for the admitted calls
        assert _wait(lambda: len(out) >= 4, 20.0), out
        impl.gate.set()
        assert ev.wait(20), f"only {len(out)}/12 completed"
        rejected = sum(1 for c in out if c == errors.ELIMIT)
        succeeded = sum(1 for c in out if c == 0)
        assert rejected >= 1, out
        assert succeeded >= 8, out
        assert rejected + succeeded == 12, out


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("knobs", [
    dict(max_batch_size=32), dict(max_batch_size=24, bucket_shapes=(4, 8)),
    dict(max_batch_size=64, max_queue=8), dict(max_batch_size=1),
    dict(max_batch_size=16, bucket_shapes=(1, 4, 16)),
    dict(max_batch_size=5, bucket_shapes=(3, 3, 0, 2)),
])
def test_policy_buckets_equal_the_jax_policy(knobs):
    port, jax_p = BatchPolicy(**knobs), JaxBatchPolicy(**knobs)
    assert port.bucket_shapes == jax_p.bucket_shapes
    assert port.max_queue == jax_p.max_queue
    for n in range(0, 2 * port.max_batch_size + 2):
        assert port.bucket_for(n) == jax_p.bucket_for(n), n


def _ctx_items(payloads):
    class _Item:
        def __init__(self, req):
            self.request = req
            self.cntl = Controller()
            self.done = lambda resp=None: None
            self.enqueue_us = 0
            self.settled = False
    return [_Item(p) for p in payloads]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stack_equals_the_jax_context(seed):
    """Seeded rows, one of them ragged: the port's stack pads and fails
    exactly as the JAX package's does."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 7))
    rows = [rng.standard_normal(5).astype(np.float32) for _ in range(n)]
    bad = int(rng.integers(1, n))
    rows[bad] = rng.standard_normal(3).astype(np.float32)
    bucket = BatchPolicy(max_batch_size=8).bucket_for(n)
    port = BatchContext(_ctx_items(rows), bucket, "size")
    jax_c = JaxBatchContext(_ctx_items(rows), bucket, "size")
    a = port.stack(rows, pad_value=-1)
    b = jax_c.stack(rows, pad_value=-1)
    np.testing.assert_array_equal(a, b)
    assert {i: e[0] for i, e in port._errors.items()} \
        == {i: e[0] for i, e in jax_c._errors.items()} == {bad: errors.EREQUEST}


def test_device_arrays_resolve_store_handles():
    """``device_arrays`` reads the port's DeviceStore by handle; an
    unknown handle fails its item alone."""
    import torch

    from brpc_tpu_torch.tpu.device_lane import global_store

    store = global_store("cpu")
    h, _ = store.adopt(torch.arange(6, dtype=torch.float32))
    ctx = BatchContext(_ctx_items([h, 987654321]), 2, "size")
    out = ctx.device_arrays([h, 987654321], device="cpu")
    assert torch.equal(out[0], torch.arange(6, dtype=torch.float32))
    assert out[1] is None
    assert ctx.failed(1) and not ctx.failed(0)
    store.free(h)


# ---------------------------------- the batched_inference example's service
@pytest.fixture(scope="module")
def jax_inference():
    """The JAX example's service (its jitted MLP and W), constructed as its
    server constructs it."""
    from examples.batched_inference.server import \
        BatchedInferenceService as JaxInference

    return JaxInference()


def test_batched_inference_equals_the_jax_example(jax_inference):
    """The port's example service on the CPU with the JAX example's W: a
    pipelined burst (two poisoned requests in it) coalesces into batches,
    each good answer equals the JAX forward of its row within 1e-5
    relative error and carries the JAX message's sum, and each poisoned
    request fails alone with EREQUEST."""
    from brpc_tpu_torch.examples.batched_inference.server import (
        DIM, BatchedInferenceService)

    W = np.asarray(jax_inference._W, np.float32)
    svc = BatchedInferenceService("cpu", W)
    server = Server().add_service(svc).start("127.0.0.1:0")
    try:
        stub = Stub(Channel(ChannelOptions(timeout_ms=30000)).init(
            str(server.listen_endpoint())), ECHO_DESC)
        rng = np.random.default_rng(0)
        xs = [rng.standard_normal(DIM).astype(np.float32)
              for _ in range(32)]
        msgs = [x.tobytes() for x in xs]
        msgs.insert(9, xs[0][:DIM - 1].tobytes())
        msgs.insert(20, b"\x00" * 12)
        ev = threading.Event()
        out = {}
        lock = threading.Lock()

        def done_for(i):
            def done(cntl):
                with lock:
                    out[i] = cntl
                    if len(out) == len(msgs):
                        ev.set()
            return done

        for i, payload in enumerate(msgs):
            stub.Echo(echo_pb2.EchoRequest(message="infer", payload=payload),
                      done=done_for(i))
        assert ev.wait(60), f"only {len(out)}/{len(msgs)} completed"
    finally:
        server.stop()
        server.join(timeout=5)
    good = [i for i in range(len(msgs)) if i not in (9, 20)]
    for i in (9, 20):
        assert out[i].error_code == errors.EREQUEST, i
    want = np.asarray(jax_inference._fwd(np.stack(xs)))
    sizes = []
    for k, i in enumerate(good):
        cntl = out[i]
        assert not cntl.failed(), (i, cntl.error_code)
        got = np.frombuffer(cntl._response.payload, np.float32)
        np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=1e-5)
        size, total = cntl._response.message.split()
        sizes.append(int(size.split("=")[1]))
        # the JAX example prints the row's sum at 4 decimals
        assert abs(float(total.split("=")[1]) - float(want[k].sum())) \
            <= 1e-4 + 1e-5 * abs(float(want[k].sum()))
    assert max(sizes) > 1, sizes  # the burst coalesced
    assert svc.calls < len(msgs)  # fewer device calls than requests
    assert svc.items == len(msgs)

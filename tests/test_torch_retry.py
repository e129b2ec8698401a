"""The port's retry and backup-request policies (brpc_tpu_torch/policy/
retry.py): the five ``TestRetryPolicy`` cases of the JAX package's
``tests/test_auth_retry_tools.py`` on the port's Channel and Server, and
each policy's verdict held against the JAX package's on every error
code.

No case waits on wall time for its verdict: a hedge's arrival is polled
for with a bound, and the vetoed hedge is read from the policy (it was
asked) and the server (one call when the answer came back).
"""

import threading
import time

import pytest

import brpc_tpu.policy.retry as jax_retry
from brpc_tpu.rpc import errors as jax_errors
from brpc_tpu_torch.policy import retry as port_retry
from brpc_tpu_torch.policy.retry import (BackupRequestPolicy,
                                         DefaultRetryPolicy, RetryOnCodes,
                                         RetryPolicy, TunnelRetryPolicy,
                                         default_retry_policy)
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Controller,
                                RpcError, Server, Service, Stub, errors)

ECHO_DESC = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]


class EchoServiceImpl(Service):
    DESCRIPTOR = ECHO_DESC

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self.calls = 0
        self.close_next_connection = False

    def Echo(self, cntl, request, done):
        with self._lock:
            self.calls += 1
        if self.close_next_connection:
            self.close_next_connection = False
            cntl._srv_socket.set_failed(errors.EFAILEDSOCKET, "injected")
            return None
        if request.sleep_us:
            time.sleep(request.sleep_us / 1e6)
        return echo_pb2.EchoResponse(message=request.message)


def start_server():
    impl = EchoServiceImpl()
    server = Server().add_service(impl).start("127.0.0.1:0")
    return server, impl


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


class TestRetryPolicy:
    def test_no_retry_policy_fails_fast(self):
        class NeverRetry(RetryPolicy):
            def do_retry(self, cntl):
                return False

        server, impl = start_server()
        try:
            ch = Channel(ChannelOptions(
                max_retry=3, retry_policy=NeverRetry())).init(
                str(server.listen_endpoint()))
            stub = Stub(ch, ECHO_DESC)
            impl.close_next_connection = True
            with pytest.raises(RpcError) as ei:
                stub.Echo(echo_pb2.EchoRequest(message="m"))
            assert ei.value.error_code == errors.EFAILEDSOCKET
            assert impl.calls == 1  # no second attempt
        finally:
            server.stop()
            server.join(timeout=2)

    def test_default_policy_retries_socket_failure(self):
        server, impl = start_server()
        try:
            ch = Channel(ChannelOptions(max_retry=3)).init(
                str(server.listen_endpoint()))
            stub = Stub(ch, ECHO_DESC)
            impl.close_next_connection = True
            assert stub.Echo(echo_pb2.EchoRequest(message="m")).message \
                == "m"
            assert impl.calls == 2
        finally:
            server.stop()
            server.join(timeout=2)

    def test_retry_on_codes_set(self):
        policy = RetryOnCodes({errors.EINTERNAL}, include_default=False)

        class FakeCntl:
            error_code = errors.EINTERNAL

        assert policy.do_retry(FakeCntl())
        FakeCntl.error_code = errors.EFAILEDSOCKET
        assert not policy.do_retry(FakeCntl())

    def test_backup_policy_vetoes_hedge(self):
        class NoBackup(BackupRequestPolicy):
            asked = 0

            def do_backup(self, cntl):
                NoBackup.asked += 1
                return False

        server, impl = start_server()
        try:
            ch = Channel(ChannelOptions(
                backup_request_ms=20, backup_request_policy=NoBackup(),
                timeout_ms=2000)).init(str(server.listen_endpoint()))
            stub = Stub(ch, ECHO_DESC)
            cntl = Controller()
            resp = stub.Echo(echo_pb2.EchoRequest(message="m",
                                                  sleep_us=100_000),
                             controller=cntl)
            assert resp.message == "m"
            # the backup timer fired inside the 100 ms the server slept;
            # the policy was asked and said no, so no hedge went out
            assert NoBackup.asked == 1
            assert not cntl._backup_sent
            assert impl.calls == 1
        finally:
            server.stop()
            server.join(timeout=2)

    def test_backup_fires_by_default(self):
        server, impl = start_server()
        try:
            ch = Channel(ChannelOptions(
                backup_request_ms=20, timeout_ms=2000)).init(
                str(server.listen_endpoint()))
            stub = Stub(ch, ECHO_DESC)
            cntl = Controller()
            resp = stub.Echo(echo_pb2.EchoRequest(message="m",
                                                  sleep_us=100_000),
                             controller=cntl)
            assert resp.message == "m"
            assert cntl._backup_sent
            assert _wait(lambda: impl.calls == 2)  # original + hedge
        finally:
            server.stop()
            server.join(timeout=2)


class _Cntl:
    def __init__(self, code):
        self.error_code = code


CODES = sorted({v for k, v in vars(jax_errors).items()
                if k.isupper() and isinstance(v, int)})


@pytest.mark.parametrize("make", [
    lambda m, e: m.DefaultRetryPolicy(),
    lambda m, e: m.default_retry_policy(),
    lambda m, e: m.RetryOnCodes({e.EINTERNAL, e.EOVERCROWDED}),
    lambda m, e: m.RetryOnCodes({e.EINTERNAL}, include_default=False),
    lambda m, e: m.TunnelRetryPolicy(),
    lambda m, e: m.TunnelRetryPolicy(include_default=False),
], ids=["default", "default_singleton", "codes", "codes_only", "tunnel",
        "tunnel_only"])
def test_verdicts_equal_the_jax_policies(make):
    """Every error code: the port's policy retries exactly where the JAX
    package's does."""
    jax_p = make(jax_retry, jax_errors)
    port_p = make(port_retry, errors)
    assert CODES and set(CODES) <= {v for k, v in vars(errors).items()
                                    if k.isupper() and isinstance(v, int)}
    for code in CODES:
        assert port_p.do_retry(_Cntl(code)) == jax_p.do_retry(_Cntl(code)), \
            code
    assert port_retry.BackupRequestPolicy().do_backup(None) \
        == jax_retry.BackupRequestPolicy().do_backup(None)


def test_the_abstract_policy_and_singleton():
    with pytest.raises(NotImplementedError):
        RetryPolicy().do_retry(_Cntl(errors.EFAILEDSOCKET))
    assert default_retry_policy() is default_retry_policy()
    assert isinstance(default_retry_policy(), DefaultRetryPolicy)
    assert TunnelRetryPolicy().do_retry(_Cntl(errors.EOVERCROWDED))


def test_channel_retries_through_a_policy_object():
    """A policy object on ChannelOptions decides the retry: the tunnel
    policy re-issues a call whose connection failed."""

    class FailOnce(Service):
        DESCRIPTOR = ECHO_DESC

        def __init__(self):
            super().__init__()
            self.calls = 0

        def Echo(self, cntl, request, done):
            self.calls += 1
            if self.calls == 1:
                cntl._srv_socket.set_failed(errors.EFAILEDSOCKET, "once")
                return None
            return echo_pb2.EchoResponse(message=request.message)

    impl = FailOnce()
    server = Server().add_service(impl).start("127.0.0.1:0")
    try:
        ch = Channel(ChannelOptions(
            max_retry=2, retry_policy=TunnelRetryPolicy())).init(
            str(server.listen_endpoint()))
        assert Stub(ch, ECHO_DESC).Echo(
            echo_pb2.EchoRequest(message="t")).message == "t"
        assert impl.calls == 2
    finally:
        server.stop()
        server.join(timeout=2)

"""The port's counterpart of the JAX package's ``tests/test_thrift.py``:
every case runs against the port's servers and clients.

Thrift framed protocol tests: TBinary codec units plus client+server
integration over loopback (the reference's brpc_thrift_* test pattern)."""

import struct
import threading

import pytest

from brpc_tpu_torch.policy.thrift_protocol import (
    MT_CALL,
    MT_REPLY,
    ThriftBinaryReader,
    ThriftBinaryWriter,
    ThriftRawMessage,
    ThriftService,
    pack_message,
    thrift_method,
    unpack_message,
)
from brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, ServerOptions, errors
from brpc_tpu_torch.rpc.channel import RpcError


class TestTBinaryCodec:
    def test_struct_roundtrip(self):
        body = (ThriftBinaryWriter()
                .write_bool(1, True)
                .write_byte(2, -5)
                .write_i16(3, 1000)
                .write_i32(4, -70000)
                .write_i64(5, 1 << 40)
                .write_double(6, 2.5)
                .write_string(7, "héllo")
                .field_stop().bytes())
        fields = ThriftBinaryReader(body).read_struct()
        assert fields[1][1] is True
        assert fields[2][1] == -5
        assert fields[3][1] == 1000
        assert fields[4][1] == -70000
        assert fields[5][1] == 1 << 40
        assert fields[6][1] == 2.5
        assert fields[7][1].decode() == "héllo"

    def test_nested_struct(self):
        inner = (ThriftBinaryWriter().write_i32(1, 7).field_stop().bytes())
        outer = (ThriftBinaryWriter()
                 .write_struct(1, inner)
                 .write_string(2, "x")
                 .field_stop().bytes())
        fields = ThriftBinaryReader(outer).read_struct()
        assert ThriftBinaryReader(fields[1][1]).read_struct()[1][1] == 7
        assert fields[2][1] == b"x"

    def test_message_roundtrip(self):
        frame = pack_message(MT_CALL, "Echo", 42, b"\x00")
        n = struct.unpack("!I", frame[:4])[0]
        assert len(frame) == 4 + n
        mtype, name, seqid, body = unpack_message(frame[4:])
        assert (mtype, name, seqid, body) == (MT_CALL, "Echo", 42, b"\x00")


def make_echo_service():
    svc = ThriftService()

    def echo(args_body: bytes) -> bytes:
        fields = ThriftBinaryReader(args_body).read_struct()
        msg = fields[1][1]
        return (ThriftBinaryWriter().write_string(0, msg)
                .field_stop().bytes())

    def boom(args_body: bytes) -> bytes:
        raise RuntimeError("kaput")

    svc.add_method("Echo", echo).add_method("Boom", boom)
    return svc


@pytest.fixture()
def thrift_server():
    server = Server(ServerOptions(
        thrift_service=make_echo_service())).start("127.0.0.1:0")
    yield server
    server.stop()
    server.join(timeout=2)


def thrift_channel(server, **opts):
    opts.setdefault("protocol", "thrift")
    return Channel(ChannelOptions(**opts)).init(str(server.listen_endpoint()))


def call_echo(ch, text, **kw):
    args = (ThriftBinaryWriter().write_string(1, text).field_stop().bytes())
    resp = ch.call_method(thrift_method("Echo"), ThriftRawMessage(args),
                          ThriftRawMessage(), **kw)
    return ThriftBinaryReader(resp.body).read_struct()[0][1].decode()


class TestThriftEndToEnd:
    def test_echo(self, thrift_server):
        ch = thrift_channel(thrift_server)
        assert call_echo(ch, "hello-thrift") == "hello-thrift"

    def test_pipelined_and_concurrent(self, thrift_server):
        ch = thrift_channel(thrift_server, timeout_ms=5000)
        bad = []

        def worker(i):
            for j in range(20):
                try:
                    got = call_echo(ch, f"{i}.{j}")
                except Exception as e:
                    bad.append((i, j, repr(e)))
                    return
                if got != f"{i}.{j}":
                    bad.append((i, j, got))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not bad
        assert thrift_server.connection_count() == 1

    def test_unknown_method_returns_exception(self, thrift_server):
        ch = thrift_channel(thrift_server)
        with pytest.raises(RpcError) as ei:
            ch.call_method(thrift_method("Nope"), ThriftRawMessage(),
                           ThriftRawMessage())
        assert ei.value.error_code == errors.EINTERNAL
        assert "unknown method" in str(ei.value)

    def test_handler_exception_maps_to_error(self, thrift_server):
        ch = thrift_channel(thrift_server)
        with pytest.raises(RpcError) as ei:
            ch.call_method(thrift_method("Boom"), ThriftRawMessage(),
                           ThriftRawMessage())
        assert "kaput" in str(ei.value)

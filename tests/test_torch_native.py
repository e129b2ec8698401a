"""The port's native C++ core (``brpc_tpu_torch/native``) against the JAX
package's and against the port's own pure-Python paths: crc32c, fast_rand
bounds and the batched TRPC/TSTR frame scanner, on the cases of
``tests/test_native.py`` and on random frames (hypothesis: cut tails, bad
magic, oversized bodies, the ``max_frames`` cap). A subprocess shows that
the port builds and maps its own libraries, never the reference's."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from brpc_tpu import native as jax_native
from brpc_tpu_torch import native
from brpc_tpu_torch.butil import misc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    return native.load()


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.load()
    assert lib is not None, jax_native.build_error()
    return lib


def _python_crc32c(data, value=0):
    saved = misc._native_crc32c
    misc._native_crc32c = None
    try:
        return misc.crc32c(data, value)
    finally:
        misc._native_crc32c = saved


def _frame(magic=b"TRPC", meta=b"m" * 5, body=b"b" * 9):
    return magic + struct.pack("!II", len(meta), len(body)) + meta + body


class TestBuild:
    def test_builds_under_the_checkouts_build_dir(self, lib):
        so = native.builds["core"]["so"]
        assert os.path.dirname(so) == os.path.join(
            REPO, "build", "brpc_tpu_torch", "native")
        assert os.path.basename(so).startswith("_core_")
        native.load_dataplane()
        assert os.path.basename(
            native.builds["dataplane"]["so"]).startswith("_dataplane_")

    def test_failed_build_raises_with_the_compilers_stderr(self, tmp_path,
                                                           monkeypatch):
        src = tmp_path / "broken.cpp"
        src.write_text("int main( {\n")
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
        with pytest.raises(native.NativeBuildError, match="broken.cpp"):
            native._build_so(str(src), "broken")

    def test_missing_compiler_raises(self, tmp_path, monkeypatch):
        src = tmp_path / "ok.cpp"
        src.write_text("extern \"C\" int f() { return 1; }\n")
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(native.NativeBuildError):
            native._build_so(str(src), "ok")

    def test_digest_covers_the_flags(self, tmp_path, monkeypatch):
        src = tmp_path / "f.cpp"
        src.write_text("extern \"C\" int f() { return 1; }\n")
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
        a = native._build_so(str(src), "f")
        b = native._build_so(str(src), "f", ("-pthread",))
        assert a != b and os.path.exists(a) and os.path.exists(b)
        assert native._build_so(str(src), "f") == a
        assert native.builds["f"]["built"] is False


class TestCrc32c:
    def test_matches_python(self, lib):
        native.install()
        for data in (b"", b"a", b"hello world", bytes(range(256)) * 33):
            assert misc.crc32c(data) == _python_crc32c(data), data[:16]

    def test_known_vector(self, lib):
        native.install()
        # RFC 3720 test vector: crc32c of 32 zero bytes
        assert misc.crc32c(b"\x00" * 32) == 0x8A9136AA

    def test_chaining(self, lib):
        native.install()
        a = misc.crc32c(b"hello ")
        assert misc.crc32c(b"world", a) == misc.crc32c(b"hello world")

    def test_seeded_buffers_equal_the_jax_core(self, lib, jax_lib):
        rng = np.random.default_rng(17)
        for n in (0, 1, 7, 8, 9, 63, 64, 65, 4096, 100003):
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            seed = int(rng.integers(0, 2 ** 32))
            got = lib.tn_crc32c(data, len(data), seed)
            assert got == jax_lib.tn_crc32c(data, len(data), seed)
            assert got == _python_crc32c(data, seed)

    @settings(max_examples=60, deadline=None)
    @given(st.binary(max_size=2048), st.integers(0, 2 ** 32 - 1))
    def test_random_bytes_equal_jax_and_python(self, data, seed):
        lib = native.load()
        got = lib.tn_crc32c(data, len(data), seed)
        assert got == jax_native.load().tn_crc32c(data, len(data), seed)
        assert got == _python_crc32c(data, seed)


class TestFastRand:
    def test_distribution_sane(self, lib):
        native.install()
        vals = [misc.fast_rand() for _ in range(2000)]
        assert len(set(vals)) == 2000
        assert all(misc.fast_rand_less_than(7) < 7 for _ in range(500))
        assert misc.fast_rand_less_than(0) == 0

    def test_same_state_same_stream_as_the_jax_core(self, lib, jax_lib):
        import ctypes

        for bound in (1, 2, 7, 1000, 2 ** 40 + 3):
            a = ctypes.c_uint64(0x9E3779B97F4A7C15)
            b = ctypes.c_uint64(0x9E3779B97F4A7C15)
            got = [lib.tn_fast_rand_less_than(ctypes.byref(a), bound)
                   for _ in range(300)]
            want = [jax_lib.tn_fast_rand_less_than(ctypes.byref(b), bound)
                    for _ in range(300)]
            assert got == want
            assert all(0 <= v < bound for v in got)
            assert a.value == b.value


class TestFrameScanner:
    def test_scan_complete_frames(self, lib):
        sc = native.FrameScanner()
        f1, f2 = _frame(), _frame(magic=b"TSTR", body=b"x")
        frames, consumed, bad = sc.scan(f1 + f2, 1 << 31)
        assert not bad
        assert frames == [(0, 5, 9), (len(f1), 5, 1)]
        assert consumed == len(f1) + len(f2)

    def test_incomplete_tail(self, lib):
        sc = native.FrameScanner()
        f1 = _frame()
        frames, consumed, bad = sc.scan(f1 + f1[: len(f1) - 1], 1 << 31)
        assert not bad and len(frames) == 1 and consumed == len(f1)

    def test_bad_magic(self, lib):
        sc = native.FrameScanner()
        frames, consumed, bad = sc.scan(b"NOPE" + b"\x00" * 20, 1 << 31)
        assert bad and consumed == 0

    def test_oversized_frame_rejected(self, lib):
        sc = native.FrameScanner()
        f = _frame(body=b"y" * 100)
        frames, consumed, bad = sc.scan(f, 50)
        assert bad

    def test_max_frames_cap(self, lib):
        sc = native.FrameScanner(max_frames=2)
        f = _frame()
        frames, consumed, bad = sc.scan(f * 5, 1 << 31)
        assert len(frames) == 2 and consumed == 2 * len(f) and not bad


_frame_st = st.tuples(st.sampled_from([b"TRPC", b"TSTR"]),
                      st.binary(max_size=40), st.binary(max_size=200))


def _python_scan(data, max_body, max_frames):
    """The frame rule of policy/trpc_std (12-byte header, big-endian
    meta and body sizes), written out plainly. A bad frame reports no
    frames and the offset it starts at, as the scanner does."""
    frames, pos = [], 0
    while len(frames) < max_frames and len(data) - pos >= 12:
        if data[pos:pos + 4] not in (b"TRPC", b"TSTR"):
            return [], pos, True
        meta, body = struct.unpack("!II", data[pos + 4:pos + 12])
        if meta + body > max_body:
            return [], pos, True
        if len(data) - pos < 12 + meta + body:
            break
        frames.append((pos, meta, body))
        pos += 12 + meta + body
    return frames, pos, False


@settings(max_examples=120, deadline=None)
@given(frames=st.lists(_frame_st, max_size=8), cut=st.integers(0, 30),
       garbage=st.booleans(), max_body=st.sampled_from([1 << 31, 64, 150]),
       max_frames=st.integers(1, 9))
def test_scan_random_frames_equals_jax_and_python(frames, cut, garbage,
                                                  max_body, max_frames):
    data = b"".join(_frame(m, meta, body) for m, meta, body in frames)
    if garbage:
        data += b"NOPE" + b"\x00" * 12
    data = data[:max(0, len(data) - cut)]
    got = native.FrameScanner(max_frames=max_frames).scan(data, max_body)
    jax_sc = jax_native.FrameScanner(max_frames=max_frames)
    assert got == jax_sc.scan(data, max_body)
    assert got == _python_scan(data, max_body, max_frames)


_MAPS_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                ServerOptions, Service, Stub)

class Echo(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]
    def Echo(self, cntl, req, done):
        return echo_pb2.EchoResponse(message=req.message)

srv = Server(ServerOptions(native_dataplane=True))
srv.add_service(Echo())
srv.start("127.0.0.1:0")
ch = Channel(ChannelOptions(native_transport=True, timeout_ms=10000))
ch.init(str(srv.listen_endpoint()))
stub = Stub(ch, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
assert stub.Echo(echo_pb2.EchoRequest(message="m")).message == "m"
maps = open("/proc/self/maps").read()
srv.stop(); srv.join()
print("REF" if "brpc_tpu/native/_" in maps else "NOREF")
print("PORT" if "build/brpc_tpu_torch/native/_dataplane_" in maps
      and "build/brpc_tpu_torch/native/_core_" in maps else "NOPORT")
print("JAX" if any(m.startswith(("jax", "brpc_tpu."))
                   or m == "brpc_tpu" for m in sys.modules) else "NOJAX")
"""


def test_the_port_maps_its_own_libraries_never_the_references():
    out = subprocess.run(
        [sys.executable, "-c", _MAPS_CHILD, REPO], capture_output=True,
        text=True, timeout=240, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["NOREF", "PORT", "NOJAX"], out.stdout

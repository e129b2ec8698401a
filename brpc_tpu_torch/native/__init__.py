"""native — the C++ core, built at first use and loaded with ctypes.

The port's copy of the JAX package's ``native/``: ``core.cpp`` (crc32c,
fast_rand, the batched TRPC/TSTR frame scanner) and ``dataplane.cpp`` (the
dataplane engine: epoll loops, the TCP and TPUC shared-memory tunnel lanes,
registered native services, the engine-parsed fast call path, and the h2
half: the gRPC server lane on a native listener and the gRPC client lane of
``rpc/native_transport.py``'s ``connect_grpc``).

Each source is compiled by one ``g++`` call on first use into
``build/brpc_tpu_torch/native/_<stem>_<digest>.so`` at the root of the
checkout; the digest covers the source, its local headers and the flags,
and the library is written to a temp file then renamed, so a concurrent
loader never sees half a file. Nothing builds at import. A failed build
raises :class:`NativeBuildError` with the compiler's stderr: the port has
no silent pure-Python fallback for a lane the caller asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from typing import Dict

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "core.cpp")
_DP_SRC = os.path.join(_DIR, "dataplane.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "brpc_tpu_torch", "native")

_lib = None
_lib_lock = threading.Lock()
_dp_lib = None
_dp_lock = threading.Lock()
# stem -> {"so", "seconds", "built"}: what the last load did (chip_smoke
# prints it; "built" is False when a cached library was loaded)
builds: Dict[str, dict] = {}


class NativeBuildError(RuntimeError):
    """The C++ core could not be compiled or loaded."""


def _build_flags():
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    if platform.machine() in ("x86_64", "AMD64"):
        flags.append("-msse4.2")
    return flags


def compiler_version() -> str:
    """First line of ``g++ --version`` (raises when there is no g++)."""
    try:
        out = subprocess.run(["g++", "--version"], check=True,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"g++ not usable: {e}") from e
    return out.stdout.splitlines()[0] if out.stdout else "g++"


def _build_so(src: str, stem: str, extra_flags=(), headers=()) -> str:
    """Compile src into a digest-named .so under BUILD_DIR; raises
    NativeBuildError (with g++'s stderr) on failure."""
    flags = [*_build_flags(), *extra_flags]
    sha = hashlib.sha256()
    for path in (src, *headers):
        with open(path, "rb") as f:
            sha.update(f.read())
    sha.update(" ".join(flags).encode())
    so = os.path.join(BUILD_DIR, f"_{stem}_{sha.hexdigest()[:16]}.so")
    if os.path.exists(so):
        builds[stem] = {"so": so, "seconds": 0.0, "built": False}
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *flags, src, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"g++ could not run on {src}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed on {src} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    builds[stem] = {"so": so, "seconds": time.perf_counter() - t0,
                    "built": True}
    return so


def _cdll(so: str) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(so)
    except OSError as e:
        raise NativeBuildError(f"cannot load {so}: {e}") from e


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native core; raises
    :class:`NativeBuildError` when it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _build_so(_SRC, "core")
        lib = _cdll(so)
        lib.tn_crc32c.restype = ctypes.c_uint32
        lib.tn_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_uint32]
        lib.tn_fast_rand.restype = ctypes.c_uint64
        lib.tn_fast_rand.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        lib.tn_fast_rand_less_than.restype = ctypes.c_uint64
        lib.tn_fast_rand_less_than.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
        lib.tn_frame_scan.restype = ctypes.c_int
        lib.tn_frame_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.tn_abi_version.restype = ctypes.c_int
        if lib.tn_abi_version() != 1:
            raise NativeBuildError(
                f"{so}: core abi {lib.tn_abi_version()}, expected 1")
        _lib = lib
        return _lib


# ---------------------------------------------------------------- dataplane
class DpEventStruct(ctypes.Structure):
    """Mirror of DpEvent in dataplane.cpp."""

    _fields_ = [
        ("kind", ctypes.c_int32),
        ("tag", ctypes.c_int32),
        ("conn_id", ctypes.c_uint64),
        ("aux", ctypes.c_int64),
        ("base", ctypes.c_void_p),
        ("meta", ctypes.c_void_p),
        ("meta_len", ctypes.c_uint64),
        ("body", ctypes.c_void_p),
        ("body_len", ctypes.c_uint64),
    ]


def load_dataplane() -> ctypes.CDLL:
    """Build (if needed) and load the dataplane engine; raises
    :class:`NativeBuildError` when it cannot be built or loaded."""
    global _dp_lib
    with _dp_lock:
        if _dp_lib is not None:
            return _dp_lib
        so = _build_so(_DP_SRC, "dataplane", ("-pthread",),
                       headers=(os.path.join(_DIR, "hpack_tables.h"),))
        lib = _cdll(so)
        ev_p = ctypes.POINTER(DpEventStruct)
        lib.dp_abi_version.restype = ctypes.c_int
        lib.dp_rt_create.restype = ctypes.c_void_p
        lib.dp_rt_create.argtypes = [ctypes.c_int, ctypes.c_uint64]
        lib.dp_rt_shutdown.argtypes = [ctypes.c_void_p]
        lib.dp_listen.restype = ctypes.c_int
        lib.dp_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int]
        lib.dp_listener_close.restype = ctypes.c_int
        lib.dp_listener_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dp_listen_port.restype = ctypes.c_int
        lib.dp_listen_port.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dp_register_echo.restype = ctypes.c_int
        lib.dp_register_echo.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_char_p, ctypes.c_char_p]
        lib.dp_unregister_listener_echoes.restype = ctypes.c_int
        lib.dp_unregister_listener_echoes.argtypes = [ctypes.c_void_p,
                                                      ctypes.c_int]
        lib.dp_connect.restype = ctypes.c_uint64
        lib.dp_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.dp_connect_tpu.restype = ctypes.c_uint64
        lib.dp_connect_tpu.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.dp_connect_tpu2.restype = ctypes.c_uint64
        lib.dp_connect_tpu2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_uint32,
                                        ctypes.c_uint32,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.dp_connect_grpc.restype = ctypes.c_uint64
        lib.dp_connect_grpc.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.dp_listener_set_tpu.restype = ctypes.c_int
        lib.dp_listener_set_tpu.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
        lib.dp_send.restype = ctypes.c_int
        lib.dp_send.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_char_p, ctypes.c_uint64]
        lib.dp_sendv.restype = ctypes.c_int
        lib.dp_sendv.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.c_int]
        lib.dp_poll.restype = ctypes.c_int
        lib.dp_poll.argtypes = [ctypes.c_void_p, ev_p, ctypes.c_int,
                                ctypes.c_int]
        lib.dp_poll_packed.restype = ctypes.c_int
        lib.dp_poll_packed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_uint64, ctypes.c_int,
                                       ctypes.c_int]
        lib.dp_free.argtypes = [ctypes.c_void_p]
        lib.dp_conn_close.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dp_conn_stats.restype = ctypes.c_int
        lib.dp_conn_stats.argtypes = [ctypes.c_void_p, ctypes.c_uint64] + \
            [ctypes.POINTER(ctypes.c_uint64)] * 4
        lib.dp_bench_echo.restype = ctypes.c_int
        lib.dp_bench_echo.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ] + [ctypes.POINTER(ctypes.c_double)] * 5
        lib.dp_bench_echo2.restype = ctypes.c_int
        lib.dp_bench_echo2.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p,
        ] + [ctypes.POINTER(ctypes.c_double)] * 5
        # fast path (abi 2): engine-side meta parse/pack for Python RPCs
        lib.dp_listener_set_fastpath.restype = ctypes.c_int
        lib.dp_listener_set_fastpath.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int, ctypes.c_int]
        lib.dp_conn_set_fastpath.restype = ctypes.c_int
        lib.dp_conn_set_fastpath.argtypes = [ctypes.c_void_p,
                                             ctypes.c_uint64, ctypes.c_int]
        lib.dp_respond.restype = ctypes.c_int
        lib.dp_respond.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.dp_call.restype = ctypes.c_int
        lib.dp_call.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_int]
        lib.dp_flush_all.restype = ctypes.c_int
        lib.dp_flush_all.argtypes = [ctypes.c_void_p]
        lib.dp_tpu_ack.restype = ctypes.c_int
        lib.dp_tpu_ack.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_char_p, ctypes.c_uint64]
        lib.dp_svc_set_limit.restype = ctypes.c_int
        lib.dp_svc_set_limit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int]
        lib.dp_listener_set_logoff.restype = ctypes.c_int
        lib.dp_listener_set_logoff.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int]
        lib.dp_svc_stats.restype = ctypes.c_int
        lib.dp_svc_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32)]
        # abi 3: engine-parked sync calls (dp_call_sync) — the caller
        # blocks in C with the GIL released; the parse thread completes it
        lib.dp_call_sync.restype = ctypes.c_int
        lib.dp_call_sync.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.dp_call2.restype = ctypes.c_int
        lib.dp_call2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64]
        lib.dp_respond2.restype = ctypes.c_int
        lib.dp_respond2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64]
        lib.dp_call_sync2.restype = ctypes.c_int
        lib.dp_call_sync2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64]
        lib.dp_sync_complete_py.restype = ctypes.c_int
        lib.dp_sync_complete_py.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
        if lib.dp_abi_version() != 3:
            raise NativeBuildError(
                f"{so}: dataplane abi {lib.dp_abi_version()}, expected 3")
        _dp_lib = lib
        return _dp_lib


# ------------------------------------------------------------- installation
def install() -> bool:
    """Point the pure-Python hooks of ``butil.misc`` at the native core
    (crc32c, fast_rand). Raises when the core cannot be built."""
    lib = load()
    from brpc_tpu_torch.butil import misc

    def native_crc32c(data, value: int = 0) -> int:
        b = bytes(data)
        return lib.tn_crc32c(b, len(b), value)

    misc._native_crc32c = native_crc32c

    # entropy-seeded, like the Python fallback (identical sequences across
    # a fleet would synchronize "random" LB picks and jitter)
    state = ctypes.c_uint64(
        int.from_bytes(os.urandom(8), "little") | 1)

    def native_fast_rand() -> int:
        return lib.tn_fast_rand(ctypes.byref(state))

    def native_fast_rand_less_than(n: int) -> int:
        if n <= 0:
            return 0
        return lib.tn_fast_rand_less_than(ctypes.byref(state), n)

    misc._native_fast_rand = native_fast_rand
    misc._native_fast_rand_less_than = native_fast_rand_less_than
    return True


class FrameScanner:
    """Batched TRPC/TSTR frame-boundary scanner over a contiguous buffer."""

    def __init__(self, max_frames: int = 128):
        self._lib = load()
        self.max_frames = max_frames
        self._offsets = (ctypes.c_uint64 * (3 * max_frames))()
        self._consumed = ctypes.c_uint64()

    def scan(self, data: bytes, max_body: int):
        """Returns (frames, consumed, bad) where frames is a list of
        (start, meta_size, body_size) for each COMPLETE frame."""
        n = self._lib.tn_frame_scan(
            data, len(data), max_body, self._offsets, self.max_frames,
            ctypes.byref(self._consumed))
        bad = n < 0
        frames = [(self._offsets[i * 3], self._offsets[i * 3 + 1],
                   self._offsets[i * 3 + 2]) for i in range(max(n, 0))]
        return frames, self._consumed.value, bad

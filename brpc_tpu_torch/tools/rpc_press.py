#!/usr/bin/env python
"""rpc_press — load generator (counterpart of the reference tools/rpc_press).

Drives a target server at a fixed QPS (or flat-out with --qps 0) using async
calls, printing per-second throughput and a latency summary. The request is
an EchoService/Echo by default; any other service/method takes a
pre-serialized request body via --service/--method/--body-file, or its
message classes from a ``.proto`` (--proto, compiled by ``protoc`` at run
time) or a pre-compiled descriptor set (--descriptor-set), read by the
port's message runtime (``proto/_message.read_descriptor_set``).

Example:
    python -m brpc_tpu_torch.tools.rpc_press --server 127.0.0.1:8000 \\
        --qps 5000 --duration 10
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from brpc_tpu_torch.metrics.latency_recorder import (  # noqa: E402
    LatencyRecorder)
from brpc_tpu_torch.proto import _message  # noqa: E402
from brpc_tpu_torch.rpc import (Channel, ChannelOptions,  # noqa: E402
                                Controller, MethodDescriptor)
from brpc_tpu_torch.rpc.channel import RawMessage  # noqa: E402


def _method_from_files(files, full_method: str) -> MethodDescriptor:
    """Resolve pkg.Service.Method among a descriptor set's files into a
    callable MethodDescriptor over the classes read from the set."""
    try:
        return MethodDescriptor.from_pb(_message.find_method(files,
                                                             full_method))
    except KeyError as e:
        raise SystemExit(str(e)) from None


def load_proto_method(proto_path: str, incs: str, full_method: str):
    """Compile a user .proto with protoc and resolve pkg.Service.Method —
    the reference presses arbitrary services the same way (its
    pb_util.cpp imports the proto at runtime)."""
    if shutil.which("protoc") is None:
        raise SystemExit("rpc_press: --proto needs protoc on PATH; pass a "
                         "pre-compiled set with --descriptor-set instead")
    with tempfile.NamedTemporaryFile(suffix=".ds", delete=False) as tmp:
        ds_path = tmp.name
    try:
        inc_args = []
        for inc in (incs or "").split(";"):
            if inc:
                inc_args += ["-I", inc]
        inc_args += ["-I", os.path.dirname(os.path.abspath(proto_path))
                     or "."]
        cmd = ["protoc", *inc_args, "--include_imports",
               f"--descriptor_set_out={ds_path}", proto_path]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"protoc failed: {r.stderr.strip()}")
        with open(ds_path, "rb") as f:
            files = _message.read_descriptor_set(f.read())
    finally:
        os.unlink(ds_path)
    return _method_from_files(files, full_method)


def load_descriptor_method(ds_path: str, full_method: str):
    """Resolve pkg.Service.Method from a pre-compiled descriptor set
    (protoc --descriptor_set_out, or any vendored .desc) — presses run on
    hosts without a protoc binary."""
    with open(ds_path, "rb") as f:
        files = _message.read_descriptor_set(f.read())
    return _method_from_files(files, full_method)


def load_input_requests(path: str, request_class):
    """JSON requests (one object per line, or a top-level JSON list),
    converted through the json2pb bridge — reference json_loader.cpp."""
    import json

    from brpc_tpu_torch.json2pb import json_to_pb

    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        docs = [json.dumps(d) for d in json.loads(text)]
    else:
        docs = [line for line in text.splitlines() if line.strip()]
    if not docs:
        raise SystemExit(f"--input {path}: no JSON requests found")
    return [json_to_pb(doc, request_class) for doc in docs]


def build_method(args) -> tuple:
    if args.proto or args.descriptor_set:
        full = args.full_method or f"{args.service}.{args.method}"
        if args.descriptor_set:
            md = load_descriptor_method(args.descriptor_set, full)
        else:
            md = load_proto_method(args.proto, args.inc, full)
        if args.input:
            reqs = load_input_requests(args.input, md.request_class)
        else:
            reqs = [md.request_class()]
        return md, reqs
    if args.body_file:
        with open(args.body_file, "rb") as f:
            body = f.read()
        md = MethodDescriptor(args.service, args.method,
                              request_class=None, response_class=RawMessage)
        return md, [RawMessage(body)]
    from brpc_tpu_torch.proto import echo_pb2

    md = MethodDescriptor.from_pb(
        echo_pb2.DESCRIPTOR.services_by_name["EchoService"]
        .methods_by_name["Echo"])
    if args.input:
        return md, load_input_requests(args.input, md.request_class)
    return md, [echo_pb2.EchoRequest(message="x" * args.payload_size)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--server", required=True, help="host:port")
    p.add_argument("--qps", type=int, default=1000,
                   help="target rate; 0 = as fast as possible")
    p.add_argument("--duration", type=float, default=10.0, help="seconds")
    p.add_argument("--concurrency", type=int, default=64,
                   help="max in-flight calls")
    p.add_argument("--timeout-ms", type=int, default=1000)
    p.add_argument("--protocol", default="trpc_std")
    p.add_argument("--service", default="EchoService")
    p.add_argument("--method", default="Echo")
    p.add_argument("--full-method", default=None,
                   help="pkg.Service.Method (with --proto)")
    p.add_argument("--payload-size", type=int, default=16)
    p.add_argument("--body-file", default=None,
                   help="raw serialized request body")
    p.add_argument("--proto", default=None,
                   help="user .proto file (compiled via protoc at runtime)")
    p.add_argument("--descriptor-set", default=None,
                   help="pre-compiled FileDescriptorSet (.desc) — like "
                        "--proto but needs no protoc on this host")
    p.add_argument("--inc", default="",
                   help="include paths for --proto, ';'-separated")
    p.add_argument("--input", default=None,
                   help="JSON request file (one object per line or a list;"
                        " cycled round-robin)")
    p.add_argument("--output", default=None,
                   help="write response JSONs here (one per line)")
    p.add_argument("--pretty", action="store_true",
                   help="pretty-print --output jsons")
    p.add_argument("--lb-policy", default=None,
                   help="load balancer (rr/random/wrr/la/c_hash); --server"
                        " becomes a naming url, e.g. list://a:1,b:2")
    p.add_argument("--connection-type", default="single",
                   choices=("single", "pooled", "short"))
    p.add_argument("--attachment-size", type=int, default=0,
                   help="bytes of attachment carried with every request")
    p.add_argument("--compress", default="none",
                   choices=("none", "gzip", "zlib"))
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    from brpc_tpu_torch.policy import compress as _compress

    ct = {"none": _compress.COMPRESS_NONE, "gzip": _compress.COMPRESS_GZIP,
          "zlib": _compress.COMPRESS_ZLIB}[args.compress]
    channel = Channel(ChannelOptions(
        timeout_ms=args.timeout_ms, protocol=args.protocol,
        connection_type=args.connection_type, compress_type=ct,
        max_retry=0)).init(args.server, args.lb_policy)
    method, requests = build_method(args)
    attachment = b"\xab" * args.attachment_size

    out_f = open(args.output, "w") if args.output else None
    out_lock = threading.Lock()
    recorder = LatencyRecorder()
    sent = [0]
    errors_count = [0]
    inflight = threading.Semaphore(args.concurrency)
    stop_at = time.monotonic() + args.duration
    done_all = threading.Event()
    sender_done = [False]
    pending = [0]
    pending_lock = threading.Lock()

    def on_done(cntl: Controller) -> None:
        if cntl.failed():
            errors_count[0] += 1
        else:
            recorder.record(cntl.latency_us)
            if out_f is not None and cntl.response is not None:
                from brpc_tpu_torch.json2pb import pb_to_json

                try:
                    doc = pb_to_json(cntl.response, pretty=args.pretty)
                except Exception:
                    doc = "{}"
                with out_lock:
                    out_f.write(doc + "\n")
        inflight.release()
        with pending_lock:
            pending[0] -= 1
            if pending[0] == 0 and sender_done[0]:
                done_all.set()

    interval = 1.0 / args.qps if args.qps > 0 else 0.0
    next_fire = time.monotonic()
    last_report = time.monotonic()
    while time.monotonic() < stop_at:
        if interval:
            now = time.monotonic()
            if now < next_fire:
                time.sleep(min(next_fire - now, 0.01))
                continue
            next_fire += interval
        inflight.acquire()
        with pending_lock:
            pending[0] += 1
        request = requests[sent[0] % len(requests)]
        sent[0] += 1
        resp = method.response_class() if method.response_class else None
        cntl = None
        if attachment:
            cntl = Controller()
            cntl.request_attachment = attachment
        channel.call_method(method, request, response=resp, controller=cntl,
                            done=on_done)
        now = time.monotonic()
        if not args.quiet and now - last_report >= 1.0:
            last_report = now
            print(f"sent={sent[0]} qps={recorder.qps():.0f} "
                  f"avg={recorder.latency():.0f}us "
                  f"p99={recorder.latency_percentile(0.99):.0f}us "
                  f"errors={errors_count[0]}", file=sys.stderr)
    with pending_lock:
        sender_done[0] = True
        if pending[0] == 0:
            done_all.set()
    done_all.wait(timeout=args.timeout_ms / 1000.0 + 1.0)

    if out_f is not None:
        out_f.close()
    total = recorder.count()
    print(f"sent {sent[0]} ok {total} errors {errors_count[0]}")
    print(f"latency_avg_us {recorder.latency():.1f}")
    for q in (0.5, 0.9, 0.99, 0.999):
        print(f"latency_p{int(q * 1000) / 10:g}_us "
              f"{recorder.latency_percentile(q):.1f}")
    return 0 if errors_count[0] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

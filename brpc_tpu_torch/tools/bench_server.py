"""Echo server subprocess for the benches and the rdma_performance-style
sweep (the port's ``tools/bench_server.py``).

Run as a child process so client and server do not share a GIL — the
reference benchmarks likewise run client and server as separate binaries
(brpc's example/multi_threaded_echo_c++/server.cpp). Prints
``LISTEN <endpoint>`` once the listener is up, then serves until stdin
closes (the parent holds the pipe).

    python -m brpc_tpu_torch.tools.bench_server --listen 127.0.0.1:0
    python -m brpc_tpu_torch.tools.bench_server --listen tpu://127.0.0.1:0/0
    python -m brpc_tpu_torch.tools.bench_server --serving [--torch-device cpu]

The modes that hold a model or device memory (``--device``, ``--batch``,
``--serving``) run on ``cuda`` unless ``--torch-device cpu`` is given, and
raise with no card. At exit the stderr report ends with ``# launches
{json}``: the hand-written kernels' launches this process made (the
serving kernel's as ``flash_attention``); with ``--serving`` a ``#
serving {json}`` line before it gives the engine's prefix-cache misses
(its cold prefills) and hits.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from brpc_tpu_torch.proto import echo_pb2  # noqa: E402
from brpc_tpu_torch.rpc import Server, ServerOptions, Service  # noqa: E402

DIM = 256
LAYERS = 32
BUCKETS = (1, 8, 32)


def default_weights():
    """The MLP's W [LAYERS, DIM, DIM] and b [LAYERS, DIM], float32, from a
    CPU ``torch.Generator`` seeded 0 (W scaled by 1/sqrt(DIM), b by 0.01):
    the same values whatever the device."""
    gen = torch.Generator().manual_seed(0)
    W = torch.randn((LAYERS, DIM, DIM), generator=gen) / np.sqrt(DIM)
    b = torch.randn((LAYERS, DIM), generator=gen) * 0.01
    return W.numpy(), b.numpy()


def load_weights(path: str):
    """(W, b) from an ``.npz`` holding arrays ``W`` and ``b`` (for
    example the JAX bench server's, drawn from ``jax.random``)."""
    with np.load(path) as z:
        return z["W"], z["b"]


class BatchMLP(torch.nn.Module):
    """The reference's scanned MLP: ``h = relu(h @ W[l] + b[l])`` for each
    of the layers, float32."""

    def __init__(self, W: np.ndarray, b: np.ndarray):
        super().__init__()
        W = np.asarray(W, np.float32)
        b = np.asarray(b, np.float32)
        if W.shape != (LAYERS, DIM, DIM) or b.shape != (LAYERS, DIM):
            raise ValueError(f"want W {(LAYERS, DIM, DIM)} and b "
                             f"{(LAYERS, DIM)}, got {W.shape} and "
                             f"{b.shape}")
        self.register_buffer("W", torch.from_numpy(W.copy()))
        self.register_buffer("b", torch.from_numpy(b.copy()))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for l in range(self.W.shape[0]):
            h = torch.relu(h @ self.W[l] + self.b[l])
        return h


class BatchBenchService(Service):
    """--batch mode: the same MLP served two ways, so a bench can compare
    dispatch disciplines head to head on one process.

      Infer         — per-request: one forward call per RPC (B=1)
      InferBatched  — adaptive batching (brpc_tpu_torch.batch): concurrent
                      RPCs coalesce into one padded forward call per bucket

    Requests reuse EchoRequest: ``payload`` carries DIM float32 features;
    the response message is the output row's checksum so the client can
    verify real compute happened per item. The MLP (:class:`BatchMLP`)
    runs on ``device`` (``cuda`` unless ``"cpu"``), its weights
    :func:`default_weights` unless ``weights=(W, b)`` is given."""

    DIM = DIM
    LAYERS = LAYERS
    BUCKETS = BUCKETS

    def __init__(self, device=None, weights=None):
        from brpc_tpu_torch.batch import make_batched
        from brpc_tpu_torch.tpu.device_lane import resolve_device

        super().__init__()
        self.device = resolve_device(device)
        self.mlp = BatchMLP(*(weights if weights is not None
                              else default_weights())).to(self.device)
        self.add_method("Infer", self.Infer,
                        echo_pb2.EchoRequest, echo_pb2.EchoResponse)
        self.add_method(
            "InferBatched",
            make_batched("BatchBench.InferBatched", self.InferBatched,
                         max_batch_size=self.BUCKETS[-1], max_delay_us=2000,
                         bucket_shapes=self.BUCKETS,
                         # steady pipelined load: let size/deadline shape
                         # the batches; boundary flushes would fragment
                         # them (each readable event admits only a few)
                         flush_on_poll_batch=False),
            echo_pb2.EchoRequest, echo_pb2.EchoResponse)
        # every bucket's first call before any request
        for bb in self.BUCKETS:
            self.forward(np.zeros((bb, self.DIM), np.float32))

    @property
    def service_name(self) -> str:
        return "BatchBench"

    def forward(self, x: np.ndarray) -> np.ndarray:
        """[B, DIM] float32 rows -> [B, DIM], one forward call."""
        with torch.no_grad():
            return self.mlp(torch.from_numpy(x).to(self.device)) \
                .cpu().numpy()

    def _row(self, request):
        x = np.frombuffer(request.payload, np.float32)
        if x.shape != (self.DIM,):
            raise ValueError(f"want {self.DIM} float32 features, "
                             f"got {x.size}")
        return x.copy()  # the wire buffer is read-only

    def _response(self, y: np.ndarray):
        return echo_pb2.EchoResponse(message=f"{float(y.sum()):.4f}")

    def Infer(self, cntl, request, done):
        return self._response(self.forward(self._row(request)[None])[0])

    def InferBatched(self, batch):
        from brpc_tpu_torch.rpc import errors

        rows = []
        for i, r in enumerate(batch.requests):
            try:
                rows.append(self._row(r))
            except ValueError as e:
                batch.fail(i, errors.EREQUEST, str(e))
                rows.append(np.zeros(self.DIM, np.float32))
        y = self.forward(batch.stack(rows))  # ONE call for the whole batch
        return [self._response(y[i]) for i in range(batch.size)]


def _build_serving_engine(device=None):
    """--serving: small continuous-batching engine (brpc_tpu_torch/serving/)
    on ``device``, pre-warmed so no timed request pays a first call.
    Warmup sweeps the bench traffic's shape buckets — prefill S in {16,
    32}, decode batch B in {2, 4, 8}, context L in {32, 64} — and runs
    each round twice, as the reference does (its donated pools give
    every jit program a second signature)."""
    import threading

    from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                        ModelConfig, PagedKVCache,
                                        ServingEngine, TinyTransformer)

    cfg = ModelConfig(vocab=256, d_model=32, n_heads=2, n_layers=2)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=256),
                      cfg.n_layers, cfg.kv_dim, device=device)
    model = TinyTransformer(cfg, kv)
    engine = ServingEngine(model, kv, EngineConfig(
        max_batch=8, token_budget=512)).start()

    def round_(prompt_len):
        # staggered max_new: the batch shrinks through every B bucket
        # while the longest sequence keeps the batch's L bucket pinned
        evs = []
        for i in range(8):
            ev = threading.Event()
            code, _ = engine.submit(model.synth_prompt(prompt_len),
                                    2 * (i + 1),
                                    done=lambda _r, ev=ev: ev.set())
            if code != 0:
                raise RuntimeError(f"serving warmup rejected: {code}")
            evs.append(ev)
        for ev in evs:
            if not ev.wait(180):
                raise RuntimeError("serving warmup timed out")

    for _ in range(2):
        round_(32)   # contexts 33..48 -> 3-4 blocks -> L bucket 64
        round_(16)   # contexts 17..32 -> 2 blocks   -> L bucket 32
    return engine


class EchoServiceImpl(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def __init__(self, device_stream_impl=None):
        super().__init__()
        # --device mode: "device-stream[:window]" Echo requests open a
        # streaming-into-device-memory stream (tpu/device_stream.py)
        self.device_stream_impl = device_stream_impl

    def Echo(self, cntl, request, done):
        if (self.device_stream_impl is not None
                and request.message.startswith("device-stream")):
            return self.device_stream_impl.Echo(cntl, request, done)
        cntl.response_attachment = cntl.request_attachment
        return echo_pb2.EchoResponse(message=request.message,
                                     payload=request.payload)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", default="127.0.0.1:0")
    ap.add_argument("--native", action="store_true",
                    help="serve through the C++ dataplane engine")
    ap.add_argument("--native_echo", action="store_true",
                    help="answer EchoService.Echo entirely in C++")
    ap.add_argument("--inline", action="store_true",
                    help="run user methods inline on the native poller "
                         "(the reference's usercode-in-parsing-bthread "
                         "default; safe for non-blocking handlers)")
    ap.add_argument("--device", action="store_true",
                    help="serve DeviceDataService (this process owns the "
                         "card; payloads live in device memory, "
                         "tpu/device_lane.py)")
    ap.add_argument("--batch", action="store_true",
                    help="serve BatchBench (the same MLP as Infer "
                         "per-request vs InferBatched through the "
                         "adaptive batcher, brpc_tpu_torch/batch/)")
    ap.add_argument("--null", action="store_true",
                    help="answer Echo as the null-service CONTROL: raw "
                         "body echo from the poll loop, no policy "
                         "(bench ceiling isolation)")
    ap.add_argument("--serving", action="store_true",
                    help="serve LlmService (continuous-batching engine, "
                         "brpc_tpu_torch/serving/), warmed before LISTEN "
                         "so the bench measures serving, not first calls")
    ap.add_argument("--shard-workers", type=int, default=0,
                    help="spread dispatch over N worker processes "
                         "(brpc_tpu_torch/shard sharded dispatch plane; "
                         "the workers serve the same trpc_std echo)")
    ap.add_argument("--torch-device", default="cuda",
                    help="the device of --device, --batch and --serving: "
                         "cuda (the default) or cpu")
    ap.add_argument("--batch-weights", default="",
                    help="--batch: .npz of the MLP's W [32, 256, 256] and "
                         "b [32, 256] float32 (default: drawn from a "
                         "torch.Generator seeded 0)")
    args = ap.parse_args(argv)
    if args.null and not args.native:
        ap.error("--null requires --native (the control lane lives in "
                 "the native poll loop; without it you would measure the "
                 "full-policy path and call it the ceiling)")
    if args.shard_workers > 0:
        from brpc_tpu_torch import flags

        flags.set_flag("tpu_shard_workers", args.shard_workers)
    server = Server(ServerOptions(
        native_dataplane=args.native, usercode_inline=args.inline,
        shard_factory="brpc_tpu_torch.shard.testing:echo_services"))
    stream_impl = None
    store = None
    if args.device:
        from brpc_tpu_torch.examples import device_store
        from brpc_tpu_torch.tpu.device_lane import DeviceDataService
        from brpc_tpu_torch.tpu.device_stream import DeviceStreamEchoService

        store = device_store(args.torch_device)
        server.add_service(DeviceDataService(store))
        # streaming-into-device-memory lane (tpu/device_stream.py): blocks
        # arrive by reference, consumption = heavy on-device pump, block
        # kept resident so the bench can stream it repeatedly
        stream_impl = DeviceStreamEchoService(store, rounds=1024,
                                              free_after=False)
    if args.batch:
        server.add_service(BatchBenchService(
            args.torch_device,
            load_weights(args.batch_weights) if args.batch_weights
            else None))
    serving_engine = None
    if args.serving:
        from brpc_tpu_torch.serving.service import LlmServingService

        serving_engine = _build_serving_engine(args.torch_device)
        server.add_service(LlmServingService(serving_engine))
    server.add_service(EchoServiceImpl(device_stream_impl=stream_impl))
    server.start(args.listen)
    if args.native_echo:
        server.register_native_echo("EchoService", "Echo")
    if args.null:
        server.register_null_method("EchoService", "Echo")
    if args.shard_workers > 0 and server._shard_plane is not None:
        # don't print LISTEN until the workers can take traffic — the
        # sweep must measure the plane, not worker interpreter boot
        server._shard_plane.wait_ready(30.0)
    print(f"LISTEN {server.listen_endpoint()}", flush=True)
    try:
        sys.stdin.read()  # parent closing the pipe is the stop signal
    except KeyboardInterrupt:
        pass
    server.stop()
    server.join()
    if serving_engine is not None:
        serving_engine.stop()
        # the engine's cold prefills (prefix-cache misses) and hits: each
        # miss launches the serving kernel once a layer, a hit none
        prefix = serving_engine.prefix
        print("# serving " + json.dumps({
            "prefix_miss_seqs": prefix.miss_seqs,
            "prefix_hit_seqs": prefix.hit_seqs}), file=sys.stderr,
            flush=True)
    # run-to-completion activation report: which methods ran inline on
    # the cut loop this run
    from brpc_tpu_torch.rpc import run_to_completion as _rtc

    st = _rtc.stats()
    per_method = " ".join(
        f"{name}:hits={m['hits']},ema_us={m['ema_us']},"
        f"demoted={int(m['demoted'])}"
        for name, m in st["methods"].items()) or "no-methods"
    print(f"# rtc inline_requests={st['inline_requests']} "
          f"inline_responses={st['inline_responses']} "
          f"demotions={st['demotions']} {per_method}",
          file=sys.stderr, flush=True)
    # series-ring report: the per-method qps rings the sampler daemon
    # accumulated while the sweep ran
    from brpc_tpu_torch.metrics.series import global_series

    for name, d in sorted(global_series().dump("rpc_method_*_qps").items()):
        nonzero = sum(1 for v in d["second"] if v)
        print(f"# vars series {name}: count={d['count']} "
              f"nonzero_1s={nonzero} last={d['last']}",
              file=sys.stderr, flush=True)
    # the hand-written kernels' launches (host-side counts, taken at each
    # launch; the serving kernel's under "flash_attention")
    from brpc_tpu_torch.tpu import pallas_ops

    if store is not None:
        store.fence()
    print("# launches " + json.dumps(pallas_ops.launches.snapshot()),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched-inference server on the port (the JAX package's
``examples/batched_inference/server.py``, over ``brpc_tpu_torch.batch``).

    python -m brpc_tpu_torch.examples.batched_inference.server \
        [--port 8014] [--device cpu] [--weights W.npy]

``Echo`` is declared with ``@batched_method``: concurrent RPCs coalesce
into ONE forward pass per flush (size, deadline or poll-batch boundary,
whichever comes first), padded to a declared bucket (1, 4 or 16 rows).
The model is the reference example's one layer, ``relu(x @ W)`` with W
[DIM, DIM] float32, as a torch forward on ``cuda`` unless ``--device
cpu`` is given; W is drawn from a ``torch.Generator`` seeded 0, or loaded
from a ``.npy`` file (``--weights``), which lets a caller hand it the JAX
example's W. Requests reuse EchoRequest: ``payload`` carries DIM float32
features. The response's message is the reference's (``batch=N
sum=...``, the batch the request rode in and its output row's sum) and
its ``payload`` the output row itself, DIM float32.

On SIGINT or SIGTERM it stops and prints ``batch {json}``: the forward
calls it made, the items they carried, and ``g_batch_size``.
"""

import argparse
import json
import signal
import sys
import threading

import numpy as np
import torch

from brpc_tpu_torch.batch import batched_method
from brpc_tpu_torch.batch import metrics as bmetrics
from brpc_tpu_torch.proto import echo_pb2
from brpc_tpu_torch.rpc import Server, Service, errors
from brpc_tpu_torch.tpu.device_lane import resolve_device

DIM = 64
BUCKETS = (1, 4, 16)


def default_weights() -> torch.Tensor:
    """W [DIM, DIM] from a CPU ``torch.Generator`` seeded 0: the same
    values whatever the device."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn((DIM, DIM), generator=gen, dtype=torch.float32)


class BatchedInferenceService(Service):
    DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

    def __init__(self, device=None, weights=None):
        self.device = resolve_device(device)
        w = (default_weights() if weights is None
             else torch.from_numpy(np.array(weights, np.float32)))
        if tuple(w.shape) != (DIM, DIM):
            raise ValueError(f"W must be [{DIM}, {DIM}], got "
                             f"{tuple(w.shape)}")
        self.W = w.to(self.device)
        self._lock = threading.Lock()
        self.calls = 0   # forward calls: one per flushed batch
        self.items = 0   # live requests those calls carried
        super().__init__()

    def forward(self, x: np.ndarray) -> np.ndarray:
        """[B, DIM] float32 rows -> relu(x @ W), one device call."""
        y = torch.relu(torch.from_numpy(x).to(self.device) @ self.W)
        return y.cpu().numpy()

    @batched_method(max_batch_size=16, max_delay_us=2000,
                    bucket_shapes=BUCKETS)
    def Echo(self, batch):
        rows = []
        for i, req in enumerate(batch.requests):
            x = np.frombuffer(req.payload, np.float32)
            if x.shape != (DIM,):
                # one malformed request fails alone; its batchmates ride on
                batch.fail(i, errors.EREQUEST,
                           f"want {DIM} float32 features, got {x.size}")
                x = np.zeros(DIM, np.float32)
            rows.append(x)
        y = self.forward(batch.stack(rows))   # ONE call for the whole batch
        with self._lock:
            self.calls += 1
            self.items += batch.size
        return [echo_pb2.EchoResponse(
                    message=f"batch={batch.size} sum={float(y[i].sum()):.4f}",
                    payload=y[i].tobytes())
                for i in range(batch.size)]


def report(service) -> None:
    """Print ``batch {json}`` on one line: forward calls, items, and the
    process's ``g_batch_size`` average."""
    print("batch " + json.dumps({
        "calls": service.calls, "items": service.items,
        "g_batch_size": bmetrics.g_batch_size.get_value()}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8014)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--weights", default="",
                    help=".npy file of W [DIM, DIM] float32 (default: "
                         "drawn from a torch.Generator seeded 0)")
    ap.add_argument("--run_seconds", type=float, default=0,
                    help="exit after N seconds (0 = until a signal)")
    args = ap.parse_args(argv)

    service = BatchedInferenceService(
        args.device, np.load(args.weights) if args.weights else None)
    # warm each bucket, so no request pays the first call's set-up
    for b in BUCKETS:
        service.forward(np.zeros((b, DIM), np.float32))
    server = Server()
    server.add_service(service)
    server.start(f"0.0.0.0:{args.port}")
    print(f"BatchedInference listening on {server.listen_endpoint()} "
          f"({service.device})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait(args.run_seconds or None)
    server.stop()
    server.join()
    report(service)
    return 0


if __name__ == "__main__":
    sys.exit(main())

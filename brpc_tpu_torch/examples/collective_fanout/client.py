"""Collective-lowered ParallelChannel on the port (the JAX package's
``examples/collective_fanout/client.py``; SURVEY §2.5).

The SAME ParallelChannel fan-out executes two ways:

  1. every sub-channel targets a local tpu:// device  -> ONE program over
     a mesh built from those devices (the merger IS the collective:
     sum -> the axis sum, gather -> the sharded assembly)
  2. forced RPC fallback -> one CollectiveService.Apply per sub-channel
     through the device-method lane, merged host-side

and the results agree.

    python -m brpc_tpu_torch.examples.collective_fanout.client \
        [--devices 8] [--cpu]

On the cards by default: n = min(--devices, cards) sub-channels, one per
card (one card: the lowering over that card). ``--cpu`` lays 8 positions
on the CPU (``mesh.use_cpu(8)``), as the JAX example pins itself to 8
virtual CPU devices.
"""

import argparse

import numpy as np
import torch

from brpc_tpu_torch.rpc import Channel
from brpc_tpu_torch.rpc.combo_channels import CollectiveScheme, ParallelChannel
from brpc_tpu_torch.tpu import mesh


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="8 positions on the CPU instead of the cards")
    args = p.parse_args(argv)
    if args.cpu:
        mesh.use_cpu(8)

    n = min(args.devices, mesh.device_count())
    pc = ParallelChannel()
    for i in range(n):
        pc.add_channel(Channel().init(f"tpu://localhost/{i}"))

    scheme = CollectiveScheme("example.scale", fn=lambda s: s * 3.0,
                              merge="sum")
    x = np.arange(n * 4, dtype=np.float32).reshape(n * 2, 2)

    m = pc.device_mesh(scheme.axis_name)
    print(f"sub-channels: {n} tpu:// devices on {mesh.devices()[0]}; "
          f"mesh detected: {m is not None}")
    out_collective = pc.call_tensor(x, scheme)
    assert isinstance(out_collective, torch.Tensor), "lowering not taken"
    out_collective = out_collective.cpu().numpy()
    out_rpc = np.asarray(pc._call_tensor_rpc(x, scheme))
    assert np.allclose(out_collective, out_rpc), "paths diverged!"
    print(f"mesh program result == {n}-RPC fallback result "
          f"(shape {out_collective.shape}) OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

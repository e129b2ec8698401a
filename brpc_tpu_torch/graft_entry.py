"""The flagship's graft entry points, on the port.

:func:`entry` is the counterpart of the JAX package's
``__graft_entry__.entry``: a callable and its example arguments for one
forward of the flagship transformer LM (vocab 2048, d_model 256, 8 heads,
4 layers, d_ff 1024, sequence 256, batch 4, bf16), with the trainer's
shipping attention (``flash_attention_mha``, the flash forward kernel on
the card) and plain norms, as the JAX entry's config has them. Weights
and tokens come from seeds 0 and 1 (``torch.Generator``; tests load the
JAX entry's parameters with ``TrainLM.load_params``). It runs on ``cuda``
unless ``device="cpu"`` is passed, and raises with no card.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``, over n ranks (``tpu/launch.py``: a
process per position, this one rank 0): one full sharded training step
(``train.make_train_step`` over ``mesh_factors(n)``, ring attention over
the sp ranks, the tp and dp x sp sums as collectives) at the reference's
tiny shapes, the ParallelChannel fan-out lowered onto the ranks against
its per-sub-channel RPC fallback, and one 256 KB echo through a
``tpu://`` server on the last position, first over the Python tunnel and
then over the C++ engine's shared-memory tunnel
(``native_transport=True``). The reference's dryrun is CPU-only by its
own definition (it forces the host platform with n virtual devices); the
port's ranks run on the CPU too (gloo), and ``mesh.use_cpu(n)``
names the n ``tpu://`` ordinals for the call, restoring what was set
before.

    python -m brpc_tpu_torch.graft_entry [n]
"""

from __future__ import annotations

import numpy as np
import torch

from brpc_tpu_torch.tpu import train

FLAGSHIP = dict(vocab=2048, d_model=256, n_heads=8, n_layers=4, d_ff=1024,
                max_seq=256)
BATCH, SEQ = 4, 256


def entry(device=None, dtype=torch.bfloat16):
    """(fn, (model, tokens)): ``fn(model, tokens)`` is one forward,
    tokens [4, 256] -> logits [4, 256, 2048]."""
    cfg = train.ModelConfig(**FLAGSHIP, dtype=dtype)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                          device=device)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(1))

    def fn(model, tokens):
        with torch.inference_mode():
            return model(tokens)

    return fn, (model, tokens.to(model.embed.device))


def dryrun_multichip(n_devices: int = 8) -> None:
    """One sharded train step, the collective fan-out and an RPC across
    the mesh, over ``n_devices`` CPU ranks; prints one OK line each,
    then the ranks' layout."""
    from brpc_tpu_torch.tpu import launch
    from brpc_tpu_torch.tpu import mesh as meshlib

    prev = meshlib.use_cpu(n_devices)
    try:
        dp, sp, tp = meshlib.mesh_factors(n_devices)
        with launch.launch({"dp": dp, "sp": sp, "tp": tp},
                           device="cpu") as ranks:
            heads = max(4, tp)
            seq = 8 * sp
            batch = max(2, dp)
            cfg = train.ModelConfig(
                vocab=128, d_model=16 * heads, n_heads=heads, n_layers=2,
                d_ff=32 * heads, max_seq=seq, dtype=torch.float32)
            model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                                  device=ranks.mesh.device)
            step, _, _ = train.make_train_step(cfg, ranks.mesh, lr=1e-2)
            loss = step(model, train.demo_batch(
                torch.Generator().manual_seed(1), cfg, batch, seq,
                device=ranks.mesh.device))
            print(f"dryrun_multichip: mesh dp={dp} sp={sp} tp={tp} "
                  f"loss={float(loss):.4f} OK")
            _dryrun_collective_fanout(n_devices)
            _dryrun_rpc_across_mesh(n_devices)
            d = ranks.describe()
            print(f"dryrun ranks: {d['ranks']} ranks, layout "
                  f"{d['layout']}, backend {d['backend']}")
    finally:
        meshlib.use_cpu(prev)


def _dryrun_affine(s):
    """The fan-out's fn: module-level, so the ranks import it by name."""
    return s * 2.0 + 1.0


def _dryrun_collective_fanout(n_devices: int) -> None:
    """The SAME ParallelChannel + CollectiveScheme executed (a) as ONE
    program over the n-position mesh (call_tensor: over the ranks while
    a rank mesh is launched) and (b) as one
    CollectiveService.Apply RPC per sub-channel with a host merge
    (_call_tensor_rpc). Reference semantics: parallel_channel.cpp:580
    (fan-out + merge)."""
    from brpc_tpu_torch.rpc import Channel
    from brpc_tpu_torch.rpc.combo_channels import (CollectiveScheme,
                                                   ParallelChannel)

    rng = np.random.default_rng(5)
    x = rng.normal(size=(4 * n_devices, 8)).astype(np.float32)
    for merge in ("gather", "sum"):
        pc = ParallelChannel()
        for i in range(n_devices):
            pc.add_channel(Channel().init(f"tpu://localhost/{i}"))
        scheme = CollectiveScheme("dryrun.affine", fn=_dryrun_affine,
                                  merge=merge)
        mesh = pc.device_mesh(scheme.axis_name)
        assert mesh is not None and mesh.shape[scheme.axis_name] == n_devices
        out_coll = pc.call_tensor(x, scheme).cpu().numpy()
        out_rpc = np.asarray(pc._call_tensor_rpc(x, scheme))
        np.testing.assert_allclose(out_coll, out_rpc, rtol=1e-6, atol=1e-6)
    print(f"dryrun fanout: collective == rpc OK "
          f"(merges=gather,sum over {n_devices}-dev mesh)")


def _dryrun_rpc_across_mesh(n_devices: int) -> None:
    """One RPC across the mesh through the real transport: a Server
    fronting position n - 1, a Channel dialing its tpu:// endpoint, the
    payload staged through the registered block pool
    (tpu/transport.py)."""
    from brpc_tpu_torch.proto import echo_pb2
    from brpc_tpu_torch.rpc import (Channel, ChannelOptions, Server,
                                    ServerOptions, Service, Stub)
    from brpc_tpu_torch.tpu import mesh as meshlib

    class MeshEcho(Service):
        DESCRIPTOR = echo_pb2.DESCRIPTOR.services_by_name["EchoService"]

        def Echo(self, cntl, request, done):
            # stage the payload through the addressed position's memory
            dev = meshlib.devices()[n_devices - 1]
            payload = b""
            if request.payload:
                arr = np.frombuffer(request.payload, dtype=np.uint8).copy()
                payload = torch.from_numpy(arr).to(dev).cpu().numpy() \
                    .tobytes()
            return echo_pb2.EchoResponse(message=request.message,
                                         payload=payload)

    server = Server(ServerOptions())
    server.add_service(MeshEcho())
    server.start(f"tpu://127.0.0.1:0/{n_devices - 1}")
    try:
        channel = Channel(ChannelOptions(protocol="trpc_std",
                                         timeout_ms=15000))
        channel.init(str(server.listen_endpoint()))
        stub = Stub(channel,
                    echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
        payload = bytes(range(256)) * 1024  # 256KB: exercises the block path
        resp = stub.Echo(echo_pb2.EchoRequest(message="mesh-rpc",
                                              payload=payload))
        assert resp.payload == payload and resp.message == "mesh-rpc"
        print(f"dryrun rpc: {server.listen_endpoint()} "
              f"256KB block-pool echo OK")
        _dryrun_native_lane(server, payload)
    finally:
        server.stop()
        server.join()


def _dryrun_native_lane(server, payload: bytes) -> None:
    """The same RPC through the C++ engine's shm tunnel (the engine is
    built on first use; a build failure raises)."""
    from brpc_tpu_torch.proto import echo_pb2
    from brpc_tpu_torch.rpc import Channel, ChannelOptions, Stub

    channel = Channel(ChannelOptions(protocol="trpc_std", timeout_ms=15000,
                                     native_transport=True))
    channel.init(str(server.listen_endpoint()))
    stub = Stub(channel, echo_pb2.DESCRIPTOR.services_by_name["EchoService"])
    resp = stub.Echo(echo_pb2.EchoRequest(message="native-lane",
                                          payload=payload))
    assert resp.payload == payload and resp.message == "native-lane"
    print("dryrun rpc: native shm-tunnel lane echo OK")


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)

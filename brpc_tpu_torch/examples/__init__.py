"""Example programs of the port, run as modules from the repo root."""


def device_store(device: str = "cuda"):
    """The ``--device`` of the device examples: ``cuda`` (the default,
    card 0) or ``cpu``, which also points ``tpu://`` ordinal 0 at the CPU.
    Returns this process's DeviceStore of that device."""
    from brpc_tpu_torch.tpu import mesh
    from brpc_tpu_torch.tpu.device_lane import global_store

    if device == "cpu":
        mesh.use_cpu(1)
    return global_store(device)


def report_launches(store=None) -> None:
    """Print the copy kernels' launches of this process on one line,
    ``launches {json}``, after fencing ``store`` if one is given."""
    import json

    from brpc_tpu_torch.tpu import pallas_ops

    if store is not None:
        store.fence()
    print("launches " + json.dumps(pallas_ops.launches.snapshot()),
          flush=True)

"""tpu:// device naming on the port: ``tpu://host/n`` names CUDA card n.

The port of ``brpc_tpu/tpu/mesh.py``'s :func:`resolve_device` only; the
mesh, its axes and the collectives wait for ROADMAP Queue 1 item 7(b).

A ``tpu://`` ordinal resolves to ``torch.device("cuda", n)``. A process
that has no card, or that runs on the CPU on purpose (the tests), says so
once through :func:`use_cpu`: ordinals below the count it gives then
resolve to the CPU, as the JAX package's resolve against the host
platform's virtual devices. Without a card and without that call,
resolving raises; nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.butil.endpoint import EndPoint

_cpu_devices = 0   # > 0: ordinals 0 .. _cpu_devices - 1 are the CPU


def use_cpu(count: int = 1) -> None:
    """Resolve the ordinals ``0 .. count - 1`` to the CPU from now on, in
    this process (``count`` 0 goes back to the cards)."""
    global _cpu_devices
    if count < 0:
        raise ValueError(f"use_cpu: count {count} < 0")
    _cpu_devices = int(count)


def resolve_device(ep: EndPoint) -> torch.device:
    """``tpu://host/ordinal`` -> the torch device it names. Raises for an
    ordinal this process lacks, and without a card unless the CPU was
    asked for."""
    if not ep.is_tpu():
        raise ValueError(f"not a tpu endpoint: {ep}")
    n = ep.device_ordinal
    if _cpu_devices:
        if 0 <= n < _cpu_devices:
            return torch.device("cpu")
        raise ValueError(f"no local device with ordinal {n}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{ep}: no CUDA device available; call "
            f"brpc_tpu_torch.tpu.mesh.use_cpu() to run tpu:// on the CPU")
    if 0 <= n < torch.cuda.device_count():
        return torch.device("cuda", n)
    raise ValueError(f"no local device with ordinal {n}")

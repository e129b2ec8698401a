"""The device mesh and ``tpu://`` device naming, on the port.

The port of ``brpc_tpu/tpu/mesh.py``. A ``tpu://host/n`` ordinal names
CUDA card n; a :class:`Mesh` lays named axes over positions, as JAX's
``jax.sharding.Mesh`` lays them over devices. Standard axis vocabulary:
dp (data: batch, KV pools), tp (tensor: heads), sp (sequence: ring
attention), pp (pipeline), ep (experts).

A mesh is one of two forms.

- **Replayed** (one controller, one device): one process replays every
  mesh position, as ``tpu/ring.py`` replays every ring position, and the
  collectives (``tpu/collective.py``) and the sharded serving stack
  compute what each position's program computes. Every position is the
  same device; the card machine lays 8 positions on its one H100 this
  way, and a mesh built by :func:`make_mesh` over positions of more than
  one device is refused: one process does not replay across devices.
- **Ranked** (a rank per position, ``tpu/launch.py``): ``launch.launch``
  starts a process per position, its caller rank 0, and hands rank 0 the
  mesh (``RankGroup.mesh``). Each rank owns its position's device; the
  mesh knows the rank's coordinate (:meth:`Mesh.coord`), the process
  group of each axis (:meth:`Mesh.group`, from ``DeviceMesh.get_group``)
  and the rank of each peer (:meth:`Mesh.peer`). The collectives, the
  ring, the sharded training step, mesh serving and the
  ``ParallelChannel``'s lowering then run as one program over the ranks,
  driven from rank 0 with the replayed form's global tensors in and
  out (:meth:`Mesh.run`).

A process that has no card, or that runs on the CPU on purpose (the
tests), says so once through :func:`use_cpu`: ordinals below the count
it gives then resolve to the CPU, and :func:`devices` lists that many
CPU positions, as the JAX package's resolve against the host platform's
virtual devices (``--xla_force_host_platform_device_count``). Without a
card and without that call, resolving raises; nothing falls back to the
CPU on its own. On the card, a caller lays several positions on it
explicitly: ``make_mesh(..., devices_list=[torch.device("cuda", 0)] *
8)``; without that, :func:`serving_mesh` over one card is 1 x 1 x 1, the
reference's one-chip case.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from brpc_tpu_torch.butil.endpoint import EndPoint

_cpu_devices = 0   # > 0: ordinals 0 .. _cpu_devices - 1 are the CPU
_lock = threading.Lock()
_default_mesh = None


def use_cpu(count: int = 1) -> int:
    """Resolve the ordinals ``0 .. count - 1`` to the CPU from now on, in
    this process (``count`` 0 goes back to the cards). Returns the count
    it replaces, for a caller that restores it."""
    global _cpu_devices
    if count < 0:
        raise ValueError(f"use_cpu: count {count} < 0")
    prev, _cpu_devices = _cpu_devices, int(count)
    return prev


def devices() -> List[torch.device]:
    """This process's positions: ``use_cpu(n)``'s n CPU positions, else
    one per card. Raises without a card unless the CPU was asked for."""
    if _cpu_devices:
        return [torch.device("cpu")] * _cpu_devices
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; call "
            "brpc_tpu_torch.tpu.mesh.use_cpu() to run on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def device_count() -> int:
    return len(devices())


def list_device_endpoints(host: str = "localhost") -> List[EndPoint]:
    """The tpu:// naming view of this process (one EndPoint per
    position)."""
    return [EndPoint.from_tpu(host, i) for i in range(device_count())]


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


class Mesh:
    """Named axes over an ndarray of positions (``torch.device`` each).
    ``shape`` is ``{axis: size}`` in axis order, as JAX's. Replayed by one
    process (every position the same device), or, with ``ranks``, a rank
    per position (``tpu/launch.py`` builds those)."""

    def __init__(self, positions: np.ndarray, axis_names, ranks=None):
        names = tuple(axis_names)
        if positions.ndim != len(names):
            raise ValueError(f"{positions.ndim}-d positions for axes "
                             f"{names}")
        distinct = sorted({str(d) for d in positions.flat})
        if ranks is None and len(distinct) != 1:
            raise ValueError(
                f"mesh over {distinct}: one process replays the positions "
                f"of one device; a mesh over several devices has a rank "
                f"per position (tpu/launch.launch)")
        self.devices = positions
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, positions.shape))
        self.ranks = ranks   # this process's rank context, or None

    @property
    def ranked(self) -> bool:
        """True for a mesh with a rank per position."""
        return self.ranks is not None

    @property
    def device(self) -> torch.device:
        """The one device every position lies on; over ranks, this rank's
        own position's device."""
        if self.ranks is not None:
            return self.ranks.device
        return self.devices.flat[0]

    # ------------------------------------------------ a rank per position
    @property
    def rank(self) -> int:
        return self.ranks.rank

    def coords(self, rank: int = None) -> Dict[str, int]:
        """{axis: index} of ``rank``'s position (default: this rank)."""
        r = self.ranks.rank if rank is None else rank
        idx = np.unravel_index(r, self.devices.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords()[axis]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis``, this rank's other
        coordinates kept."""
        c = self.coords()
        c[axis] = index % self.shape[axis]
        return int(np.ravel_multi_index([c[a] for a in self.axis_names],
                                        self.devices.shape))

    def group(self, *axes: str):
        """The process group over ``axes`` that holds this rank."""
        return self.ranks.group(self.axis_names, tuple(axes))

    def run(self, fn, *args, **kwargs) -> list:
        """Rank 0 only: ``fn(mesh, *args, **kwargs)`` on every rank, each
        with its view of this mesh; what each returned, by rank."""
        from brpc_tpu_torch.tpu import launch

        group = launch.active()
        if group is None or self.ranks.rank != 0:
            raise RuntimeError("only rank 0 of a launched mesh drives it")
        return group.run(fn, *args, mesh=self, **kwargs)

    def block(self, x, spec, rank: int = None):
        """This rank's (or ``rank``'s) block of a global ``x`` laid out as
        ``spec`` (an axis name or None per leading dim)."""
        c = self.coords(rank)
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = self.shape[axis]
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split into {n} blocks over {axis!r}")
            size = x.shape[dim] // n
            x = x.narrow(dim, c[axis] * size, size)
        return x

    def assemble(self, blocks, spec):
        """The global tensor of the per-rank ``blocks`` (a list by rank)
        laid out as ``spec``: position blocks placed by coordinate; the
        ranks that differ only along other axes hold replicas, of which
        the one at index 0 is taken."""
        rows = []
        for r, b in enumerate(blocks):
            c = self.coords(r)
            if all(c[a] == 0 for a in self.axis_names if a not in spec):
                rows.append((tuple(c[a] if a else 0 for a in spec), b))
        first = rows[0][1]
        shape = list(first.shape)
        for dim, axis in enumerate(spec):
            if axis is not None:
                shape[dim] *= self.shape[axis]
        out = torch.empty(shape, dtype=first.dtype)
        for idx, b in rows:
            view = out
            for dim, (axis, i) in enumerate(zip(spec, idx)):
                if axis is not None:
                    view = view.narrow(dim, i * b.shape[dim], b.shape[dim])
            view.copy_(b)
        return out

    def __repr__(self) -> str:
        if self.ranks is not None:
            return (f"Mesh({self.shape}, rank={self.ranks.rank}, "
                    f"device={self.device}, {self.ranks.backend})")
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(axis_sizes: Dict[str, int], devices_list=None) -> Mesh:
    """A :class:`Mesh` with named axes over ``devices_list`` (default:
    :func:`devices`). ``axis_sizes`` is ordered ``{axis: size}``; the
    sizes must multiply to the position count (one ``-1`` is
    inferred)."""
    devs = list(devices_list if devices_list is not None else devices())
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devs) // known
    total = int(np.prod(sizes))
    if total != len(devs):
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} devices, "
            f"have {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(sizes), names)


def mesh_factors(n: int) -> Tuple[int, int, int]:
    """Split n positions into (dp, sp, tp), preferring to use every axis
    (8 -> dp=2 sp=2 tp=2). Any n works: odd counts fold the even axes to
    1."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    sp = 2 if rem % 2 == 0 else 1
    dp = rem // sp
    return dp, sp, tp


def serving_mesh(devices_list=None) -> Mesh:
    """The serving plane's dp/sp/tp mesh: dp shards the request batch
    and the KV pools, sp carries the ring-attention lane, tp shards
    attention heads in prefill. 1 x 1 x 1 over one device."""
    devs = list(devices_list if devices_list is not None else devices())
    dp, sp, tp = mesh_factors(len(devs))
    return make_mesh({"dp": dp, "sp": sp, "tp": tp}, devices_list=devs)


def default_mesh(axis_name: str = "x") -> Mesh:
    """Process-wide 1-D mesh over all positions (the 'whole ring')."""
    global _default_mesh
    with _lock:
        if (_default_mesh is None
                or _default_mesh.axis_names != (axis_name,)):
            _default_mesh = make_mesh({axis_name: -1})
        return _default_mesh


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Which mesh axis each dim of a stacked tensor follows (``None``:
    replicated). The record names the layout; over ranks the programs
    that take such a tensor cut each rank's block by it
    (:meth:`Mesh.block`)."""

    mesh: Mesh
    spec: Tuple


def named_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))

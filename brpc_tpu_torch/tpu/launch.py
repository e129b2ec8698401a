"""A mesh with a rank per position: start the ranks, drive them from rank 0.

The reference's mesh is one SPMD program over the devices of a slice
(``brpc_tpu/tpu/mesh.py``): one controller hands global arrays in, and
each device runs its position's share. The port keeps that API and maps
it onto multi-controller PyTorch as a controller and its workers:

- :func:`launch` is called by the caller's process, which becomes rank 0
  (the controller: it runs the engine, the RPC front, the test). It spawns
  ranks 1 .. W - 1 (``torch.multiprocessing``, spawn), joins every rank
  into one ``torch.distributed`` group over a ``FileStore`` in a temporary
  directory (no TCP port to collide with), and lays the named axes over
  the ranks with ``init_device_mesh``. Rank r holds the position at flat
  index r of the axes (row-major, as ``DeviceMesh`` lays them).
- Ranks 1 .. W - 1 run a worker loop. For each mesh program (a train
  step, a serving step, a fan-out) rank 0 broadcasts a small header: the
  program's module-level function by name and its host arguments. Every
  rank then runs that function on its own position (rank 0 too), and
  what each returns is gathered to rank 0, which assembles the global
  result (:meth:`RankGroup.run`). So a caller calls an entry point once,
  never once per rank.

**The backend follows from the layout alone** (:func:`layout_for`): NCCL
when each rank has its own card (``rank_per_card``); gloo when ranks share
a card (``ranks_share_card``: NCCL refuses two ranks on one device) or run
on the CPU (``cpu``). A failed init raises; nothing falls back. Under gloo
a CUDA tensor crosses through one staging point here, a pinned host
buffer each way (:func:`_to_wire`, :func:`_from_wire`); gloo's partial
CUDA support (no ``send``/``recv`` of CUDA tensors) is not relied on.

**Nothing blocks rank 0 for good.** Each collective rank 0 issues waits at
most :data:`TIMEOUT_S`, and so does the launch itself. A worker
whose program raises writes its traceback to the store and exits; rank 0
then raises (with that traceback) as soon as its next collective with
the dead rank fails, and closes the group: the workers are stopped and
every later program raises. A worker outlives its controller by at most a
second (a watchdog thread).

Usage::

    from brpc_tpu_torch.tpu import launch
    with launch.launch({"dp": 2, "sp": 2, "tp": 2}, device="cpu") as ranks:
        train.make_train_step(cfg, ranks.mesh)[0](model, batch)

The collectives a program body issues go through the helpers below
(:func:`all_reduce`, :func:`all_gather`, :func:`all_to_all`,
:func:`exchange`), which time themselves into :data:`stats` (the phase
numbers: time in collectives and in staging, per rank).
"""

from __future__ import annotations

import datetime
import importlib
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120.0
# a worker waits this long for rank 0's next program; rank 0's own waits
# are bounded by TIMEOUT_S, and a worker whose controller is gone exits
# through the watchdog
_IDLE_TIMEOUT = datetime.timedelta(days=1)
_STOP = "stop"

LAYOUTS = {"cpu": "gloo", "ranks_share_card": "gloo",
           "rank_per_card": "nccl"}
# the process groups over several axes that programs use (the sharded
# step's dp x sp gradient sum); each layout has its one-axis groups too
MULTI_AXIS_GROUPS = (("dp", "sp"),)


def _multi_axis_sets(axes: Dict[str, int]) -> List[Tuple[str, ...]]:
    """The sets of :data:`MULTI_AXIS_GROUPS` that ``axes`` holds, in its
    axis order, short of all of them (that group is the world)."""
    out = []
    for sub in MULTI_AXIS_GROUPS:
        if set(sub) <= set(axes) and len(sub) < len(axes):
            out.append(tuple(a for a in axes if a in sub))
    return out


def layout_for(device_type: str, world: int, cards: int) -> Tuple[str, str]:
    """(layout, backend) of ``world`` ranks on ``device_type`` with
    ``cards`` CUDA cards: a function of the layout alone."""
    if world < 1:
        raise ValueError(f"world {world} < 1")
    if device_type == "cpu":
        return "cpu", LAYOUTS["cpu"]
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: cpu or cuda")
    if cards < 1:
        raise RuntimeError("no CUDA device available; launch on the CPU "
                           "with device='cpu'")
    layout = "rank_per_card" if world <= cards else "ranks_share_card"
    return layout, LAYOUTS[layout]


def position_device(layout: str, rank: int) -> torch.device:
    """The device rank ``rank`` computes on in ``layout``."""
    if layout == "cpu":
        return torch.device("cpu")
    if layout == "rank_per_card":
        return torch.device("cuda", rank)
    return torch.device("cuda", 0)


class Stats:
    """This process's time in collectives and in staging (seconds), the
    collectives issued and the bytes staged through host memory."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.collective_s = 0.0
        self.staging_s = 0.0
        self.collectives = 0
        self.staged_bytes = 0

    def snapshot(self) -> dict:
        return {"collective_s": self.collective_s,
                "staging_s": self.staging_s,
                "collectives": self.collectives,
                "staged_bytes": self.staged_bytes}


stats = Stats()
_comm: Optional["_Comm"] = None   # this process's rank, while launched
_active: Optional["RankGroup"] = None  # rank 0's open group
_state: Dict[str, object] = {}    # rank-local state of programs, by key


def comm() -> "_Comm":
    """This process's rank context; raises outside a launched mesh."""
    if _comm is None:
        raise RuntimeError("no rank mesh launched in this process")
    return _comm


def active() -> Optional["RankGroup"]:
    """Rank 0's open :class:`RankGroup`, or None."""
    return _active


def state() -> Dict[str, object]:
    """Rank-local state that programs keep between calls (parameter
    shards, KV pools), by key."""
    return _state


# ------------------------------------------------------------ the ranks
class _Comm:
    """One rank of a launched mesh: its position, the process group of
    each axis and of each set in :data:`MULTI_AXIS_GROUPS`, and its
    device."""

    def __init__(self, rank: int, world: int, axes: Dict[str, int],
                 device_type: str, timeout: datetime.timedelta,
                 store_path: str):
        from torch.distributed.device_mesh import init_device_mesh

        cards = torch.cuda.device_count() if device_type == "cuda" else 0
        self.layout, self.backend = layout_for(device_type, world, cards)
        self.rank, self.world = rank, world
        self.axes = dict(axes)
        self.device = position_device(self.layout, rank)
        self.timeout = timeout
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            self.backend, init_method=f"file://{store_path}", rank=rank,
            world_size=world, timeout=timeout)
        # the groups' device: gloo groups carry host tensors (staged)
        self.device_mesh = init_device_mesh(
            "cuda" if self.backend == "nccl" else "cpu",
            tuple(axes.values()), mesh_dim_names=tuple(axes),
            backend_override={a: _axis_options(self.backend, timeout)
                              for a in axes})
        self._groups = {tuple(axes): {(a,): self.device_mesh.get_group(a)
                                      for a in axes}}
        self._add_groups(self.axes, _multi_axis_sets(self.axes))
        self._views: Dict[Tuple, object] = {}

    def _add_groups(self, axes: Dict[str, int],
                    sets: Sequence[Tuple[str, ...]]) -> None:
        """The process groups over each set of a layout's axes in
        ``sets``, made by every rank in one order."""
        names = tuple(axes)
        mine = self._groups.setdefault(names, {})
        grid = np.arange(self.world).reshape(tuple(axes.values()))
        for sub in sets:
            dims = [names.index(a) for a in sub]
            rest = [i for i in range(len(names)) if i not in dims]
            flat = np.moveaxis(grid, rest + dims, range(len(names))).reshape(
                -1, int(np.prod([grid.shape[i] for i in dims])))
            for ranks in flat:
                g = dist.new_group([int(r) for r in ranks],
                                   timeout=self.timeout)
                if self.rank in ranks:
                    mine[sub] = g

    def mesh(self, axes: Optional[Dict[str, int]] = None):
        """The :class:`~brpc_tpu_torch.tpu.mesh.Mesh` of this rank: the
        launch's axes, a flat 1-axis view over every rank, or another
        layout of the same ranks made by :meth:`RankGroup.view`."""
        axes = dict(self.axes if axes is None else axes)
        m = self._views.get(tuple(axes.items()))
        if m is None:
            if tuple(axes) not in self._groups and (
                    len(axes) != 1 or list(axes.values()) != [self.world]):
                raise ValueError(f"no view {axes} of the rank mesh "
                                 f"{self.axes}: make it with "
                                 f"RankGroup.view")
            m = self._make_view(axes)
        return m

    def _make_view(self, axes: Dict[str, int]):
        from brpc_tpu_torch.tpu.mesh import Mesh

        if int(np.prod(list(axes.values()))) != self.world:
            raise ValueError(f"view {axes} over {self.world} ranks")
        if tuple(axes) not in self._groups and len(axes) > 1:
            self._add_groups(axes, [(a,) for a in axes]
                             + _multi_axis_sets(axes))
        positions = np.empty(self.world, dtype=object)
        positions[:] = [position_device(self.layout, r)
                        for r in range(self.world)]
        m = self._views[tuple(axes.items())] = Mesh(
            positions.reshape(tuple(axes.values())), tuple(axes),
            ranks=self)
        return m

    def group(self, mesh_axes: Tuple[str, ...], axes: Tuple[str, ...]):
        """The process group over ``axes`` of a mesh with ``mesh_axes``
        that holds this rank."""
        if set(axes) == set(mesh_axes):
            return dist.group.WORLD
        order = tuple(a for a in mesh_axes if a in axes)
        try:
            return self._groups[tuple(mesh_axes)][order]
        except KeyError:
            raise ValueError(f"no process group over {order} of the rank "
                             f"mesh {mesh_axes}: the groups over several "
                             f"axes are those of MULTI_AXIS_GROUPS") from None


def _axis_options(backend: str, timeout: datetime.timedelta):
    """(backend, options) that give ``init_device_mesh``'s axis groups the
    launch's timeout: without them each group waits torch's 30-minute
    default, at its creation too."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
    else:
        opts = torch._C._distributed_c10d.Backend.Options(backend, timeout)
    return backend, opts


# ----------------------------------------------------- the wire (staging)
def _wire_dtype(dtype: torch.dtype) -> Optional[torch.dtype]:
    # 16-bit floats cross as their bytes where nothing adds them (gloo
    # carries no 16-bit type)
    return torch.uint8 if dtype in (torch.bfloat16, torch.float16) else None


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend carries it: under gloo a CUDA tensor is
    copied into a pinned host buffer (the one staging point out)."""
    t = t.contiguous()
    if _comm is None or not _comm.staged or t.device.type != "cuda":
        return t
    t0 = time.perf_counter()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    stats.staging_s += time.perf_counter() - t0
    stats.staged_bytes += t.numel() * t.element_size()
    return host


def _from_wire(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received tensor on ``device`` (the one staging point in)."""
    if t.device == device:
        return t
    t0 = time.perf_counter()
    out = t.to(device)
    stats.staging_s += time.perf_counter() - t0
    stats.staged_bytes += t.numel() * t.element_size()
    return out


def _empty_wire(shape, dtype, device) -> torch.Tensor:
    if _comm is not None and _comm.staged and device.type == "cuda":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def _wait(work) -> None:
    """Waits for a collective, at most the launch's timeout."""
    if work is None:
        return
    if not work.wait(timeout=comm().timeout):
        raise RuntimeError("collective timed out")


class _Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        stats.collective_s += time.perf_counter() - self.t0
        stats.collectives += 1


# ---------------------------------------------------------- collectives
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``t`` over ``group``, on every member (a new
    tensor; 16-bit floats are added in fp32 and cast back)."""
    with _Timed():
        x = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
        w = _to_wire(x)
        if w is x:
            w = x.clone()
        _wait(dist.all_reduce(w, op=_OPS[op], group=group, async_op=True))
        return _from_wire(w, t.device).to(t.dtype)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every member's ``t``, in group rank order."""
    with _Timed():
        wd = _wire_dtype(t.dtype)
        w = _to_wire(t)
        w = w.view(wd) if wd else w
        outs = [torch.empty_like(w) for _ in range(dist.get_world_size(
            group))]
        _wait(dist.all_gather(outs, w, group=group, async_op=True))
        return [_from_wire(o.view(t.dtype) if wd else o, t.device)
                for o in outs]


def all_to_all(chunks: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Member j's ``chunks[i]`` lands as member i's ``out[j]`` (chunks of
    one shape and dtype)."""
    with _Timed():
        t = chunks[0]
        wd = _wire_dtype(t.dtype)
        flat = _to_wire(torch.stack(list(chunks)))
        flat = flat.view(wd) if wd else flat
        out = torch.empty_like(flat)
        _wait(dist.all_to_all_single(out, flat, group=group,
                                     async_op=True))
        out = _from_wire(out.view(t.dtype) if wd else out, t.device)
        return list(out.unbind(0))


class _Exchange:
    """Sends and receives posted together (``batch_isend_irecv``);
    :meth:`wait` returns what arrived, on the receiving tensors'
    device."""

    def __init__(self, sends, recvs, device):
        self._t0 = time.perf_counter()
        self.device = device
        ops, self._bufs = [], []
        for t, peer in sends:
            wd = _wire_dtype(t.dtype)
            w = _to_wire(t)
            ops.append(dist.P2POp(dist.isend, w.view(wd) if wd else w,
                                  peer))
        for (shape, dtype), peer in recvs:
            wd = _wire_dtype(dtype)
            b = _empty_wire(shape, dtype, device)
            self._bufs.append((b, dtype))
            ops.append(dist.P2POp(dist.irecv, b.view(wd) if wd else b,
                                  peer))
        self._works = dist.batch_isend_irecv(ops) if ops else []
        stats.collective_s += time.perf_counter() - self._t0

    def wait(self) -> List[torch.Tensor]:
        with _Timed():
            for w in self._works:
                _wait(w)
            return [_from_wire(b, self.device) for b, _ in self._bufs]


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[Tuple[tuple, torch.dtype], int]],
             device: torch.device) -> _Exchange:
    """Posts ``(tensor, peer)`` sends and ``((shape, dtype), peer)``
    receives between global ranks at once; the caller computes, then
    ``.wait()``s for the received tensors."""
    return _Exchange(sends, recvs, device)


def _host_tree(obj):
    """``obj`` with every tensor moved to the host (what is gathered)."""
    if isinstance(obj, torch.Tensor):
        return _from_wire(_to_wire(obj.detach()), torch.device("cpu")) \
            if obj.device.type == "cuda" else obj.detach()
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_tree(v) for v in obj)
    return obj


def _broadcast_bytes(payload: Optional[bytes], timeout_ok: bool) -> bytes:
    """Rank 0's bytes on every rank, over the world group. The workers
    wait without the launch's bound (the next program may be a while)."""
    dev = comm().device if comm().backend == "nccl" else torch.device("cpu")
    n = torch.zeros(1, dtype=torch.int64, device=dev)
    if payload is not None:
        n[0] = len(payload)
    work = dist.broadcast(n, src=0, async_op=True)
    if timeout_ok:
        _wait(work)
    else:
        work.wait()
    buf = torch.empty(int(n[0]), dtype=torch.uint8, device=dev)
    if payload is not None:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    _wait(dist.broadcast(buf, src=0, async_op=True))
    return buf.cpu().numpy().tobytes()


def _gather_objects(obj) -> Optional[list]:
    """Every rank's ``obj`` (tensors moved to the host), on rank 0."""
    with _Timed():
        out = [None] * comm().world if comm().rank == 0 else None
        dist.gather_object(_host_tree(obj), out, dst=0)
        return out


def _scatter_objects(objs: Optional[list]):
    """Rank 0's ``objs[r]`` on rank r."""
    with _Timed():
        got = [None]
        dist.scatter_object_list(got, objs, src=0)
        return got[0]


# --------------------------------------------------------- programs
def _name_of(fn: Callable) -> str:
    name = f"{fn.__module__}:{fn.__qualname__}"
    if "<" in fn.__qualname__:
        raise ValueError(f"{name}: a rank program is a module-level "
                         f"function (the workers import it by name)")
    return name


def _resolve(name: str) -> Callable:
    module, qual = name.split(":")
    mod = sys.modules.get(module) or importlib.import_module(module)
    fn = mod
    for part in qual.split("."):
        fn = getattr(fn, part)
    return fn


def _call(header: tuple, scattered=None):
    """Runs one program's body on this rank."""
    name, view, args, kwargs, has_scatter = header
    if has_scatter:
        kwargs = dict(kwargs, scattered=scattered)
    return _resolve(name)(comm().mesh(dict(view)), *args, **kwargs)


def _worker_main(rank: int, world: int, axes: Dict[str, int],
                 device_type: str, store_path: str, parent: int) -> None:
    """Ranks 1 .. W - 1: join the mesh, then run rank 0's programs until
    told to stop."""
    import pickle

    global _comm
    _watch_parent(parent)
    if device_type == "cpu":
        torch.set_num_threads(1)
    try:
        _comm = _Comm(rank, world, axes, device_type, _IDLE_TIMEOUT,
                      store_path)
        _comm.timeout = datetime.timedelta(seconds=TIMEOUT_S)
        while True:
            header = pickle.loads(_broadcast_bytes(None, timeout_ok=False))
            if header == _STOP:
                break
            scattered = _scatter_objects(None) if header[4] else None
            _gather_objects(_call(header, scattered))
    except BaseException:  # noqa: BLE001 — reported to rank 0, then exit
        _report_failure(store_path, rank, traceback.format_exc())
        os._exit(1)
    try:
        dist.destroy_process_group()
    finally:
        os._exit(0)


def _report_failure(store_path: str, rank: int, text: str) -> None:
    with open(f"{store_path}.error.{rank}", "w") as fh:
        fh.write(text)


def _watch_parent(parent: int) -> None:
    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, name="rank-watchdog",
                     daemon=True).start()


class RankGroup:
    """Rank 0's handle on a launched mesh: :attr:`mesh` (rank 0's view of
    it), :meth:`run` and :meth:`close`."""

    def __init__(self, axes: Dict[str, int], device: str = "cuda"):
        global _comm, _active
        if _comm is not None or dist.is_initialized():
            raise RuntimeError("this process already belongs to a rank "
                               "mesh (or another process group)")
        self.axes = dict(axes)
        self.world = int(np.prod(list(self.axes.values())))
        self.device_type = torch.device(device).type
        cards = (torch.cuda.device_count() if self.device_type == "cuda"
                 else 0)
        self.layout, self.backend = layout_for(self.device_type,
                                               self.world, cards)
        self._dir = tempfile.mkdtemp(prefix="brpc_ranks_")
        self._store = os.path.join(self._dir, "store")
        self._lock = threading.Lock()
        self._closed = False
        self._procs = []
        ctx = torch.multiprocessing.get_context("spawn")
        try:
            for r in range(1, self.world):
                p = ctx.Process(
                    target=_worker_main, name=f"rank-{r}", daemon=True,
                    args=(r, self.world, self.axes, self.device_type,
                          self._store, os.getpid()))
                p.start()
                self._procs.append(p)
            self._comm = _comm = _Comm(
                0, self.world, self.axes, self.device_type,
                datetime.timedelta(seconds=TIMEOUT_S), self._store)
        except BaseException as e:
            self._kill()
            _comm = None
            if dist.is_initialized():
                dist.destroy_process_group()
            raise RuntimeError(f"rank mesh {self.axes} ({self.layout}, "
                               f"{self.backend}) failed to start: "
                               f"{self._errors() or e}") from e
        _active = self
        self.mesh = _comm.mesh()

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def describe(self) -> dict:
        return {"ranks": self.world, "axes": self.axes,
                "layout": self.layout, "backend": self.backend,
                "devices": [str(position_device(self.layout, r))
                            for r in range(self.world)]}

    def run(self, fn: Callable, *args, mesh=None, scatter=None,
            **kwargs) -> list:
        """Runs ``fn(mesh, *args, **kwargs)`` on every rank (``mesh``:
        each rank's view of this group's mesh, or of ``mesh``'s axes) and
        returns what each returned, by rank, on rank 0. With ``scatter``
        (one object per rank) rank r's body also gets ``scattered=
        scatter[r]``."""
        import pickle

        name = _name_of(fn)
        view = tuple((mesh.shape if mesh is not None else self.axes).items())
        header = (name, view, args, kwargs, scatter is not None)
        with self._lock:
            if self._closed:
                raise RuntimeError("the rank mesh is closed")
            try:
                _broadcast_bytes(pickle.dumps(header), timeout_ok=True)
                got = None
                if scatter is not None:
                    if len(scatter) != self.world:
                        raise ValueError(f"{len(scatter)} objects for "
                                         f"{self.world} ranks")
                    got = _scatter_objects(list(scatter))
                return _gather_objects(_call(header, got))
            except BaseException as e:
                errors = self._abort()
                raise RuntimeError(
                    f"rank mesh program {name} failed on rank 0 ({e!r})"
                    + (f"; worker errors:\n{errors}" if errors else "")) \
                    from e

    def _errors(self) -> str:
        out = []
        for r in range(1, self.world):
            path = f"{self._store}.error.{r}"
            if os.path.exists(path):
                with open(path) as fh:
                    out.append(f"rank {r}:\n{fh.read()}")
        return "\n".join(out)

    def _abort(self) -> str:
        # a failed program leaves the ranks out of step: stop them all
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not self._errors() and \
                all(p.is_alive() for p in self._procs):
            time.sleep(0.05)
        errors = self._errors()
        self._teardown(graceful=False)
        return errors

    def close(self) -> None:
        """Stops the workers and leaves the process group."""
        import pickle

        with self._lock:
            if self._closed:
                return
            try:
                _broadcast_bytes(pickle.dumps(_STOP), timeout_ok=True)
                graceful = True
            except RuntimeError:
                graceful = False
            self._teardown(graceful)

    def _teardown(self, graceful: bool) -> None:
        global _comm, _active
        self._closed = True
        if graceful:
            for p in self._procs:
                p.join(timeout=10)
        self._kill()
        try:
            dist.destroy_process_group()
        except (RuntimeError, ValueError):
            pass  # already gone with a failed rank
        _comm = None
        if _active is self:
            _active = None
        _state.clear()
        shutil.rmtree(self._dir, ignore_errors=True)

    def _kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)

    def view(self, axes: Dict[str, int]):
        """Another layout of this group's ranks (``{axis: size}``, the
        sizes multiplying to the rank count): every rank makes its
        groups, and rank 0's view of it is returned."""
        axes = dict(axes)
        self.run(_rank_view, axes)
        return self._comm.mesh(axes)

    # ---------------------------------------------- per-rank counters
    def launches(self) -> List[dict]:
        """Each rank's kernel launch counts (``pallas_ops.launches``)."""
        return self.run(_rank_launches)

    def reset_launches(self) -> None:
        self.run(_rank_launches, reset=True)

    def stats(self, reset: bool = False) -> List[dict]:
        """Each rank's :data:`stats` (time in collectives and staging)."""
        return self.run(_rank_stats, reset=reset)


def _rank_view(mesh, axes) -> None:
    if tuple(axes.items()) not in comm()._views:
        comm()._make_view(axes)


def _rank_launches(mesh, reset: bool = False) -> dict:
    from brpc_tpu_torch.tpu import pallas_ops

    if reset:
        pallas_ops.launches.reset()
        return {}
    return pallas_ops.launches.snapshot()


def _rank_stats(mesh, reset: bool = False) -> dict:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    out = stats.snapshot()
    if reset:
        stats.reset()
    return out


def launch(axes: Dict[str, int], device: str = "cuda") -> RankGroup:
    """Starts a mesh of ``prod(axes)`` ranks (the caller is rank 0) on
    ``device``: "cuda" (the default; a rank per card when there are
    enough cards, else every rank on card 0; raises without a card), or
    "cpu" when the caller asks for it. Close it with ``close()`` or a
    ``with`` block."""
    return RankGroup(axes, device=device)

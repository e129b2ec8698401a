"""Collectives over a mesh axis: combo-channel semantics, replayed.

The port of ``brpc_tpu/tpu/collective.py``, where the reference's fan-out
vocabulary becomes XLA collectives over the device interconnect:

  ParallelChannel  (same req -> N replicas, merge responses)
      -> fanout(): per shard over an axis + a sum or gather merge
  PartitionChannel (req -> partition p of N)
      -> partition(): per shard, no merge
  Streaming pipelining
      -> ring neighbour exchange (shift), see ring.py

Each function takes and returns the GLOBAL tensor, as JAX's do: dim 0 is
split into ``mesh.shape[axis]`` equal shards (the ``P(axis)`` layout;
other mesh axes hold replicas and compute the same), every position's
``shard_map`` body runs, and the per-position results are assembled as
the body's ``out_specs`` assemble them. On a replayed mesh
(``tpu/mesh.py``) this process replays every position. On a mesh with a
rank per position each rank runs its own position's body
(``Mesh.run``): the sums, gathers and exchanges are real collectives on
the axis's process group (``tpu/launch.py``), ``shift`` is a send to the
neighbour ``offset`` along, and the result is assembled on rank 0, on
rank 0's device. ``ring_all_reduce`` keeps the 2(n - 1) explicit
neighbour hops in both forms, so its additions run in the JAX ring's
order, not a ``sum``'s.

The reference's ``shard_map_norep`` is a shim over JAX's renamed
``shard_map`` keyword (``check_rep`` / ``check_vma``); the port has no
``shard_map`` and nothing to shim, so it has no counterpart.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from brpc_tpu_torch.tpu import launch
from brpc_tpu_torch.tpu.mesh import Mesh


def _shards(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """dim 0 of ``x`` in ``mesh.shape[axis]`` equal shards (views), one
    per axis position, in position order."""
    n = int(mesh.shape[axis])
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into "
                         f"{n} shards over axis {axis!r}")
    return list(x.chunk(n, dim=0))


def _psum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The axis sum of per-position values, in position order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


# ------------------------------------------------------------------ wrappers
def all_reduce(x, mesh: Mesh, axis: str):
    """Sum across the axis; every shard gets the total (ParallelChannel
    with a summing ResponseMerger)."""
    if mesh.ranked:
        return _on_ranks(mesh, _rank_all_reduce, x, axis)
    shards = _shards(x, mesh, axis)
    return torch.cat([_psum(shards)] * len(shards))


def all_gather(x, mesh: Mesh, axis: str):
    """Every shard receives the concatenation along the sharded dim."""
    if mesh.ranked:
        return _on_ranks(mesh, _rank_all_gather, x, axis)
    shards = _shards(x, mesh, axis)
    return torch.cat([x] * len(shards))


def reduce_scatter(x, mesh: Mesh, axis: str):
    """x: [n, m] sharded on dim 0 (each position contributes its shard's
    first row). Result: the row sum [m], position i owning slice i,
    returned as the assembled [m] global tensor."""
    if mesh.ranked:
        return _on_ranks(mesh, _rank_reduce_scatter, x, axis)
    rows = [s[0] for s in _shards(x, mesh, axis)]
    n = len(rows)
    if rows[0].shape[0] % n:
        raise ValueError(f"row of {rows[0].shape[0]} does not scatter "
                         f"over {n} positions")
    return torch.cat(_psum(rows).chunk(n))


def all_to_all(x, mesh: Mesh, axis: str, split_axis: int, concat_axis: int):
    """Transpose shard ownership (the Ulysses-style sequence <-> head
    swap): position j splits its shard along ``split_axis`` into n
    pieces and sends piece i to position i, which concatenates what it
    receives, in sender order, along ``concat_axis``."""
    if mesh.ranked:
        return _on_ranks(mesh, _rank_all_to_all, x, axis, split_axis,
                         concat_axis)
    shards = _shards(x, mesh, axis)
    n = len(shards)
    if shards[0].shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of shard "
                         f"{tuple(shards[0].shape)} does not split into "
                         f"{n} pieces")
    pieces = [s.chunk(n, dim=split_axis) for s in shards]
    return torch.cat([torch.cat([pieces[j][i] for j in range(n)],
                                dim=concat_axis) for i in range(n)])


def shift(x, mesh: Mesh, axis: str, offset: int = 1):
    """Rotate shards around the ring (the neighbour exchange): position
    ``(i + offset) % n`` receives shard i."""
    if mesh.ranked:
        return _on_ranks(mesh, _rank_shift, x, axis, offset)
    shards = _shards(x, mesh, axis)
    n = len(shards)
    return torch.cat([shards[(d - offset) % n] for d in range(n)])


# ---------------------------------------------------------- explicit rings
def ring_all_reduce(x, mesh: Mesh, axis: str):
    """Bandwidth-optimal ring allreduce as 2(n - 1) neighbour hops
    (reduce-scatter, then all-gather). x: [n, m], row i the local array
    of position i (m divisible by n); every row of the result is the row
    sum. Each hop is computed from every position's state before the hop,
    as the JAX ring's ``ppermute`` delivers it."""
    if mesh.ranked:
        return _on_ranks(mesh, _rank_ring_all_reduce, x, axis)
    shards = _shards(x, mesh, axis)
    n = len(shards)
    if n == 1:
        return shards[0][:1].clone()
    if shards[0].shape[1] % n:
        raise ValueError(f"row of {shards[0].shape[1]} does not split into "
                         f"{n} ring chunks")
    chunks = [list(s[0].chunk(n)) for s in shards]   # [position][chunk]

    # phase 1: reduce-scatter; after n - 1 hops position my holds the
    # full sum in chunk (my + 1) % n
    for i in range(n - 1):
        sent = [chunks[my][(my - i) % n] for my in range(n)]
        for my in range(n):
            r = (my - i - 1) % n
            chunks[my][r] = chunks[my][r] + sent[(my - 1) % n]
    # phase 2: all-gather the reduced chunks around the ring
    for i in range(n - 1):
        sent = [chunks[my][(my - i + 1) % n] for my in range(n)]
        for my in range(n):
            chunks[my][(my - i) % n] = sent[(my - 1) % n]
    return torch.stack([torch.cat(c) for c in chunks])


# ----------------------------------------------------- combo-channel shapes
def fanout(fn: Callable, mesh: Mesh, axis: str, merge: str = "gather"):
    """ParallelChannel: run fn on every shard, merge results.

    merge: 'gather' (concat sub-responses: the CallMapper default merger),
           'sum' (an aggregating ResponseMerger),
           'none' (leave sharded: the caller merges).
    """

    def wrapped(x):
        if mesh.ranked:
            return _on_ranks(mesh, _rank_fanout, x, axis, fn, merge)
        outs = [fn(s) for s in _shards(x, mesh, axis)]
        if merge == "sum":
            return torch.cat([_psum(outs)] * len(outs))
        if merge == "gather":
            return torch.cat([torch.cat(outs)] * len(outs))
        return torch.cat(outs)

    return wrapped


def partition(fn: Callable, mesh: Mesh, axis: str):
    """PartitionChannel: each partition handles its shard; results stay
    partitioned."""

    def wrapped(x):
        if mesh.ranked:
            return _on_ranks(mesh, _rank_fanout, x, axis, fn, "none")
        return torch.cat([fn(s) for s in _shards(x, mesh, axis)])

    return wrapped


# ------------------------------------------------ ParallelChannel lowering
# the registry the RPC layer's collective scheme drives: fn must be known
# BY NAME on both execution paths (the replayed program here, a device
# method RPC fallback there)
_collective_fns = {}


def register_collective_fn(name: str, fn: Callable) -> None:
    _collective_fns[name] = fn


def collective_fn(name: str) -> Callable:
    fn = _collective_fns.get(name)
    if fn is None:
        raise KeyError(f"no collective fn registered as {name!r}")
    return fn


def fanout_call(fn: Callable, mesh: Mesh, axis: str, merge: str, x):
    """ParallelChannel fan-out as ONE program: x shards over ``axis``
    (dim 0), fn runs per shard, the merger is the collective:

      gather -> concat of per-shard responses in sub-channel order
      sum    -> ONE summed response (an aggregating ResponseMerger)
      none   -> concat, as gather (results stay per partition)

    Over ranks each sub-channel's shard runs on its own rank (``fn`` goes
    to the workers by pickle: a module-level function) and the merge is
    the collective: a sum all-reduced over the axis, a gather gathered.
    """
    if mesh.ranked:
        return _on_ranks(mesh, _rank_fanout_call, x, axis, fn, merge,
                         one=merge == "sum")
    outs = [fn(s) for s in _shards(x, mesh, axis)]
    if merge == "sum":
        return _psum(outs)
    return torch.cat(outs)


# ------------------------------------------------ a rank per position
def _on_ranks(mesh: Mesh, body: Callable, x, axis: str, *args,
              one: bool = False):
    """Runs ``body`` on every rank over the host copy of the global ``x``
    and assembles the per-position results (dim 0 over ``axis``; with
    ``one``, rank 0's result alone) on rank 0's device."""
    if axis not in mesh.shape:
        raise ValueError(f"no axis {axis!r} in {mesh.shape}")
    _shards(x, mesh, axis)   # refuse an uneven split before launching
    blocks = mesh.run(body, x.detach().cpu(), axis, *args)
    out = blocks[0] if one else mesh.assemble(blocks, (axis,))
    return out.to(mesh.device)


def _local(mesh: Mesh, x, axis: str):
    """This rank's shard of the global host ``x``, on its device."""
    return mesh.block(x, (axis,)).to(mesh.device)


def _rank_all_reduce(mesh, x, axis):
    return launch.all_reduce(_local(mesh, x, axis), mesh.group(axis))


def _rank_all_gather(mesh, x, axis):
    return torch.cat(launch.all_gather(_local(mesh, x, axis),
                                       mesh.group(axis)))


def _rank_reduce_scatter(mesh, x, axis):
    n = mesh.shape[axis]
    row = _local(mesh, x, axis)[0]
    if row.shape[0] % n:
        raise ValueError(f"row of {row.shape[0]} does not scatter over "
                         f"{n} positions")
    # piece i of every position's row lands on position i, added in
    # position order
    return _psum(launch.all_to_all(list(row.chunk(n)), mesh.group(axis)))


def _rank_all_to_all(mesh, x, axis, split_axis, concat_axis):
    n = mesh.shape[axis]
    local = _local(mesh, x, axis)
    if local.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of shard {tuple(local.shape)} "
                         f"does not split into {n} pieces")
    pieces = [p.contiguous() for p in local.chunk(n, dim=split_axis)]
    return torch.cat(launch.all_to_all(pieces, mesh.group(axis)),
                     dim=concat_axis)


def _rank_shift(mesh, x, axis, offset):
    local = _local(mesh, x, axis)
    if offset % mesh.shape[axis] == 0:
        return local.clone()
    my = mesh.coord(axis)
    got = launch.exchange(
        [(local, mesh.peer(axis, my + offset))],
        [((local.shape, local.dtype), mesh.peer(axis, my - offset))],
        local.device).wait()
    return got[0]


def _rank_ring_all_reduce(mesh, x, axis):
    n = mesh.shape[axis]
    row = _local(mesh, x, axis)[0]
    if n == 1:
        return row[None].clone()
    if row.shape[0] % n:
        raise ValueError(f"row of {row.shape[0]} does not split into "
                         f"{n} ring chunks")
    my = mesh.coord(axis)
    nxt, prv = mesh.peer(axis, my + 1), mesh.peer(axis, my - 1)
    chunks = list(row.chunk(n))

    def hop(t):
        return launch.exchange([(t, nxt)], [((t.shape, t.dtype), prv)],
                               t.device).wait()[0]

    # phase 1: reduce-scatter; after n - 1 hops this position holds the
    # full sum in chunk (my + 1) % n
    for i in range(n - 1):
        got = hop(chunks[(my - i) % n])
        r = (my - i - 1) % n
        chunks[r] = chunks[r] + got
    # phase 2: all-gather the reduced chunks around the ring
    for i in range(n - 1):
        chunks[(my - i) % n] = hop(chunks[(my - i + 1) % n])
    return torch.cat(chunks)[None]


def _rank_fanout(mesh, x, axis, fn, merge):
    out = fn(_local(mesh, x, axis))
    if merge == "sum":
        return launch.all_reduce(out, mesh.group(axis))
    if merge == "gather":
        return torch.cat(launch.all_gather(out, mesh.group(axis)))
    return out


def _rank_fanout_call(mesh, x, axis, fn, merge):
    out = fn(_local(mesh, x, axis))
    if merge == "sum":
        return launch.all_reduce(out, mesh.group(axis))
    return out

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
``shard_map`` body is replayed in this process (the single-controller
mesh of ``tpu/mesh.py``), and the per-position results are assembled as
the body's ``out_specs`` assemble them. ``ring_all_reduce`` keeps the
2(n - 1) explicit neighbour hops, so its additions run in the JAX ring's
order, not a ``sum``'s.

The reference's ``shard_map_norep`` is a shim over JAX's renamed
``shard_map`` keyword (``check_rep`` / ``check_vma``); the port has no
``shard_map`` and nothing to shim, so it has no counterpart.
"""

from __future__ import annotations

from typing import Callable, List

import torch

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
    shards = _shards(x, mesh, axis)
    return torch.cat([_psum(shards)] * len(shards))


def all_gather(x, mesh: Mesh, axis: str):
    """Every shard receives the concatenation along the sharded dim."""
    shards = _shards(x, mesh, axis)
    return torch.cat([x] * len(shards))


def reduce_scatter(x, mesh: Mesh, axis: str):
    """x: [n, m] sharded on dim 0 (each position contributes its shard's
    first row). Result: the row sum [m], position i owning slice i,
    returned as the assembled [m] global tensor."""
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
    """
    outs = [fn(s) for s in _shards(x, mesh, axis)]
    if merge == "sum":
        return _psum(outs)
    return torch.cat(outs)

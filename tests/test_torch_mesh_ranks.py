"""The port's mesh with a rank per position (brpc_tpu_torch.tpu.launch,
and the ranked forms of tpu/{mesh,collective,ring,train}.py and of
graft_entry.dryrun_multichip) against the JAX package on the CPU.

The port side runs as 8 gloo ranks on the CPU (this process rank 0, 7
spawned workers), launched ONCE for the module: the ``ranked`` fixture
runs every case's port side (the collectives over each axis of dp2 x sp2
x tp2, ring attention at sp 2 and sp 4, five sharded training steps per
lane, a rank that raises), keeps the numpy results, and closes the
ranks; each test then compares its own case against the JAX function on
the conftest's 8 virtual CPU devices, so every case counts on its own.
``dryrun_multichip(8)`` launches its own 8 ranks first. Every launch has
a 120 s timeout and fails instead of hanging.

Tolerances: exact for the collectives over sums of small integers in
float32 (both sides add them exactly); rtol 1e-5, atol 1e-6 for
``ring_all_reduce`` of normal floats; 1e-4 (rtol and atol) for ring
attention's output and gradients at sp 2 and 4, both lanes, causal and
not; 1e-4 absolute for five sharded steps' losses and parameters against
JAX's ``make_train_step`` (as ``tests/test_torch_sharded_train.py``
holds the replayed step).
"""

import contextlib
import io
import re
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.tpu import collective as jax_coll
from brpc_tpu.tpu import mesh as jax_mesh
from brpc_tpu.tpu import ring as jax_ring
from brpc_tpu.tpu import train as jax_train
from brpc_tpu_torch import graft_entry
from brpc_tpu_torch.tpu import collective, launch, ring, train
from tests.test_torch_tracemalloc_guard import (  # noqa: F401
    no_leaked_tracemalloc, no_leaked_tracemalloc_in_module)

AXES = {"dp": 2, "sp": 2, "tp": 2}
OPS = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all", "shift",
       "ring_all_reduce", "fanout_sum", "fanout_gather", "partition",
       "fanout_call_sum", "fanout_call_gather"]
# ring cases: (name, mesh axes, [B, S, H, D], batch_axis, head_axis)
RINGS = [("sp2", AXES, (2, 32, 4, 16), "dp", "tp"),
         ("sp4", {"dp": 2, "sp": 4}, (2, 64, 2, 16), "dp", None)]
RING_TOL = dict(rtol=1e-4, atol=1e-4)
WIDTHS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=16)
B, S = 4, 16
LANES = {"flash": dict(use_flash_attention=True),
         "plain": dict(use_flash_attention=False),
         "norm": dict(use_flash_attention=True, use_pallas_norm=True)}


def _input(op, n, seed):
    rng = np.random.default_rng(seed)
    if op == "ring_all_reduce":
        return rng.normal(size=(n, 4 * n)).astype(np.float32)
    if op == "reduce_scatter":
        return rng.integers(0, 9, size=(n, 4 * n)).astype(np.float32)
    if op == "all_to_all":
        return rng.integers(0, 9, size=(2 * n, 2 * n)).astype(np.float32)
    return rng.integers(0, 9, size=(2 * n, 3)).astype(np.float32)


def _apply(coll, op, x, mesh, axis, fn):
    """One collective case on either package."""
    if op in ("all_reduce", "all_gather", "reduce_scatter",
              "ring_all_reduce"):
        return getattr(coll, op)(x, mesh, axis)
    if op == "all_to_all":
        return coll.all_to_all(x, mesh, axis, 1, 0)
    if op == "shift":
        return coll.shift(x, mesh, axis, offset=1)
    if op == "partition":
        return coll.partition(fn, mesh, axis)(x)
    if op.startswith("fanout_call_"):
        return coll.fanout_call(fn, mesh, axis, op.split("_")[-1], x)
    return coll.fanout(fn, mesh, axis, op.split("_")[-1])(x)


def _jax_fn(s):
    return s * 2.0 + 1.0


def _ring_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_train_setup():
    cfg = jax_train.ModelConfig(**WIDTHS)
    params = jax_train.init_params(jax.random.PRNGKey(0), cfg)
    batch = jax_train.demo_batch(jax.random.PRNGKey(1), cfg, B, S)
    return _np_tree(params), tuple(np.asarray(a) for a in batch)


@pytest.fixture(scope="module")
def ranked(jax_train_setup):
    """Every case's port side over one launch of 8 CPU ranks."""
    out = {"coll": {}, "ring": {}, "train": {}}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft_entry.dryrun_multichip(8)
    out["dryrun"] = buf.getvalue().splitlines()

    params, batch = jax_train_setup
    group = launch.launch(AXES, device="cpu")
    try:
        m = group.mesh
        out["describe"] = group.describe()
        out["coords"] = [m.coords(r) for r in range(8)]
        out["peers"] = {a: m.peer(a, 1) for a in AXES}
        cpu = torch.device("cpu")
        out["axis_timeouts"] = [
            m.group(a)._get_backend(cpu).options._timeout.total_seconds()
            for a in AXES] + [m.group("dp", "sp")._get_backend(cpu)
                              .options._timeout.total_seconds()]
        for axis in AXES:
            for i, op in enumerate(OPS):
                x = torch.from_numpy(_input(op, AXES[axis], i))
                got = _apply(collective, op, x, m, axis,
                             graft_entry._dryrun_affine)
                out["coll"][op, axis] = got.numpy()
        for name, axes, shape, bax, hax in RINGS:
            rm = m if axes == AXES else group.view(axes)
            q, k, v, g = _ring_inputs(shape, 3)
            for use_flash in (False, True):
                for causal in (False, True):
                    ins = [torch.from_numpy(a).requires_grad_()
                           for a in (q, k, v)]
                    o = ring.ring_attention(
                        *ins, rm, "sp", causal=causal, batch_axis=bax,
                        head_axis=hax, use_flash=use_flash, block_q=16,
                        block_k=16)
                    grads = torch.autograd.grad(o, ins, torch.from_numpy(g))
                    out["ring"][name, use_flash, causal] = (
                        o.detach().numpy(), [t.numpy() for t in grads])
        tbatch = tuple(torch.from_numpy(a.astype(np.int64)) for a in batch)
        for lane, kw in LANES.items():
            cfg = train.ModelConfig(**WIDTHS, **kw)
            model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
            model.load_params(train.params_from_jax(params, "cpu"))
            step, _, _ = train.make_train_step(cfg, m, lr=1e-2)
            losses = [float(step(model, tbatch)) for _ in range(5)]
            tree = step.gather()
            out["train"][lane] = (losses, [p.numpy() for p in
                                           train._leaves(tree)])
        # the model reloaded in place between two steps: the second step
        # starts from the reloaded parameters, not the ranks' shards
        cfg = train.ModelConfig(**WIDTHS, **LANES["plain"])
        model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        step, _, _ = train.make_train_step(cfg, m, lr=1e-2)
        reload = []
        for _ in range(2):
            model.load_params(train.params_from_jax(params, "cpu"))
            reload.append(float(step(model, tbatch)))
        out["reload"] = reload
        # last: a rank whose program raises (rank 3's shard is singular)
        x = torch.eye(2).repeat(8, 1, 1)
        x[3] = 0
        flat = launch.comm().mesh({"fan": 8})
        t0 = time.monotonic()
        try:
            collective.fanout_call(torch.linalg.inv, flat, "fan", "gather",
                                   x)
            out["raised"] = None
        except RuntimeError as e:
            out["raised"] = (str(e), time.monotonic() - t0)
        out["closed_after_failure"] = launch.active() is None
    finally:
        group.close()
    out["closed"] = launch.active() is None
    return out


# ------------------------------------------------------------------ mesh
def test_the_ranks_lay_the_mesh_row_major_on_gloo(ranked):
    d = ranked["describe"]
    assert (d["layout"], d["backend"], d["ranks"]) == ("cpu", "gloo", 8)
    assert ranked["coords"][5] == {"dp": 1, "sp": 0, "tp": 1}
    assert ranked["peers"] == {"dp": 4, "sp": 2, "tp": 1}
    assert ranked["closed"]


def test_every_axis_group_on_rank_0_waits_at_most_the_launch_timeout(
        ranked):
    assert ranked["axis_timeouts"] == [launch.TIMEOUT_S] * (len(AXES) + 1)


@pytest.mark.parametrize("world,cards,want", [
    (8, 0, None), (8, 8, "rank_per_card"), (4, 8, "rank_per_card"),
    (8, 1, "ranks_share_card"), (2, 1, "ranks_share_card")])
def test_the_backend_follows_from_the_layout(world, cards, want):
    assert launch.layout_for("cpu", world, cards) == ("cpu", "gloo")
    if want is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.layout_for("cuda", world, cards)
        return
    backend = {"rank_per_card": "nccl", "ranks_share_card": "gloo"}[want]
    assert launch.layout_for("cuda", world, cards) == (want, backend)


def test_launch_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.launch(AXES)
    assert launch.active() is None
    assert not torch.distributed.is_initialized()


def test_a_rank_that_raises_makes_rank_0_raise(ranked):
    msg, took = ranked["raised"]
    assert took < launch.TIMEOUT_S
    assert "rank 3" in msg and "linalg" in msg
    assert ranked["closed_after_failure"]


# ----------------------------------------------------------- collectives
@pytest.mark.parametrize("axis", sorted(AXES))
@pytest.mark.parametrize("op", OPS)
def test_collective_over_ranks_equals_jax(ranked, op, axis):
    jm = jax_mesh.make_mesh(AXES)
    x = _input(op, AXES[axis], OPS.index(op))
    want = np.asarray(_apply(jax_coll, op, jnp.asarray(x), jm, axis,
                             _jax_fn))
    got = ranked["coll"][op, axis]
    assert got.shape == want.shape
    if op == "ring_all_reduce":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ ring
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_flash", [False, True], ids=["lax", "flash"])
@pytest.mark.parametrize("case", RINGS, ids=[r[0] for r in RINGS])
def test_ring_over_ranks_equals_jax(ranked, case, use_flash, causal):
    name, axes, shape, bax, hax = case
    jm = jax_mesh.make_mesh(axes)
    q, k, v, g = (jnp.asarray(a) for a in _ring_inputs(shape, 3))

    def f(q, k, v):
        return jax_ring.ring_attention(q, k, v, jm, "sp", causal=causal,
                                       batch_axis=bax, head_axis=hax,
                                       use_flash=use_flash, block_q=16,
                                       block_k=16)

    want, vjp = jax.vjp(f, q, k, v)
    got, grads = ranked["ring"][name, use_flash, causal]
    np.testing.assert_allclose(got, np.asarray(want), **RING_TOL)
    for a, b in zip(grads, vjp(g)):
        np.testing.assert_allclose(a, np.asarray(b), **RING_TOL)


# --------------------------------------------------------- sharded step
@pytest.mark.parametrize("lane", sorted(LANES))
def test_five_sharded_steps_over_ranks_match_the_jax_step(
        ranked, jax_train_setup, lane):
    params, batch = jax_train_setup
    m = jax_mesh.make_mesh(AXES)
    cfg = jax_train.ModelConfig(**WIDTHS, **LANES[lane])
    step, pshard, bshard = jax_train.make_train_step(cfg, m, lr=1e-2)
    jparams = jax.device_put(params, pshard)
    jbatch = jax.device_put(batch, bshard)
    jlosses = []
    for _ in range(5):
        jparams, jloss = step(jparams, jbatch)
        jlosses.append(float(jloss))
    losses, leaves = ranked["train"][lane]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
    want = jax.tree_util.tree_leaves(_np_tree(jparams))
    assert len(want) == len(leaves)
    for w, g in zip(want, leaves):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_a_model_reloaded_between_ranked_steps_is_scattered_again(ranked):
    first, again = ranked["reload"]
    losses = ranked["train"]["plain"][0]
    assert first == again == losses[0]
    assert losses[1] < losses[0]


def test_wqkv_tp_slices_are_each_heads_q_k_v_columns():
    """Trap of the layout: a tp rank's wqkv slice is its heads' columns
    of each of q, k and v; the gather puts every column back."""
    cfg = train.ModelConfig(**WIDTHS)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    tree = train._map_tree(lambda a: a.detach(), model.params_tree())
    parts = [train.shard_tree(tree, cfg, 2, t) for t in range(2)]
    w = tree["layers"][0]["wqkv"].view(32, 3, 4, 8)
    got = parts[1]["layers"][0]["wqkv"].view(32, 3, 2, 8)
    assert torch.equal(got, w[:, :, 2:])
    back = train.unshard_trees(parts, cfg)
    for a, b in zip(train._leaves(back), train._leaves(tree)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- dryrun
def test_dryrun_multichip_over_ranks_collective_equals_rpc(ranked):
    lines = ranked["dryrun"]
    assert re.fullmatch(r"dryrun_multichip: mesh dp=2 sp=2 tp=2 "
                        r"loss=\d+\.\d{4} OK", lines[0]), lines
    assert lines[1] == ("dryrun fanout: collective == rpc OK "
                        "(merges=gather,sum over 8-dev mesh)")
    assert lines[-1] == "dryrun ranks: 8 ranks, layout cpu, backend gloo"

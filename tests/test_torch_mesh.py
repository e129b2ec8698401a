"""The port's device mesh, collectives and mesh-form ring attention
(brpc_tpu_torch.tpu.{mesh,collective,ring}) against the JAX package.

The JAX side runs on the conftest's 8 virtual CPU devices; the port lays
8 positions on the CPU with ``mesh.use_cpu(8)`` and replays every
position in this process. Every case of ``tests/test_tpu.py::TestMesh``
and ``::TestCollectives`` runs on both packages: the port is held to the
reference test's expectation and to the JAX function's output on the
same numpy input.

Tolerances: exact (``assert_array_equal``) for the collectives over sums
of small integers in float32, which both sides compute exactly; rtol
1e-5, atol 1e-6 for ``ring_all_reduce`` of normal floats (the reference
test's tolerance: the hops add in the JAX ring's order, but XLA may fuse
differently); rtol 2e-4, atol 2e-5 for ring attention against the JAX
ring on the same mesh shape (the reference's tolerance against full
attention), and rtol 5e-4, atol 5e-5 for the flash lane's gradients
(the reference's ring-gradient tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.shard.plane import shard_for as jax_shard_for
from brpc_tpu.tpu import collective as jax_coll
from brpc_tpu.tpu import mesh as jax_mesh
from brpc_tpu.tpu import ring as jax_ring
from brpc_tpu_torch.shard.plane import shard_for
from brpc_tpu_torch.tpu import collective, mesh, ring

RING_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module", autouse=True)
def cpu8():
    mesh.use_cpu(8)
    yield
    mesh.use_cpu(0)


def _both(fn_name, x, *args, **kw):
    """One collective on both packages over the "x" meshes: (port, JAX)
    as numpy."""
    pm, jm = mesh.make_mesh({"x": -1}), jax_mesh.make_mesh({"x": -1})
    got = getattr(collective, fn_name)(torch.from_numpy(x), pm, "x", *args,
                                       **kw)
    want = getattr(jax_coll, fn_name)(jnp.asarray(x), jm, "x", *args, **kw)
    return got.numpy(), np.asarray(want)


# ------------------------------------------------------------------ mesh
class TestMesh:
    def test_device_count(self):
        assert mesh.device_count() == 8 == jax_mesh.device_count()
        assert mesh.devices() == [torch.device("cpu")] * 8

    def test_make_mesh_infer(self):
        m = mesh.make_mesh({"dp": 2, "tp": -1})
        assert m.shape == {"dp": 2, "tp": 4}
        assert m.shape == dict(jax_mesh.make_mesh({"dp": 2, "tp": -1}).shape)
        assert m.axis_names == ("dp", "tp")
        assert m.devices.shape == (2, 4) and m.device == torch.device("cpu")

    def test_bad_mesh(self):
        with pytest.raises(ValueError, match="needs 3 devices"):
            mesh.make_mesh({"dp": 3})
        with pytest.raises(ValueError):
            jax_mesh.make_mesh({"dp": 3})

    def test_endpoints(self):
        eps = mesh.list_device_endpoints()
        jeps = jax_mesh.list_device_endpoints()
        assert len(eps) == 8 == len(jeps)
        assert all(e.is_tpu() for e in eps)
        assert [e.device_ordinal for e in eps] == \
            [e.device_ordinal for e in jeps]
        assert mesh.resolve_device(eps[3]) == torch.device("cpu")
        assert jax_mesh.resolve_device(jeps[3]).id == 3

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
    def test_mesh_factors_match_jax(self, n):
        assert mesh.mesh_factors(n) == jax_mesh.mesh_factors(n)

    def test_serving_mesh_is_dp2_sp2_tp2(self):
        m = mesh.serving_mesh()
        assert m.shape == {"dp": 2, "sp": 2, "tp": 2}
        assert m.shape == dict(jax_mesh.serving_mesh().shape)
        one = mesh.serving_mesh([torch.device("cpu")])
        assert one.shape == {"dp": 1, "sp": 1, "tp": 1}

    def test_default_mesh_and_named_sharding(self):
        m = mesh.default_mesh("sp")
        assert m.shape == {"sp": 8} and mesh.default_mesh("sp") is m
        s = mesh.named_sharding(m, "sp", None)
        assert s.mesh is m and s.spec == ("sp", None)

    def test_mesh_over_two_distinct_devices_is_refused(self):
        two = [torch.device("cpu"), torch.device("meta")] * 4
        with pytest.raises(ValueError, match="a rank per position"):
            mesh.make_mesh({"dp": 2, "tp": 4}, devices_list=two)

    def test_without_use_cpu_and_without_a_card_devices_raise(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: devices() lists it")
        mesh.use_cpu(0)
        try:
            with pytest.raises(RuntimeError, match="use_cpu"):
                mesh.devices()
        finally:
            mesh.use_cpu(8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_for_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ids = [int(x) for x in rng.integers(0, 2 ** 63, size=200)]
    ids += [v << 32 for v in range(1, 65)]
    for n in (1, 2, 3, 8):
        assert [shard_for(c, n) for c in ids] == \
            [jax_shard_for(c, n) for c in ids]


# ----------------------------------------------------------- collectives
class TestCollectives:
    def test_all_reduce_matches_sum(self):
        x = np.arange(16.0, dtype=np.float32)
        got, want = _both("all_reduce", x)
        np.testing.assert_array_equal(got.reshape(8, 2)[0],
                                      x.reshape(8, 2).sum(0))
        np.testing.assert_array_equal(got, want)

    def test_all_gather_identity(self):
        got, want = _both("all_gather", np.arange(8.0, dtype=np.float32))
        assert got.shape == (64,)
        np.testing.assert_array_equal(got[:8], np.arange(8.0))
        np.testing.assert_array_equal(got, want)

    def test_reduce_scatter(self):
        got, want = _both("reduce_scatter", np.ones((8, 16), np.float32))
        assert got.shape == (16,)
        np.testing.assert_array_equal(got, 8.0 * np.ones(16))
        np.testing.assert_array_equal(got, want)

    def test_reduce_scatter_of_distinct_rows(self):
        x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
        got, want = _both("reduce_scatter", x)
        np.testing.assert_array_equal(got, x.sum(0))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("offset", [1, 3, -1])
    def test_shift_rotates(self, offset):
        got, want = _both("shift", np.arange(8.0, dtype=np.float32),
                          offset=offset)
        np.testing.assert_array_equal(got, np.roll(np.arange(8.0), offset))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("seed", [0, 5])
    def test_ring_all_reduce_equals_sum(self, seed):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(8, 32)).astype(np.float32)
        got, want = _both("ring_all_reduce", x)
        for row in got:  # every position ends with the full sum
            np.testing.assert_allclose(row, x.sum(0), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_fanout_sum_merge(self):
        pm, jm = mesh.make_mesh({"x": -1}), jax_mesh.make_mesh({"x": -1})
        got = collective.fanout(lambda s: s * 2.0, pm, "x", merge="sum")(
            torch.ones(8))
        want = jax_coll.fanout(lambda s: s * 2.0, jm, "x", merge="sum")(
            jnp.ones((8,)))
        np.testing.assert_array_equal(got.numpy(), 16.0 * np.ones(8))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("merge", ["gather", "none"])
    def test_fanout_gather_and_none(self, merge):
        pm, jm = mesh.make_mesh({"x": -1}), jax_mesh.make_mesh({"x": -1})
        x = np.arange(16.0, dtype=np.float32)
        got = collective.fanout(lambda s: s + 1.0, pm, "x", merge=merge)(
            torch.from_numpy(x))
        want = jax_coll.fanout(lambda s: s + 1.0, jm, "x", merge=merge)(
            jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_partition_stays_sharded(self):
        pm, jm = mesh.make_mesh({"x": -1}), jax_mesh.make_mesh({"x": -1})
        got = collective.partition(lambda s: s + 1.0, pm, "x")(
            torch.zeros(8))
        want = jax_coll.partition(lambda s: s + 1.0, jm, "x")(
            jnp.zeros((8,)))
        np.testing.assert_array_equal(got.numpy(), np.ones(8))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("split_axis,concat_axis", [(1, 0), (1, 1)])
    def test_all_to_all(self, split_axis, concat_axis):
        x = np.arange(64.0, dtype=np.float32).reshape(8, 8)
        got, want = _both("all_to_all", x, split_axis=split_axis,
                          concat_axis=concat_axis)
        if (split_axis, concat_axis) == (1, 0):
            assert got.shape == (64, 1)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("merge", ["sum", "gather", "none"])
    def test_fanout_call_by_registered_name(self, merge):
        collective.register_collective_fn("t_scale", lambda s: s * 3.0)
        jax_coll.register_collective_fn("t_scale", lambda s: s * 3.0)
        pm, jm = mesh.make_mesh({"x": -1}), jax_mesh.make_mesh({"x": -1})
        x = np.arange(16.0, dtype=np.float32)
        got = collective.fanout_call(collective.collective_fn("t_scale"),
                                     pm, "x", merge, torch.from_numpy(x))
        want = jax_coll.fanout_call(jax_coll.collective_fn("t_scale"), jm,
                                    "x", merge, jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(KeyError):
            collective.collective_fn("t_never_registered")

    def test_collective_over_one_axis_of_a_3d_mesh(self):
        pm = mesh.make_mesh({"dp": 2, "sp": 2, "tp": 2})
        jm = jax_mesh.make_mesh({"dp": 2, "sp": 2, "tp": 2})
        x = np.arange(8.0, dtype=np.float32)
        got = collective.all_reduce(torch.from_numpy(x), pm, "tp")
        want = jax_coll.all_reduce(jnp.asarray(x), jm, "tp")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_uneven_split_is_refused(self):
        with pytest.raises(ValueError, match="does not split"):
            collective.all_reduce(torch.ones(12), mesh.make_mesh({"x": -1}),
                                  "x")


# --------------------------------------------------- ring attention, mesh
def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


class TestRingAttentionMesh:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_full_attention(self, causal):
        q, k, v = _qkv((2, 32, 4, 16), seed=1)
        pm, jm = mesh.make_mesh({"x": -1}), jax_mesh.make_mesh({"x": -1})
        got = ring.ring_attention(*map(torch.from_numpy, (q, k, v)), pm,
                                  "x", causal=causal)
        want = jax_ring.ring_attention(*map(jnp.asarray, (q, k, v)), jm, "x",
                                       causal=causal)
        full = jax_ring.full_attention_reference(
            *map(jnp.asarray, (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(full), **RING_TOL)

    @pytest.mark.parametrize("use_flash", [False, True],
                             ids=["lax", "flash"])
    def test_composes_with_dp_tp(self, use_flash):
        q, k, v = _qkv((2, 16, 4, 8), seed=2 if not use_flash else 4)
        pm = mesh.make_mesh({"dp": 2, "sp": 2, "tp": 2})
        jm = jax_mesh.make_mesh({"dp": 2, "sp": 2, "tp": 2})
        got = ring.ring_attention(*map(torch.from_numpy, (q, k, v)), pm,
                                  "sp", causal=True, batch_axis="dp",
                                  head_axis="tp", use_flash=use_flash)
        want = jax_ring.ring_attention(*map(jnp.asarray, (q, k, v)), jm,
                                       "sp", causal=True, batch_axis="dp",
                                       head_axis="tp", use_flash=use_flash)
        assert got.shape == (2, 16, 4, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING_TOL)
        full = ring.full_attention_reference(
            *map(torch.from_numpy, (q, k, v)), causal=True)
        np.testing.assert_allclose(got.numpy(), full.numpy(), **RING_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_flash_ring_gradients_match_jax(self, causal):
        q, k, v = _qkv((2, 32, 4, 16), seed=7)
        pm = mesh.make_mesh({"dp": 2, "sp": 2, "tp": 2})
        jm = jax_mesh.make_mesh({"dp": 2, "sp": 2, "tp": 2})

        def loss_j(q, k, v):
            return jnp.sum(jnp.sin(jax_ring.ring_attention(
                q, k, v, jm, "sp", causal=causal, batch_axis="dp",
                head_axis="tp", use_flash=True, block_q=16, block_k=16)))

        want = jax.grad(loss_j, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
        ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = ring.ring_attention(*ins, pm, "sp", causal=causal,
                                  batch_axis="dp", head_axis="tp",
                                  use_flash=True, block_q=16, block_k=16)
        got = torch.autograd.grad(torch.sin(out).sum(), ins)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)

    def test_mesh_form_equals_int_sp_form(self):
        """One (batch, head) slice is the int-sp ring: over a mesh whose
        dp and tp are 1 the two forms give the same bits."""
        q, k, v = map(torch.from_numpy, _qkv((1, 32, 2, 16), seed=9))
        pm = mesh.make_mesh({"dp": 1, "sp": 8, "tp": 1},
                            devices_list=mesh.devices())
        a = ring.ring_attention(q, k, v, pm, "sp", causal=True,
                                batch_axis="dp", head_axis="tp")
        b = ring.ring_attention(q, k, v, 8, causal=True)
        assert torch.equal(a, b)

    def test_refuses_a_batch_that_does_not_split(self):
        q, k, v = map(torch.from_numpy, _qkv((3, 16, 4, 8), seed=3))
        pm = mesh.make_mesh({"dp": 2, "sp": 2, "tp": 2})
        with pytest.raises(ValueError, match="do not split"):
            ring.ring_attention(q, k, v, pm, "sp", batch_axis="dp")
        with pytest.raises(ValueError, match="no mesh axes"):
            ring.ring_attention(q, k, v, 2, "sp")

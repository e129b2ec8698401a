"""The kernel tools of the port (``brpc_tpu_torch/tools/kernel_bench.py``,
``causal_sweep.py``, ``qgrid_sweep.py``) against the JAX package's
``tools/`` of the same names, on the CPU.

- Config lists, shapes and FLOP formulas equal the reference tools'. Most
  sit inside the reference functions, so they are read from the
  reference sources with ``ast`` and evaluated on the same names.
- ``ring_pass``, the ring path bench_ring_path times (the port's
  ``ring_attention`` flash lane and its backward), at (B 1, H 2, S 256,
  D 32), sp 4, blocks 64, fp32, on the CPU (the plain versions), equals
  the reference's composition of the JAX ``flash_attention_carry``,
  ``_flash_bwd_bhsd`` and ``_flash_delta`` in interpret mode within 1e-4.
- bench_train_step_mfu's step loop (``train_steps``) on a 2-layer,
  d_model 64 config, the JAX parameters carried across by
  ``params_from_jax``, leaves parameters within the train tests' 1e-5 of
  the reference's loop after 2 steps.
- The sweeps' wrappers refuse the configs the TPU wrappers refuse.
- Each tool's ``main()`` without a card returns 1 and runs nothing; each
  bench function and sweep runs its control flow on the CPU at a small
  size, with CUDA-event timing stood in by one call.

The shapes run on the card only in ``chip_smoke.py``'s phase 21.
"""

import ast
import io
import os
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.tpu import pallas_ops as jax_ops
from brpc_tpu.tpu import train as jax_train
from brpc_tpu_torch.tools import causal_sweep, kernel_bench, qgrid_sweep
from brpc_tpu_torch.tpu import pallas_ops, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG_INF = -1e30


def _ref_tree(name):
    with open(os.path.join(REPO, "tools", f"{name}.py"),
              encoding="utf-8") as fh:
        return ast.parse(fh.read())


def _func(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigned(func, name):
    """The value node of ``name = ...`` (or of ``name`` in a tuple
    target) inside ``func``."""
    for n in ast.walk(func):
        if not isinstance(n, ast.Assign):
            continue
        for t in n.targets:
            if isinstance(t, ast.Name) and t.id == name:
                return n.value
            if isinstance(t, ast.Tuple) and isinstance(n.value, ast.Tuple):
                for el, val in zip(t.elts, n.value.elts):
                    if isinstance(el, ast.Name) and el.id == name:
                        return val
    raise KeyError(name)


def _value(func, name, **ns):
    node = _assigned(func, name)
    return eval(compile(ast.Expression(node), "<ref>", "eval"), {}, ns)


def _keywords(call):
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg not in (None, "dtype")}


@pytest.mark.parametrize("port,ref", [(causal_sweep, "causal_sweep"),
                                      (qgrid_sweep, "qgrid_sweep")])
def test_sweep_configs_and_shape_equal_the_references(port, ref):
    main = _func(_ref_tree(ref), "main")
    assert port.CONFIGS == ast.literal_eval(_assigned(main, "cfgs"))
    assert tuple(ast.literal_eval(_assigned(main, n))
                 for n in "BHSD") == causal_sweep.SHAPE
    B, H, S, D = causal_sweep.SHAPE
    for causal, name in ((True, "causal_flops"), (False, "full_flops")):
        assert causal_sweep.flops(causal) == _value(main, name, B=B, H=H,
                                                    S=S, D=D)


def test_kernel_bench_shapes_equal_the_references():
    tree = _ref_tree("kernel_bench")
    fa = _func(tree, "bench_flash_attention")
    assert tuple(ast.literal_eval(_assigned(fa, n))
                 for n in "BHSD") == kernel_bench.ATTN_SHAPE
    ring = _func(tree, "bench_ring_path")
    assert tuple(ast.literal_eval(_assigned(ring, n))
                 for n in ("B", "H", "S", "D")) == kernel_bench.ATTN_SHAPE
    assert ast.literal_eval(_assigned(ring, "SP")) == kernel_bench.RING_SP
    blocks = {ast.literal_eval(k.value) for n in ast.walk(ring)
              if isinstance(n, ast.Call) for k in n.keywords
              if k.arg in ("block_q", "block_k")}
    assert blocks == {kernel_bench.RING_BLOCK}
    rms = _func(tree, "bench_rmsnorm")
    assert tuple(ast.literal_eval(_assigned(rms, n))
                 for n in "ND") == kernel_bench.RMS_SHAPE
    mfu = _func(tree, "bench_train_step_mfu")
    assert tuple(ast.literal_eval(_assigned(mfu, n)) for n in "BS") == (
        kernel_bench.TRAIN_B, kernel_bench.TRAIN_S)
    base = _keywords(_assigned(mfu, "base"))
    assert base == {k: v for k, v in kernel_bench.FLAGSHIP.items()
                    if k != "dtype"}
    assert kernel_bench.FLAGSHIP["dtype"] is torch.bfloat16
    on, off = (_keywords(_assigned(mfu, n)) for n in ("cfg_on", "cfg_off"))
    assert on == kernel_bench.KERNELS_ON and off == kernel_bench.KERNELS_OFF
    big = _keywords(_assigned(mfu, "cfg_big"))
    assert big == {**{k: v for k, v in kernel_bench.AT_SCALE.items()
                      if k != "dtype"}, **kernel_bench.KERNELS_ON}
    call = next(n for n in ast.walk(mfu) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "measure"
                and n.args and getattr(n.args[0], "id", "") == "cfg_big")
    assert _keywords(call)["batch"] == kernel_bench.AT_SCALE_B


@pytest.mark.parametrize("causal", [True, False])
def test_attention_flop_formulas_equal_the_references(causal):
    tree = _ref_tree("kernel_bench")
    fa = _func(tree, "bench_flash_attention")
    B, H, S, D = kernel_bench.ATTN_SHAPE
    ns = dict(B=B, H=H, S=S, D=D)
    fwd = _value(fa, "causal_fwd_flops" if causal else "full_fwd_flops",
                 **ns)
    assert kernel_bench.attention_flops(kernel_bench.ATTN_SHAPE,
                                        causal) == fwd
    # the fwd + bwd rows: 3.5 x the forward (kernel_bench.py:112)
    bwd = [n for n in ast.walk(fa) if isinstance(n, ast.Assign)
           and getattr(n.targets[0], "id", "") == "flops"]
    ns.update(causal=causal, causal_fwd_flops=_value(
        fa, "causal_fwd_flops", **ns), full_fwd_flops=_value(
        fa, "full_fwd_flops", **ns))
    want = eval(compile(ast.Expression(bwd[-1].value), "<ref>", "eval"),
                {}, ns)
    assert kernel_bench.fwd_bwd_flops(kernel_bench.ATTN_SHAPE,
                                      causal) == want
    if causal:
        ring = _func(tree, "bench_ring_path")
        assert kernel_bench.fwd_bwd_flops(kernel_bench.ATTN_SHAPE,
                                          True) == _value(ring, "flops",
                                                          **ns)


@pytest.mark.parametrize("widths,batch", [
    (kernel_bench.FLAGSHIP, kernel_bench.TRAIN_B),
    (kernel_bench.AT_SCALE, kernel_bench.AT_SCALE_B)])
def test_step_flops_equal_the_references(widths, batch):
    measure = _func(_func(_ref_tree("kernel_bench"),
                          "bench_train_step_mfu"), "measure")
    cfg = train.ModelConfig(**widths)
    S = kernel_bench.TRAIN_S
    ns = dict(cfg=cfg, S=S, batch=batch)
    ns["matmul_params"] = _value(measure, "matmul_params", **ns)
    ns["attn_flops"] = _value(measure, "attn_flops", **ns)
    assert kernel_bench.step_flops(cfg, batch, S) == _value(
        measure, "flops", **ns)


def test_no_tpu_number_or_v5e_in_the_kernel_tools():
    for mod in (kernel_bench, causal_sweep, qgrid_sweep):
        with open(mod.__file__, encoding="utf-8") as fh:
            text = fh.read()
        assert "v5e" not in text and "197e12" not in text, mod.__name__
    assert kernel_bench.H100_PEAK_FLOPS == 989e12
    assert kernel_bench.H100_HBM_BYTES_PER_S == 3.35e12


# ------------------------------------------------------------ ring replay
RING = dict(B=1, H=2, S=256, D=32, SP=4, BLOCK=64)


def _jax_ring_fwd_bwd(q, k, v, sp, block):
    """tools/kernel_bench.py:193-264's composition, returning its pieces:
    the carry kernel per live hop (vmapped over B and H), the backward
    kernels per hop at absolute offsets, in interpret mode."""
    B, H, S, D = q.shape
    SQ = S // sp
    os_, lses = [], []
    dq_total = jnp.zeros((B, H, S, D), jnp.float32)
    dk_total = jnp.zeros((B, H, S, D), jnp.float32)
    dv_total = jnp.zeros((B, H, S, D), jnp.float32)
    for d in range(sp):
        qd = q[:, :, d * SQ:(d + 1) * SQ]
        m = jnp.full((B, H, SQ, 1), NEG_INF, jnp.float32)
        l = jnp.zeros((B, H, SQ, 1), jnp.float32)
        acc = jnp.zeros((B, H, SQ, D), jnp.float32)
        for hop in range(sp):
            src = (d - hop) % sp
            if src > d:
                continue
            kb = k[:, :, src * SQ:(src + 1) * SQ]
            vb = v[:, :, src * SQ:(src + 1) * SQ]

            def one(a, b, c, x, y, z, src=src, d=d):
                return jax_ops.flash_attention_carry(
                    a, b, c, x, y, z, d * SQ, src * SQ, causal=True,
                    block_q=block, block_k=block, interpret=True)

            m, l, acc = jax.vmap(jax.vmap(one))(qd, kb, vb, m, l, acc)
        safe = jnp.where(l == 0, 1.0, l)
        o = (acc / safe).astype(q.dtype)
        lse = jnp.where(l == 0, NEG_INF, m + jnp.log(safe))
        os_.append(o)
        lses.append(lse)
        do = (o * jnp.bfloat16(1e-3)).astype(q.dtype)
        qb = qd.reshape(B * H, SQ, D)
        dob = do.reshape(B * H, SQ, D)
        lseb = lse.reshape(B * H, SQ, 1)
        deltab = jax_ops._flash_delta(o.reshape(B * H, SQ, D), dob)
        dq_acc = jnp.zeros((B * H, SQ, D), jnp.float32)
        for hop in range(sp):
            src = (d - hop) % sp
            if src > d:
                continue
            kb = k[:, :, src * SQ:(src + 1) * SQ].reshape(B * H, SQ, D)
            vb = v[:, :, src * SQ:(src + 1) * SQ].reshape(B * H, SQ, D)
            dq_b, dk_b, dv_b = jax_ops._flash_bwd_bhsd(
                qb, kb, vb, lseb, dob, deltab, d * SQ, src * SQ, True,
                block, block, True)
            dq_acc = dq_acc + dq_b.astype(jnp.float32)
            dk_total = dk_total.at[:, :, src * SQ:(src + 1) * SQ].add(
                dk_b.reshape(B, H, SQ, D).astype(jnp.float32))
            dv_total = dv_total.at[:, :, src * SQ:(src + 1) * SQ].add(
                dv_b.reshape(B, H, SQ, D).astype(jnp.float32))
        dq_total = dq_total.at[:, :, d * SQ:(d + 1) * SQ].set(
            dq_acc.reshape(B, H, SQ, D))
    return (jnp.concatenate(os_, axis=2), jnp.concatenate(lses, axis=2),
            dq_total, dk_total, dv_total)


def _ring_leaves(arrays):
    """[B, H, S, D] arrays as [B, S, H, D] leaves that require grad."""
    return [torch.from_numpy(a).transpose(1, 2).contiguous()
            .requires_grad_() for a in arrays]


def test_ring_replay_equals_the_jax_composition():
    r = RING
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((r["B"], r["H"], r["S"], r["D"]))
               .astype(np.float32) for _ in range(3))
    o_w, _, *grads_w = _jax_ring_fwd_bwd(
        *(jnp.asarray(a) for a in (q, k, v)), r["SP"], r["BLOCK"])
    pallas_ops.launches.reset()
    got = kernel_bench.ring_pass(*_ring_leaves((q, k, v)), r["SP"],
                                 r["BLOCK"])
    assert sum(pallas_ops.launches.snapshot().values()) == 0
    names = ("o", "dq", "dk", "dv")
    for name, g, w in zip(names, got, (o_w, *grads_w)):
        g = g.detach().transpose(1, 2)  # back to [B, H, S, D]
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=name)
    assert np.abs(got[1].numpy()).max() > 0  # a real gradient


def test_ring_replay_skips_the_future_hops(monkeypatch):
    """sp (sp + 1) / 2 live hops a call: one carry and one backward each,
    at the absolute offsets of the reference's loop, in the ring's hop
    order."""
    calls = {"carry": [], "bwd": []}
    carry, bwd = pallas_ops.flash_attention_carry, pallas_ops._flash_bwd_bhsd

    def spy_carry(q, k, v, m, l, acc, q_start, k_start, **kw):
        calls["carry"].append((q_start, k_start, kw["block_q"],
                               kw["block_k"], kw["causal"]))
        return carry(q, k, v, m, l, acc, q_start, k_start, **kw)

    def spy_bwd(*a):
        calls["bwd"].append(a[6:])
        return bwd(*a)

    monkeypatch.setattr(pallas_ops, "flash_attention_carry", spy_carry)
    monkeypatch.setattr(pallas_ops, "_flash_bwd_bhsd", spy_bwd)
    rng = np.random.default_rng(5)
    kernel_bench.ring_pass(*_ring_leaves(
        rng.standard_normal((1, 1, 64, 32)).astype(np.float32)
        for _ in range(3)), 4, 16)
    live = [(d * 16, ((d - h) % 4) * 16) for h in range(4)
            for d in range(4) if (d - h) % 4 <= d]
    assert len(live) == 4 * 5 // 2
    assert [c[:2] for c in calls["carry"]] == live
    assert all(c[2:] == (16, 16, True) for c in calls["carry"])
    assert calls["bwd"] == [(qs, ks, True, 16, 16) for qs, ks in live]


# ------------------------------------------------------------ train loop
WIDTHS = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128,
              max_seq=128)


def test_train_step_loop_tracks_the_reference_loop():
    """Two steps of the benchmark's loop (``p - 1e-4 g``, the kernels-on
    config) against the reference's fori_loop body on the same
    parameters and batch."""
    cfg_j = jax_train.ModelConfig(**WIDTHS, use_flash_attention=True,
                                  use_pallas_norm=True, use_fused_xent=True)
    params = jax_train.init_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(4)
    tokens, targets = (rng.integers(0, WIDTHS["vocab"], (2, 128))
                       for _ in range(2))
    p = params
    for _ in range(2):
        loss_j, grads = jax.value_and_grad(jax_train.loss_fn)(
            p, (jnp.asarray(tokens, jnp.int32),
                jnp.asarray(targets, jnp.int32)), cfg_j)
        p = jax.tree_util.tree_map(
            lambda a, g: (a - 1e-4 * g).astype(a.dtype), p, grads)
    cfg = train.ModelConfig(**WIDTHS, **kernel_bench.KERNELS_ON)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    model.load_params(train.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu"))
    loss = kernel_bench.train_steps(
        model, tuple(torch.from_numpy(a) for a in (tokens, targets)), 2)
    assert kernel_bench.LR == 1e-4
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for a, t in zip(jax.tree_util.tree_leaves(p),
                    train._leaves(model.params_tree())):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(a),
                                   atol=1e-5, rtol=0)


# ------------------------------------------------------ wrapper refusals
@pytest.mark.parametrize("n,bn", [(4, 1), (4, 2), (4, 4), (4, 3), (6, 4)])
def test_bhsd_refuses_bn_as_the_tpu_wrapper(n, bn):
    rng = np.random.default_rng(n * 10 + bn)
    q = rng.standard_normal((n, 64, 32)).astype(np.float32)

    def port():
        t = torch.from_numpy(q)
        return pallas_ops._flash_fwd_bhsd(t, t, t, True, 32, 32, bn)

    def ref():
        a = jnp.asarray(q)
        return jax_ops._flash_fwd_bhsd(a, a, a, True, 32, 32, True, bn)

    if n % bn:
        for f in (port, ref):
            with pytest.raises(ValueError, match=r"bn \(\d+\) must divide"):
                f()
    else:
        np.testing.assert_allclose(port()[0].numpy(), np.asarray(ref()[0]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,sq,bq,bkc,bn", [
    (4, 64, 32, 32, 2), (4, 64, 48, 32, 1), (4, 64, 32, 48, 1),
    (4, 64, 32, 32, 3)])
def test_qgrid_refuses_as_the_tpu_wrapper(n, sq, bq, bkc, bn):
    q = torch.zeros((n, sq, 32))
    refused = bool(n % bn or sq % bq or sq % bkc)
    a = jnp.zeros((n, sq, 32))
    for f in (lambda: pallas_ops._flash_fwd_qgrid(q, q, q, True, bq, bkc,
                                                  bn),
              lambda: jax_ops._flash_fwd_qgrid(a, a, a, True, bq, bkc, True,
                                               bn)):
        if refused:
            with pytest.raises(ValueError, match="vs blocks"):
                f()
        else:
            f()


# ------------------------------------------------ main without a card
@pytest.mark.parametrize("mod,benches", [
    (kernel_bench, ("bench_flash_attention", "bench_ring_path",
                    "bench_rmsnorm", "bench_train_step_mfu")),
    (causal_sweep, ("sweep",)), (qgrid_sweep, ("sweep",))])
def test_main_without_a_card_returns_1_and_runs_nothing(mod, benches,
                                                        monkeypatch,
                                                        capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **kw):
        raise AssertionError("ran a bench without a card")

    for name in benches:
        monkeypatch.setattr(mod, name, never)
    pallas_ops.launches.reset()
    assert mod.main() == 1
    assert "skipped: no CUDA device" in capsys.readouterr().out
    assert sum(pallas_ops.launches.snapshot().values()) == 0


# ------------------------------------- control flow at a small size
@pytest.fixture
def on_cpu(monkeypatch):
    """The tools' card hooks stood in on the CPU: the device, the card
    line, and CUDA-event timing by one call (1 ms)."""
    cpu = torch.device("cpu")
    calls = []

    def one_call(fn, iters, warmup=kernel_bench.WARMUP):
        calls.append((iters, warmup))
        fn()
        return 1.0

    for mod in (kernel_bench, causal_sweep):
        monkeypatch.setattr(mod, "resolve_device", lambda dev=None: cpu)
        monkeypatch.setattr(mod, "card_line", lambda dev: "CPU stand-in")
        monkeypatch.setattr(mod, "event_ms", one_call)
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    return calls


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue().splitlines()


def test_bench_functions_run_their_rows_on_cpu(on_cpu, monkeypatch):
    monkeypatch.setattr(kernel_bench, "ATTN_SHAPE", (1, 2, 128, 32))
    monkeypatch.setattr(kernel_bench, "RING_BLOCK", 32)
    monkeypatch.setattr(kernel_bench, "RMS_SHAPE", (64, 128))
    monkeypatch.setattr(kernel_bench, "TRAIN_S", 64)
    small = dict(vocab=64, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                 max_seq=64, dtype=torch.float32)
    monkeypatch.setattr(kernel_bench, "FLAGSHIP", small)
    monkeypatch.setattr(kernel_bench, "AT_SCALE", dict(small, n_layers=3))
    monkeypatch.setattr(kernel_bench, "TRAIN_B", 2)
    monkeypatch.setattr(kernel_bench, "AT_SCALE_B", 1)
    lines = []
    for fn in (kernel_bench.bench_flash_attention,
               kernel_bench.bench_ring_path, kernel_bench.bench_rmsnorm):
        lines += _printed(fn)[1]
    res, out = _printed(kernel_bench.bench_train_step_mfu, steps=2,
                        big_steps=1, reps=2)
    lines += out
    heads = [l.split(":")[0] for l in lines]
    assert heads == [
        "# kernel flash_attention fwd CAUSAL (flagship shape) B=1 H=2 "
        "S=128 D=32",
        "# kernel flash_attention fwd+bwd CAUSAL (flagship shape) "
        "(autograd backward kernels dQ, dK/dV)",
        "# kernel flash_attention fwd non-causal B=1 H=2 S=128 D=32",
        "# kernel flash_attention fwd+bwd non-causal (autograd backward "
        "kernels dQ, dK/dV)",
        "# control",
        "# ring-attention path fwd+bwd CAUSAL sp=4 (carry-kernel hops + "
        "per-hop backward kernels) B=1 H=2 S=128 D=32",
        "# kernel rmsnorm 64x128",
        "# train step d_model=64 L=2 B=2 S=64 KERNELS-ON (flash+norm+xent)",
        "# train step d_model=64 L=2 B=2 S=64 plain-PyTorch baseline",
        "# train step d_model=64 L=3 B=1 S=64 KERNELS-ON (at-scale)"]
    assert all("TFLOP/s" in l or "GB/s" in l for l in lines)
    assert all(np.isfinite(r["loss"]) for r in res.values())
    # timed runs: 2 + 2 attention rows a flag, the control, the ring, the
    # three chained rows, then reps measures of each train config
    assert [c[0] for c in on_cpu] == [100, 50, 100, 50, 100, 20, 50, 50,
                                      50, 2, 2, 2, 2, 1, 1]


@pytest.mark.parametrize("mod", [causal_sweep, qgrid_sweep])
def test_sweeps_print_the_reference_rows_on_cpu(mod, on_cpu, monkeypatch):
    monkeypatch.setattr(causal_sweep, "SHAPE", (1, 2, 128, 32))
    cfgs = [(True, 64, 64, 1), (True, 32, 64, 2), (False, 64, 128, 2),
            (True, 64, 64, 3)]  # bn 3 does not divide N = 2
    monkeypatch.setattr(mod, "CONFIGS", cfgs)
    res, lines = _printed(mod.sweep, passes=2, iters=5)
    assert lines[0] == "# CPU stand-in"
    assert lines[1].startswith("# _flash_fwd_") and "bit-equal" in lines[1]
    assert lines[2].startswith("cfg=(True, 64, 64, 3): FAIL ValueError: ")
    assert lines[3:5] == ["# pass 0 done", "# pass 1 done"]
    prefix = "qgrid causal" if mod is qgrid_sweep else "causal"
    assert [l.split(":")[0].split(" bq")[0] for l in lines[5:]] == [
        f"{prefix}=1", f"{prefix}=1", f"{prefix}=0"]
    assert all("TF/s" in l and "best" in l for l in lines[5:])
    assert list(res["first"]) == cfgs[:3] and on_cpu == [(5, 3)] * 6
    o0 = res["first"][cfgs[0]][0]
    assert torch.equal(res["first"][cfgs[1]][0], o0)

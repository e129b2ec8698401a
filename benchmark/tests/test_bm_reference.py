"""The plain reference against TrainLM's step on the CPU at a tiny size,
and the departures from GPT-NeoX that the configuration files list,
held to the code: each departure undone moves the loss away from
TrainLM's."""

import json
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark import reference
from benchmark.drivers import train as drv

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = {"vocab": 96, "d_model": 32, "n_heads": 2, "n_layers": 2,
        "d_ff": 128, "max_seq": 16, "dtype": torch.float32,
        "use_flash_attention": True, "use_pallas_norm": True,
        "use_fused_xent": True}
TRAFFIC = {"batch": 3, "seq": 16, "lr": 0.5}
SEED = 7


def _program_step():
    from brpc_tpu_torch.tpu import train

    model, weights = drv.build(FP32, SEED, "cpu")
    batch = drv.Batches(FP32, TRAFFIC, SEED, "cpu")()
    loss, grads = train.value_and_grad(model, batch)
    train.sgd_train_step(model, batch, TRAFFIC["lr"])
    flat = {"embed": grads["embed"], "head": grads["head"],
            "ln_f": grads["ln_f"]}
    for i, layer in enumerate(grads["layers"]):
        flat.update({f"layers.{i}.{k}": g for k, g in layer.items()})
    return model, weights, batch, float(loss), flat


def test_reference_equals_trainlm_step():
    model, weights, batch, loss, grads = _program_step()
    step = reference.Step(FP32, weights, TRAFFIC["lr"])
    ref_loss, ref_grads = step.grads(*batch)
    assert ref_loss == pytest.approx(loss, rel=1e-5)
    assert sorted(ref_grads) == sorted(grads)
    for k, g in grads.items():
        torch.testing.assert_close(ref_grads[k], g, rtol=1e-4, atol=1e-6)
    step.update(ref_grads)
    for k, p in drv._params(model).items():
        torch.testing.assert_close(step.w[k], p.detach(), rtol=1e-5,
                                   atol=1e-6)


def test_leaves_are_trainlms_parameters():
    model, *_ = _program_step()
    shapes = reference.leaf_shapes(FP32)
    got = {k: tuple(p.shape) for k, p in drv._params(model).items()}
    assert got == shapes
    assert list(shapes) == reference.leaf_names(FP32["n_layers"])
    assert sum(p.numel() for p in model.parameters()) == sum(
        torch.Size(s).numel() for s in shapes.values())   # no biases


def test_update_takes_the_parameters_dtype():
    w = {"embed": torch.tensor([1.0, 0.015625, -3.0],
                               dtype=torch.bfloat16)}
    g = {"embed": torch.tensor([0.0031, 0.5, 1e-4])}
    step = reference.Step({}, w, 0.7)
    step.update(g)
    want = w["embed"] - 0.7 * g["embed"].to(torch.bfloat16)
    assert torch.equal(step.w["embed"], want.float())


def _gpt_neox_variant(monkeypatch, which):
    """The reference with one of GPT-NeoX's choices put back."""
    if which == "layernorm":
        monkeypatch.setattr(reference, "_rmsnorm", lambda x, w: F.layer_norm(
            x, x.shape[-1:], weight=w, eps=1e-5))
    elif which == "erf_gelu":
        monkeypatch.setattr(reference, "_gelu", F.gelu)
    elif which == "parallel_residual":
        def layer(self, x, i):
            p = {k: self.w[f"layers.{i}.{k}"] for k in reference.LAYER_KEYS}
            b, s, d = x.shape
            h = self.m["n_heads"]
            qkv = (reference._rmsnorm(x, p["ln1"]) @ p["wqkv"]).reshape(
                b, s, 3, h, d // h)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            att = self._attention(q, k, v).transpose(1, 2).reshape(b, s, d)
            mlp = reference._gelu(reference._rmsnorm(x, p["ln2"])
                                  @ p["w1"]) @ p["w2"]
            return x + att @ p["wo"] + mlp
        monkeypatch.setattr(reference.Step, "_layer", layer)
    elif which == "rotary":
        rope = _rope(FP32["d_model"] // FP32["n_heads"], TRAFFIC["seq"])
        attention = reference.Step._attention

        def rotated(self, q, k, v):
            return attention(self, rope(q), rope(k), v)
        monkeypatch.setattr(reference.Step, "_attention", rotated)


def _rope(head_dim, seq, pct=0.25, base=10000.0):
    """GPT-NeoX's rotary embedding on the first ``pct`` of each head's
    dims, for [B, H, S, Dh]."""
    rot = int(head_dim * pct)
    inv = 1.0 / base ** (torch.arange(0, rot, 2).float() / rot)
    ang = torch.arange(seq).float()[:, None] * inv[None, :]
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)

    def apply(x):
        xr, xp = x[..., :rot], x[..., rot:]
        x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
        turned = torch.cat([-x2, x1], -1)
        return torch.cat([xr * cos + turned * sin, xp], -1)
    return apply


@pytest.mark.parametrize("which", ["layernorm", "parallel_residual",
                                   "rotary", "erf_gelu"])
def test_each_listed_departure_is_in_trainlm(monkeypatch, which):
    _, weights, batch, loss, _ = _program_step()
    same, _ = reference.Step(FP32, weights, 0.5).grads(*batch)
    _gpt_neox_variant(monkeypatch, which)
    variant, _ = reference.Step(FP32, weights, 0.5).grads(*batch)
    # the variant leaves TrainLM's loss by far more than the reference does
    assert abs(variant - loss) > 10 * abs(same - loss) + 1e-9, which


def test_the_configuration_files_list_the_departures():
    for name in ("pythia-1.4b", "pythia-6.9b-l16"):
        with open(os.path.join(HERE, "configs", name + ".json")) as fh:
            cfg = json.load(fh)
        text = " ".join(cfg["departures"])
        for word in ("RMSNorm", "rotary", "sequential residual", "tanh",
                     "no biases"):
            assert word in text, (name, word)
        assert cfg["assumed"] and "source" in cfg
        m = cfg["model_config"]
        assert (m["d_model"], m["n_heads"], m["d_ff"], m["vocab"],
                m["n_layers"]) == (
            cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["intermediate_size"], cfg["vocab_size"],
            cfg["num_hidden_layers"])
        assert m["d_model"] // m["n_heads"] == 128

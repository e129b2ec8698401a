"""Training traffic: ``brpc_tpu_torch.tpu.train.sgd_train_step`` back to
back on seeded batches.

A traffic file of kind ``train`` gives ``batch`` sequences of ``seq``
tokens a step, the SGD rate ``lr``, ``checked_steps`` (the first steps,
which the check compares with the reference), ``loss_every`` (the loss is
read to the host every so many steps, as a training loop logs it) and
``warm_steps`` (steps after the checked ones, before the window).

One run: the weights are drawn on the device from the seed and installed
with ``TrainLM.load_params``; the checked steps, on fresh batches, are
read for the check (:mod:`benchmark.check`); the warm steps
follow; then the window runs whole chunks of ``loss_every`` steps until
``seconds`` have passed, each step on a fresh batch drawn on the device
ahead of it, and ends in a synchronise. After the window the program's
state is freed and the plain reference (:mod:`benchmark.reference`) runs
the checked steps again from the same weights and batches.
"""

from __future__ import annotations

import gc
import hashlib
import math
import time

import torch

from brpc_tpu_torch.tpu import train as lm

from .. import check, devtrace, reference

GIB = 2 ** 30


def model_fields(config: dict) -> dict:
    """ModelConfig's fields from a configuration file's ``model_config``
    (the dtype by name)."""
    m = dict(config["model_config"])
    m["dtype"] = getattr(torch, m["dtype"])
    return m


def derived_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one stream of the run's draws."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_weights(m: dict, seed: int, device) -> dict:
    """{name: parameter} in ``m["dtype"]`` on ``device``: every matrix
    standard normal times d_model ** -0.5, as TrainLM draws them, in one
    draw from a generator on the device seeded from ``seed``; norm
    weights ones. The matrices are views of one buffer."""
    shapes = reference.leaf_shapes(m)
    dense = {k: s for k, s in shapes.items() if len(s) == 2}
    total = sum(math.prod(s) for s in dense.values())
    gen = torch.Generator(device=device).manual_seed(
        derived_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=m["dtype"])
    flat.mul_(m["d_model"] ** -0.5)
    out, at = {}, 0
    for k in reference.leaf_names(m["n_layers"]):
        s = shapes[k]
        if k in dense:
            n = math.prod(s)
            out[k] = flat[at:at + n].view(s)
            at += n
        else:
            out[k] = torch.ones(s, dtype=m["dtype"], device=device)
    return out


class Batches:
    """Uniform tokens [batch, seq] drawn on the device from the seed, a
    fresh batch each call; targets are the tokens rolled by one along the
    sequence, as the program's ``demo_batch`` makes them."""

    def __init__(self, m: dict, traffic: dict, seed: int, device):
        self.shape = (traffic["batch"], traffic["seq"])
        self.vocab = m["vocab"]
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(
            derived_seed(seed, "batches"))

    def __call__(self):
        tokens = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                               device=self.device)
        return tokens, torch.roll(tokens, -1, dims=1)


def _tree(weights: dict, n_layers: int) -> dict:
    """The weights in TrainLM's parameter tree."""
    return {"embed": weights["embed"], "head": weights["head"],
            "ln_f": weights["ln_f"],
            "layers": [{k: weights[f"layers.{i}.{k}"]
                        for k in reference.LAYER_KEYS}
                       for i in range(n_layers)]}


def _params(model) -> dict:
    """The model's parameters by :func:`reference.leaf_names`."""
    out = {"embed": model.embed, "head": model.head, "ln_f": model.ln_f}
    for i, layer in enumerate(model.layers):
        out.update({f"layers.{i}.{k}": getattr(layer, k)
                    for k in reference.LAYER_KEYS})
    return out


def build(m: dict, seed: int, device):
    """The program's model with the seeded weights installed, and those
    weights (the caller frees them)."""
    weights = make_weights(m, seed, device)
    cfg = lm.ModelConfig(**m)
    # TrainLM draws its own parameters, which load_params overwrites:
    # under the device's context that draw runs on the card
    with torch.device(device):
        model = lm.TrainLM(cfg, torch.Generator(device=device),
                           device=device)
    model.load_params(_tree(weights, m["n_layers"]))
    return model, weights


def checked_steps(model, weights: dict, batches, traffic: dict) -> dict:
    """The first steps, through the window's own call on fresh batches,
    read as :func:`reference.readings` reads the reference's."""
    lr = traffic["lr"]
    params = _params(model)
    losses, first, state = [], None, None
    for n in range(traffic["checked_steps"]):
        losses.append(lm.sgd_train_step(model, batches(), lr))
        if n == 0:
            first = reference.change_norms(params, weights, 1.0 / lr)
            state = reference.host_copy(params, weights["embed"].dtype)
    return {"losses": [float(x) for x in losses], "first_grad": first,
            "first_state": state,
            "change": reference.change_norms(params, weights)}


def reference_readings(m: dict, traffic: dict, seed: int, device,
                       quant: str = None) -> dict:
    """The plain reference's readings of the checked steps, from the
    run's weights and batches drawn again from the seed."""
    weights = make_weights(m, seed, device)
    batches = Batches(m, traffic, seed, device)
    step = reference.Step(m, weights, traffic["lr"], quant=quant)
    out = reference.readings(step, [batches() for _ in
                                    range(traffic["checked_steps"])],
                             weights)
    del step, weights
    free()
    return out


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _window(model, batches, traffic: dict, seconds: float):
    """Whole chunks of ``loss_every`` steps until ``seconds`` have passed,
    ending in a synchronise: (steps, seconds, logged losses)."""
    lr, every = traffic["lr"], traffic["loss_every"]
    steps, logged = 0, []
    t0 = time.perf_counter()
    while True:
        for _ in range(every):
            loss = lm.sgd_train_step(model, batches(), lr)
        steps += every
        logged.append(float(loss))
        if time.perf_counter() - t0 >= seconds:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return steps, time.perf_counter() - t0, logged


def run(config: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, trace: bool, t_start: float, device) -> dict:
    """One run of a training cell. Returns the end-to-end and per-layer
    context, the device's readings and the check."""
    m = model_fields(config)
    on_card = torch.device(device).type == "cuda"
    model, weights = build(m, seed, device)
    batches = Batches(m, traffic, seed, device)
    mine = checked_steps(model, weights, batches, traffic)
    del weights
    free()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for _ in range(traffic["warm_steps"]):
        float(lm.sgd_train_step(model, batches(), traffic["lr"]))
    setup_s = time.time() - t_start

    prof = None
    if trace:
        prof = _profiler(on_card)
        with prof, torch.profiler.record_function(devtrace.WINDOW):
            steps, window_s, logged = _window(model, batches, traffic,
                                              seconds)
    else:
        steps, window_s, logged = _window(model, batches, traffic, seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = traffic["loss_every"] * sum(not math.isfinite(x)
                                         for x in logged)
    del model, batches
    free()
    tokens = steps * traffic["batch"] * traffic["seq"]
    out = {
        "attempted": steps, "failed": failed,
        "end_to_end": {"train_tokens_per_s": tokens / window_s,
                       "peak_mem_gib": peak / GIB, "setup_s": setup_s},
        "memory_peak_bytes": peak,
        "trace": devtrace.read(prof) if prof is not None else None,
        "steps": steps, "model": m, "logged": logged,
    }
    ref = reference_readings(m, traffic, seed, device)
    numbers = check.compare(mine, ref, device)
    out["check"] = check.report(numbers, limits["limits"])
    out["correct"] = failed == 0 and check.verdict(numbers,
                                                   limits["limits"])
    return out


def _profiler(on_card: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)

"""Faults planted under the timed path, to show that the check fails them.
Each wraps ``brpc_tpu_torch.tpu.train.sgd_train_step``:

- ``unchanged``: the step returns the loss and leaves the parameters as
  they were.
- ``half_batch``: the step sees only the first half of the batch's
  sequences, the mean loss taken over them.

A training cell on one card has no exchange between chips and produces
no token, so those faults do not arise here.
"""

from __future__ import annotations

import contextlib

import torch

from brpc_tpu_torch.tpu import train as lm

FAULTS = ("unchanged", "half_batch")


def _broken(name: str, step):
    def unchanged(model, batch, lr=1e-3, mesh=None):
        with torch.no_grad():
            return lm.loss_fn(model, batch, mesh)

    def half_batch(model, batch, lr=1e-3, mesh=None):
        tokens, targets = batch
        half = max(1, tokens.shape[0] // 2)
        return step(model, (tokens[:half], targets[:half]), lr, mesh)

    return {"unchanged": unchanged, "half_batch": half_batch}[name]


@contextlib.contextmanager
def planted(name: str):
    """``sgd_train_step`` broken by fault ``name`` while the block runs."""
    step = lm.sgd_train_step
    lm.sgd_train_step = _broken(name, step)
    try:
        yield
    finally:
        lm.sgd_train_step = step

"""Carry weights between the JAX serving model and the torch port.

The JAX model's ``_params`` (name -> array) converted to numpy go through
:func:`params_from_jax` onto a device, and ``TinyTransformer.load_params``
installs them. With these a test hands the JAX model's exact weights to
the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """numpy weights (the JAX model's names and shapes) -> float32 torch
    tensors on ``device``."""
    return {name: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for name, a in np_params.items()}


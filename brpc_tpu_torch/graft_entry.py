"""The flagship's single-device graft entry point, on the port.

:func:`entry` is the counterpart of the JAX package's
``__graft_entry__.entry``: a callable and its example arguments for one
forward of the flagship transformer LM (vocab 2048, d_model 256, 8 heads,
4 layers, d_ff 1024, sequence 256, batch 4, bf16), with the trainer's
shipping attention (``flash_attention_mha``, the flash forward kernel on
the card) and plain norms, as the JAX entry's config has them. Weights
and tokens come from seeds 0 and 1 (``torch.Generator``; tests load the
JAX entry's parameters with ``TrainLM.load_params``).

Runs on ``cuda`` unless ``device="cpu"`` is passed, and raises with no
card. The multi-device ``dryrun_multichip`` waits for the port's mesh
(ROADMAP Queue 1 item 7(d)).
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.tpu import train

FLAGSHIP = dict(vocab=2048, d_model=256, n_heads=8, n_layers=4, d_ff=1024,
                max_seq=256)
BATCH, SEQ = 4, 256


def entry(device=None, dtype=torch.bfloat16):
    """(fn, (model, tokens)): ``fn(model, tokens)`` is one forward,
    tokens [4, 256] -> logits [4, 256, 2048]."""
    cfg = train.ModelConfig(**FLAGSHIP, dtype=dtype)
    model = train.TrainLM(cfg, torch.Generator().manual_seed(0),
                          device=device)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(1))

    def fn(model, tokens):
        with torch.inference_mode():
            return model(tokens)

    return fn, (model, tokens.to(model.embed.device))

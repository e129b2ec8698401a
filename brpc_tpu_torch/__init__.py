"""brpc_tpu_torch: the PyTorch / CUDA port of brpc_tpu's device path.

A second package beside ``brpc_tpu`` (the JAX reference, which stays as
it is). It imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``brpc_tpu``: what it needs from there it keeps as its own copy. Every
TPU kernel on a ported path is a CUDA kernel written by hand for Hopper
(``csrc/``), built with nvcc at first use.

- :mod:`brpc_tpu_torch.tpu` — the device store, the kernels and the
  flagship LM's single-device training step (``tpu.train``).
- :mod:`brpc_tpu_torch.serving` — the LLM serving engine's prefill and
  decode path: paged KV cache, toy transformer, continuous-batching
  engine.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
and raise when there is no card.
"""

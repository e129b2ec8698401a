"""brpc_tpu_torch: the PyTorch / CUDA port of brpc_tpu's device path.

A second package beside ``brpc_tpu`` (the JAX reference, which stays as
it is). It imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``brpc_tpu``: what it needs from there it keeps as its own copy. Every
TPU kernel on a ported path is a CUDA kernel written by hand for Hopper
(``csrc/``), built with nvcc at first use.

- :mod:`brpc_tpu_torch.tpu` — the device store and its data plane
  (``tpu.device_lane``, copies by ``tpu.bench_kernels``) with its
  ``tpu://`` lane (``tpu.tpusocket`` in process, ``tpu.transport``
  across processes, ``tpu.device_stream``, ``tpu.mesh`` naming), the
  kernels and the flagship LM's single-device training step
  (``tpu.train``).
- :mod:`brpc_tpu_torch.serving` — the LLM serving engine's prefill and
  decode path: paged KV cache, toy transformer, continuous-batching
  engine, and ``serving.service.LlmServingService`` on the RPC front.
- :mod:`brpc_tpu_torch.rpc` — the RPC front (``Server``, ``Channel``,
  ``Stub``, ``Controller``, streams over trpc_std) with its host
  utilities (``butil``, ``fiber``, ``flags``, ``metrics``, ``trace``,
  ``fault``, ``profiling``, ``policy``), copied from the JAX package onto
  its pure-Python branches; wire messages are tables of the port's own
  message runtime (``proto._message``), so nothing needs protobuf.
- :mod:`brpc_tpu_torch.graft_entry` — the flagship's graft entry point, ``entry()``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(for ``tpu://`` ordinals, ``tpu.mesh.use_cpu()``), and raise when there
is no card.
"""

__version__ = "0.1.0"

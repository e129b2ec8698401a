"""tpu — the device half of the port: the handle store and its data
plane, the ``tpu://`` lane (TpuSocket in process, the cross-process
tunnel, device streams, ordinal naming), the kernels, the single-device
trainer, ring attention on one device.

Named after ``brpc_tpu/tpu`` so each module's counterpart sits under the
same relative path; on this side the device is a CUDA card. Importing
this package imports no submodule, and no kernel is built at import.
"""

__all__ = ["bench_kernels", "device_lane", "device_stream", "mesh",
           "pallas_ops", "ring", "tpusocket", "train", "transport"]

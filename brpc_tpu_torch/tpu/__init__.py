"""tpu — the device half of the port: the handle store and the kernels.

Named after ``brpc_tpu/tpu`` so each module's counterpart sits under the
same relative path; on this side the device is a CUDA card. Importing
this package imports no submodule, and no kernel is built at import.
"""

__all__ = ["device_lane", "pallas_ops"]

"""eager_ms_per_step: device ms a step in kernels that are neither the
port's (``yardstick.PORT_KERNELS``) nor matrix products (cuBLAS and
CUTLASS names): PyTorch's own casts, adds, GELU, the cross-entropy's
plain backward, the SGD update, copies and fills."""

from benchmark import yardstick


def read(ctx):
    if not ctx["steps"]:
        return None
    secs = sum(s for name, s in ctx["trace"]["kernel_s"].items()
               if not yardstick.is_kernel_of(name, yardstick.PORT_KERNELS)
               and not yardstick.is_matmul(name))
    return 1000.0 * secs / ctx["steps"]

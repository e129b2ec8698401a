"""xent_roofline: the share of the roofline that the fused cross-entropy
forward (csrc/xent.cu) reach: the step's operations and bytes
(``yardstick.xent_work``) over the kernels' summed device time in the
traced window."""

from benchmark import yardstick


def read(ctx):
    secs = sum(s for name, s in ctx["trace"]["kernel_s"].items()
               if yardstick.is_kernel_of(name, yardstick.XENT_KERNELS))
    if not secs or not ctx["steps"]:
        return None
    t = ctx["traffic"]
    flops, nbytes = yardstick.xent_work(
        ctx["model"], t["batch"], t["seq"])
    share, _ = yardstick.roofline_share(flops * ctx["steps"],
                                        nbytes * ctx["steps"], secs)
    return share

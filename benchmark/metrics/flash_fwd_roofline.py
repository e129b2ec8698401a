"""flash_fwd_roofline: the share of the roofline that the flash forward
kernel (csrc/flash_fwd.cu) reach: the step's operations and bytes
(``yardstick.flash_fwd_work``) over the kernels' summed device time in
the traced window."""

from benchmark import yardstick


def read(ctx):
    secs = sum(s for name, s in ctx["trace"]["kernel_s"].items()
               if yardstick.is_kernel_of(name, yardstick.FLASH_FWD_KERNELS))
    if not secs or not ctx["steps"]:
        return None
    t = ctx["traffic"]
    flops, nbytes = yardstick.flash_fwd_work(
        ctx["model"], t["batch"], t["seq"])
    share, _ = yardstick.roofline_share(flops * ctx["steps"],
                                        nbytes * ctx["steps"], secs)
    return share

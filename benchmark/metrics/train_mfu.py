"""train_mfu: the traced window's training FLOPs (``yardstick.step_flops``
a step, causal attention pairs) over its wall time, as a share of the
H100's 989 TFLOP/s bf16 peak."""

from benchmark import yardstick


def read(ctx):
    steps, t = ctx["steps"], ctx["traffic"]
    if not steps:
        return None
    flops = yardstick.step_flops(ctx["model"], t["batch"], t["seq"]) * steps
    return 100.0 * flops / ctx["trace"]["window_s"] / \
        yardstick.PEAK_BF16_FLOPS

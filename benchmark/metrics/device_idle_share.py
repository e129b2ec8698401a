"""device_idle_share: the share of the traced window in which no
operation ran on the device (device intervals merged)."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]

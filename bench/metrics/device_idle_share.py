"""1 - the union of the device's operation intervals (kernels, copies,
fills) over the traced window's length."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["device_ops"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]

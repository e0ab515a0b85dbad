"""The device's idle share of the traced stretch: its span less the union
of device operations, over its span."""


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]

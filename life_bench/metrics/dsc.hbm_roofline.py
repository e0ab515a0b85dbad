"""DSC's share of its HBM roofline: the least bytes of one call
(``yardstick.dsc_bytes``) at 3.35 TB/s over the device seconds per call
under the ``dsc`` range of the traced stretch."""
from life_bench.yardstick import hbm_seconds


def read(ctx):
    t, calls = ctx["trace"], ctx["trace"]["calls"].get("dsc", 0)
    seconds = t["device_s"].get("dsc", 0.0)
    if not calls or seconds <= 0:
        return None
    return 100.0 * hbm_seconds(ctx["bytes"]["dsc"]) / (seconds / calls)

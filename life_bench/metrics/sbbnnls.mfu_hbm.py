"""The whole iteration's share of the card's peak, which for this
memory-bound solver is HBM bandwidth: the least bytes of every DSC and WC
call of the traced stretch at 3.35 TB/s over the stretch's wall time."""
from life_bench.yardstick import hbm_seconds


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0:
        return None
    n_bytes = (t["calls"].get("dsc", 0) * ctx["bytes"]["dsc"]
               + t["calls"].get("wc", 0) * ctx["bytes"]["wc"])
    return 100.0 * hbm_seconds(n_bytes) / t["window_s"]

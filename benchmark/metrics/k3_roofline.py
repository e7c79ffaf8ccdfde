"""K3's share of its roofline in the traced images, %: the least time the
work of the 21 int8 layers of every predict call needs (``work/k3.py``:
operations at the int8 peak, or bytes at the memory's rate, whichever is
longer, layer by layer) over K3's device time."""

from harness import peaks
from work import k3


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "serve" or not t:
        return None
    spent = t["by_group_s"].get("K3 int8_conv", 0.0)
    if spent <= 0:
        return None
    tile = ctx["traffic"]["tile"]
    bound = sum(k3.call_bound_s(ctx["config"], b, tile, peaks.OPS_PER_S["int8"],
                                peaks.HBM_BYTES_PER_S) for b in ctx["calls_per_image"])
    return 100.0 * bound * t["items"] / spent

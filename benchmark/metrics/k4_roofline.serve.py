"""K4's share of its roofline in the traced images of eval serving, %:
the bytes of the 23 eval applies of every predict call (``work/k4.py``) at
the memory's rate over K4's device time."""

from harness import peaks
from work import k4


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "serve" or not t:
        return None
    spent = t["by_group_s"].get("K4 batchnorm", 0.0)
    if spent <= 0:
        return None
    tile = ctx["traffic"]["tile"]
    nbytes = sum(k4.serve_bytes(ctx["config"], b, tile) for b in ctx["calls_per_image"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S * t["items"] / spent

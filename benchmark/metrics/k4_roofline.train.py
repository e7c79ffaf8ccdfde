"""K4's share of its roofline in the traced train steps, %: the bytes of
the 23 layers' four kernels a step (``work/k4.py``) at the memory's rate
over K4's device time."""

from harness import peaks
from work import k4


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "train" or not t:
        return None
    spent = t["by_group_s"].get("K4 batchnorm", 0.0)
    if spent <= 0:
        return None
    size = ctx["traffic"]["size"]
    nbytes = k4.train_bytes(ctx["config"], ctx["images_per_step"], size)
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S * t["items"] / spent

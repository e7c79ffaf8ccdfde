"""K4's share of its roofline in TransUNet's traced train steps, %: the
bytes of the decoder's nine layers' four kernels a step
(``work/transunet.py``, counted as ``work/k4.py`` counts the U-Net's) at the
memory's rate over K4's device time."""

from harness import peaks
from work import transunet


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("model") != "transunet_r50_b16" or not t:
        return None
    spent = t["by_group_s"].get("K4 batchnorm", 0.0)
    if spent <= 0:
        return None
    nbytes = transunet.k4_train_bytes(ctx["config"], ctx["images_per_step"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S * t["items"] / spent

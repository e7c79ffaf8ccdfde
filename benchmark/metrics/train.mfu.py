"""The whole train step's share of the cards' peak, %: three times the
forward's operations an image (``work/unet.py``) times the images stepped
outside the profiled stretch, per second of the window outside it, over the
bf16 peak of every card the cell uses."""

from harness import peaks
from work import unet


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "train" or w["seconds_outside"] <= 0 or not w["items_outside"]:
        return None
    size = ctx["traffic"]["size"]
    images = w["items_outside"] * ctx["images_per_step"] * ctx.get("ranks", 1)
    rate = unet.train_ops(ctx["config"], size, size) * images / w["seconds_outside"]
    return 100.0 * rate / (peaks.OPS_PER_S[ctx["config"]["train"]["peak"]] * ctx.get("ranks", 1))

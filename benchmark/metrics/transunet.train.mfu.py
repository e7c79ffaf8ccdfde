"""TransUNet's train step's share of the card's peak, %: three times the
forward's operations an image (``work/transunet.py``) times the images
stepped outside the profiled stretch, per second of the window outside it,
over the bf16 peak."""

from harness import peaks
from work import transunet


def read(ctx):
    w = ctx["window"]
    if ctx.get("model") != "transunet_r50_b16" or w["seconds_outside"] <= 0 \
            or not w["items_outside"]:
        return None
    images = w["items_outside"] * ctx["images_per_step"]
    rate = transunet.train_ops(ctx["config"]) * images / w["seconds_outside"]
    return 100.0 * rate / peaks.OPS_PER_S[ctx["config"]["train"]["peak"]]

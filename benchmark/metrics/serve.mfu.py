"""The whole pass's share of the card's peak, %: the model's operations on
every tile computed (``work/unet.py``: 2 a multiply-add, one tap a
transposed-conv output pixel) over the images served outside the
profiled stretch, per second of the window outside it, over the peak of
the configuration's serving precision."""

from harness import peaks
from work import unet


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "serve" or w["seconds_outside"] <= 0 or not w["items_outside"]:
        return None
    tile = ctx["traffic"]["tile"]
    ops = ctx["tiles_per_image"] * unet.forward_ops(ctx["config"], tile, tile)
    rate = ops * w["items_outside"] / w["seconds_outside"]
    return 100.0 * rate / peaks.OPS_PER_S[ctx["config"]["serve"]["peak"]]

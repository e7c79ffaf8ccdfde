"""Attention's share of its roofline in the traced train steps, %: the
operations of every layer's attention a step (``work/transunet.py``:
``4 * L^2 * hidden`` forward and ``8 * L^2 * hidden`` backward a layer, the
flash backward's recompute not counted) at the bf16 peak, over the device
time of SDPA's flash kernels (the driver's own group)."""

from harness import peaks
from work import transunet


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("model") != "transunet_r50_b16" or not t:
        return None
    spent = t.get("group_s", {}).get("attention", 0.0)
    if spent <= 0:
        return None
    ops = transunet.attention_train_ops(ctx["config"]) * ctx["images_per_step"]
    return 100.0 * ops / peaks.OPS_PER_S[ctx["config"]["train"]["peak"]] * t["items"] / spent

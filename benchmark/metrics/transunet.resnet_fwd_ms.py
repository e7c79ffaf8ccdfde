"""Device time the ResNet encoder's forward caused a traced train step, ms:
the kernels issued inside the program's ``model.resnet`` span
(``harness/spans.py``): the weight standardizations, convs, GroupNorms and
the pool."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("model") != "transunet_r50_b16" or not t or "spans" not in t:
        return None
    row = t["spans"]["by_span"].get("train.model.resnet")
    if row is None or not t["items"]:
        return None
    return 1e3 * row["device_s"] / t["items"]

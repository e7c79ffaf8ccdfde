"""Kernel launches a train step, counted in the traced steps."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "train" or not t or not t["items"] or not t["launches"]:
        return None
    return t["launches"] / t["items"]

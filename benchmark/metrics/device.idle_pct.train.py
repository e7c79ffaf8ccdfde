"""The share of the traced train steps' window in which no kernel, copy or
set ran on the card (rank 0's), %: the union of the device's intervals,
so streams that overlap count once."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "train" or not t:
        return None
    return t["idle_pct"]

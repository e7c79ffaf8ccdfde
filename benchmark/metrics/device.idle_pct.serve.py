"""The share of the traced images' window in which no kernel, copy or set
ran on the card, %: the union of the device's intervals, so streams that
overlap count once."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "serve" or not t:
        return None
    return t["idle_pct"]

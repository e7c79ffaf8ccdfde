"""Device time of the host-to-device copies of one served image, ms: the
upload of each slide by ``infer/tiled.py`` (the trace's ``Memcpy HtoD``)."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "serve" or not t or not t["items"] or not t["h2d_s"]:
        return None
    return 1e3 * t["h2d_s"] / t["items"]

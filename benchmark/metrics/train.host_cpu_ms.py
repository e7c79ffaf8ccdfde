"""Host CPU time of the process a train step, ms: ``time.process_time``
over the window's steps outside the profiled stretch."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "train" or not w["items_outside"]:
        return None
    return 1e3 * w["cpu_outside"] / w["items_outside"]

"""The card's peak allocated memory in the training window, GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["peak_window_bytes"]:
        return None
    return ctx["peak_window_bytes"] / 2 ** 30

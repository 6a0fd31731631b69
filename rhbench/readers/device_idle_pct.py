"""The share of the traced window in which the card ran no kernel, copy or
memset: 100 x (1 - the union of the device's intervals / the window).
None where no operation ran on a device (a run off the card)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

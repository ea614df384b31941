"""Share of the traced window with nothing running on the card (this
process's card), split by the end-to-end metric it moves."""

LAYER = "device"
UNIT = "%"
MOVES = "predict_ms_p95"


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

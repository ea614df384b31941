"""Share of a traced DeepSeek-V3 round's window with nothing running on the
card (this process's card)."""

LAYER = "device"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""Share of the traced window of training steps in which no device operation
ran, in percent."""

def read(ctx):
    if ctx.trace is None or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

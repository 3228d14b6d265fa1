"""Host microseconds a frame spends submitting its work: the copy of the pose
into the captured camera and the graph's replay call (``render.py`` through
``graphs.CapturedGraph.replay``), a mean over the measured window."""

def read(ctx):
    return getattr(ctx, "submit_us", None)

"""MiB the cell's CUDA graph added to the graphs' memory pool when it was
captured (``graphs.CapturedGraph.pool_bytes``)."""

def read(ctx):
    b = getattr(ctx, "pool_bytes", None)
    return None if b is None else b / 2 ** 20

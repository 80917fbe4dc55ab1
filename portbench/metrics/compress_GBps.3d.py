"""compress_GBps.3d: the window's compress rate, float32 bytes of every
field compressed in the window over the window's seconds, as the
end-to-end `compress_GBps` takes it, in the cells where that rate is read
per layer: there the host's slower phases move whole runs by more than
half the largest bound allows (PERF.md, §6)."""


def read(ctx):
    if not ctx.get("window_s") or not ctx.get("raw_bytes"):
        return None
    return ctx["raw_bytes"] / ctx["window_s"] / 1e9

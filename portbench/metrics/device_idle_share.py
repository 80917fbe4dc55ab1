"""device_idle_share: the share of the traced stretch of requests in which
no operation ran on the device, from the profiler's trace."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

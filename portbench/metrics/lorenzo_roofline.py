"""lorenzo_roofline: the least time of the fused quantize + Lorenzo work
over the device time of the kernels that did it, in the traced stretch.

The least time counts each SZ field encoded on the device once: its
float32 values read once and its int32 codes written once, at the HBM
peak. The bytes are fixed by the work, so the share reads the same
whatever kernel implements it; the kernels are matched by name.
"""

from portbench.peaks import HBM_BYTES_PER_S

#: device kernels that do the Lorenzo work (K1 2-D, K2 3-D), matched within
#: the trace's demangled kernel names
KERNELS = ("lorenzo2d_kernel", "lorenzo3d_kernel")


def least_bytes(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return 4 * n + 4 * n


def least_seconds(shape) -> float:
    return least_bytes(shape) / HBM_BYTES_PER_S


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    spent = sum(v for k, v in trace.by_name.items() if any(n in k for n in KERNELS))
    fields = ctx["stretch_sz_device_fields"]
    if not spent or not fields:
        return None
    return 100.0 * fields * least_seconds(ctx["field_shape"]) / spent

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W power limit), the yardstick of the roofline shares: the kernels so
far are bound by bytes."""

HBM_BYTES_PER_S = 3.35e12

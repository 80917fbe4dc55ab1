"""lorenzo3d_roofline: `lorenzo_roofline`, read the same way, in the cells
whose compress rate is read per layer (`compress_GBps.3d`), where the 3-D
kernel (K2) does the Lorenzo work; it names the cell's other end-to-end
metric as the one it moves."""

from portbench.spec import metric_reader

read = metric_reader("lorenzo_roofline")

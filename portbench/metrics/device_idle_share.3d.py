"""device_idle_share.3d: `device_idle_share`, read the same way, in the cells
whose compress rate is read per layer (`compress_GBps.3d`). It names the
cell's other end-to-end metric as the one it moves."""

from portbench.spec import metric_reader

read = metric_reader("device_idle_share")

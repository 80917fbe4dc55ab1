"""Count the torch ops of the KV tier's ratio-grid estimate on the CPU.

The evict's ratio-grid solve is host-bound on the card: each torch op is
one dispatch and (on the card) one kernel launch, so the op count is what
the step's time follows. For the `repro_torch` under ``--src`` (default
this checkout's), this prints one JSON line with two counts on a
phi4-mini-width (32, 16, 1024) page stack:

* ``grid_estimate_profiler_ops`` — the top-level ops `torch.profiler`
  records for `estimate_zfp_many(mode="model")` over a 12-candidate grid
  (with ``psnr=False`` where the estimator takes it, as the grid does);
* ``policy_eb_dispatched_ops`` — every op the dispatcher sees in
  `kvcomp._policy_eb` (the whole grid solve), and the most frequent.

    PYTHONPATH=src python tools/count_ops.py [--src OTHER_CHECKOUT/src]
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", type=Path, default=Path(__file__).resolve().parent.parent / "src")
    args = parser.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import estimator as est
    from repro_torch.core.policy import serving_policies
    from repro_torch.runtime import kvcomp

    rng = np.random.default_rng(0)
    page = torch.from_numpy(np.cumsum(rng.standard_normal((32, 16, 1024)), axis=1).astype(np.float32))
    starts = est.block_starts(tuple(page.shape), 0.05)
    blocks = est.gather_blocks(page, starts)
    n_c, n_s = 12, blocks.shape[0]
    cand = blocks.expand((n_c,) + tuple(blocks.shape)).reshape((n_c * n_s,) + blocks.shape[1:])
    seg = torch.arange(n_c).repeat_interleave(n_s)
    bounds = torch.arange(n_c + 1) * n_s
    vr = kvcomp._value_range(page)
    ebs = vr * torch.tensor([2.0**-j for j in range(n_c)])
    kw = {"psnr": False} if "psnr" in inspect.signature(est.estimate_zfp_many).parameters else {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        est.estimate_zfp_many(cand, seg, bounds, ebs, vr.expand(n_c), mode="model", **kw)
    top = [e for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None]

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    pol = serving_policies(8.0).resolve("kv/long/0")
    kvcomp._policy_eb(page, vr, pol)  # warm
    with Count() as count:
        kvcomp._policy_eb(page, vr, pol)
    print(json.dumps(dict(
        src=str(args.src), grid_estimate_profiler_ops=len(top), psnr_skipped=bool(kw),
        policy_eb_dispatched_ops=sum(count.ops.values()),
        most_frequent=count.ops.most_common(4))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

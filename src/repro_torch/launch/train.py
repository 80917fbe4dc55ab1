"""End-to-end training driver, in torch.

Port of `repro.launch.train`. On the GPU (the default device):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 200 \
      --ckpt-dir CKPT --compress-ckpt --compress-grads

On a machine without a GPU, at the reduced smoke size:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 25

Features: deterministic data pipeline, AdamW, per-layer activation
checkpointing, lossy-compressed checkpoints with Algorithm-1 selection,
resume from the latest checkpoint, error-feedback gradient compression,
async checkpoint writes. Parameters are drawn from a `torch.Generator`
seeded 0 on the device. The reference's mesh and sharding rules are a
single-device no-op here and are left out (compute under a mesh is
ROADMAP queue A item 14b). The train step updates the params and optimizer state in place
(the reference donates them to its jitted step); `async_save` snapshots
them on the device before the next step runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import device as _device
from ..checkpoint import CheckpointConfig, CheckpointManager
from ..configs import get_config
from ..core import Policy, PolicySet
from ..data import DataConfig, synthetic_batch
from ..models import build_model, reduced_for_smoke
from ..models import nn as rnn
from ..optim import AdamWConfig, GradCompressConfig
from ..runtime.steps import init_opt_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu on a machine without a GPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--d-model", type=int, default=None, help="override width")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-eb", type=float, default=1e-4)
    ap.add_argument(
        "--ckpt-opt-ratio", type=float, default=None,
        help="also lossy-compress optimizer state, at this fixed ratio "
        "(a PolicySet: weights keep the eb bound, opt/* gets the budget)",
    )
    ap.add_argument("--compress-ckpt", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg)
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, head_dim=args.d_model // cfg.n_heads
        )
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    model = build_model(cfg, device=dev)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=min(20, args.steps // 5))
    gc_cfg = GradCompressConfig() if args.compress_grads else None
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    params = rnn.init_tree(model.desc(), torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = init_opt_state(params, gc_cfg)
    start_step = 0

    mgr = None
    if args.ckpt_dir:
        ckpt_policy: Policy | PolicySet = Policy.fixed_accuracy(eb_rel=args.ckpt_eb)
        if args.ckpt_opt_ratio:
            ckpt_policy = PolicySet(
                default=ckpt_policy,
                rules=[("opt/*", Policy.fixed_ratio(args.ckpt_opt_ratio))],
            )
        mgr = CheckpointManager(
            CheckpointConfig(args.ckpt_dir, policy=ckpt_policy, compress=args.compress_ckpt),
            device=dev,
        )
        if args.resume and mgr.latest_step() is not None:
            tmpl = {"params": params, "opt": opt_state["adam"]}
            start_step, restored = mgr.restore_tree(tmpl)
            params = restored["params"]
            opt_state["adam"] = restored["opt"]
            print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    step_fn = make_train_step(model, opt_cfg, gc_cfg)
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = _to_device(synthetic_batch(dcfg, step), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            extra = ""
            if "wire_bits_per_value" in metrics:
                extra = f" wire_bits={float(metrics['wire_bits_per_value']):.2f}"
            print(
                f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f}{extra}",
                flush=True,
            )
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.async_save(step + 1, {"params": params, "opt": opt_state["adam"]})
    if mgr is not None:
        mgr.wait()
        mgr.save(args.steps, {"params": params, "opt": opt_state["adam"]})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"[done] {args.steps - start_step} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"losses": losses, "seconds": dt, "params": params}


if __name__ == "__main__":
    main()

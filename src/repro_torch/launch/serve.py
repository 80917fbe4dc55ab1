"""Batched serving driver: prefill + greedy decode with KV cache, in torch.

Port of `repro.launch.serve`. On the GPU (the default device):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --batch 4 --prompt-len 64 --gen 32

Continuous mode (`--continuous`) runs the compression-aware serving tier
(DESIGN.md §9) instead: a `ContinuousBatcher` with the paged KV pool under
synthetic Poisson arrivals; long-context requests resolve to a
`Policy.fixed_ratio` byte budget for compress-on-evict, short ones stay raw.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b --continuous

On a machine without a GPU, at the reduced smoke size:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke [--continuous]

Parameters are drawn from a `torch.Generator` seeded 0 on the device. The
reference's mesh activation is a single-device no-op and is left out
(compute under a mesh is ROADMAP queue A item 14b).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import device as _device
from ..configs import get_config
from ..core.decision_cache import DecisionCache
from ..core.policy import serving_policies
from ..models import build_model, reduced_for_smoke
from ..models import nn as rnn
from ..runtime.batcher import ContinuousBatcher, Request
from ..runtime.steps import make_decode_step, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_continuous(args, cfg, model, params, *, policies=None) -> dict:
    """Continuous serving under Poisson arrivals (arrival clock = decode
    steps). Prompt lengths mix short and long around `--long-threshold`
    so both PolicySet arms (raw / fixed_ratio) are exercised. `policies`
    (default `serving_policies(args.target_ratio)`) is the batcher's
    PolicySet. The result holds the finished `Request`s under
    ``"requests"``."""
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.gen
    decisions = DecisionCache()
    b = ContinuousBatcher(
        model, params, slots=args.slots, max_len=max_len, eos_id=-1,
        page_tokens=args.page_tokens, arena_pages=args.arena_pages,
        policies=serving_policies(args.target_ratio) if policies is None else policies,
        long_threshold=args.long_threshold, decisions=decisions,
    )
    if not b.paged:
        raise SystemExit(f"--continuous needs the paged KV pool; {args.arch} "
                         "does not support it (MLA / quantized KV)")
    short_len = max(4, args.prompt_len // 4)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(
                1, cfg.vocab, args.prompt_len if i % 2 else short_len
            ).astype(np.int32),
            max_new=args.gen,
        )
        for i in range(args.requests)
    ]
    arrive = np.cumsum(rng.exponential(1.0 / args.rate, size=len(reqs)))
    t0 = time.time()
    clock, nxt_req, steps, decoded = 0.0, 0, 0, 0
    pending: list[Request] = []
    peak_resident = 0
    while nxt_req < len(reqs) or pending or b.preempted or b.live.any():
        while nxt_req < len(reqs) and arrive[nxt_req] <= clock:
            pending.append(reqs[nxt_req])
            nxt_req += 1
        while b.preempted and b.try_admit(b.preempted[0]):
            b.preempted.pop(0)
        while pending and b.try_admit(pending[0]):
            pending.pop(0)
        if b.live.any():
            decoded += int(b.live.sum())
            b.step()
            steps += 1
        peak_resident = max(peak_resident, b.resident_kv_bytes())
        clock += 1.0
    _sync(model.device)
    wall = time.time() - t0
    done = sum(r.done for r in reqs)
    out = {
        "completed": done,
        "steps": steps,
        "decode_tok_s": decoded / max(wall, 1e-9),
        "evictions": b.stats["evictions"],
        "restores": b.stats["restores"],
        "page_reuses": b.stats["page_reuses"],
        "peak_resident_kv_bytes": peak_resident,
        "decision_hits": decisions.hits,
        "requests": reqs,
    }
    print(f"[serve --continuous] {done}/{len(reqs)} requests in {steps} "
          f"decode steps ({out['decode_tok_s']:.1f} tok/s); "
          f"evictions {out['evictions']}, restores {out['restores']}, "
          f"page reuses {out['page_reuses']}, "
          f"peak resident KV {peak_resident / 1e6:.2f} MB, "
          f"decision-cache hits {decisions.hits}")
    if done != len(reqs):
        raise RuntimeError(f"continuous serving dropped {len(reqs) - done} requests")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu on a machine without a GPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous serving: paged KV pool + Poisson arrivals")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.25,
                    help="Poisson arrival rate (requests per decode step)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--arena-pages", type=int, default=None)
    ap.add_argument("--target-ratio", type=float, default=8.0)
    ap.add_argument("--long-threshold", type=int, default=64)
    return ap.parse_args(argv)


def build(args):
    """(cfg, model, params) for `args`: the config (reduced with --smoke),
    the model on --device, and parameters from a generator seeded 0."""
    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg)
    model = build_model(cfg, device=dev)
    params = rnn.init_tree(model.desc(), torch.Generator(device=dev).manual_seed(0), device=dev)
    return cfg, model, params


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg, model, params = build(args)
    if args.continuous:
        return run_continuous(args, cfg, model, params)
    return run_static(args, cfg, model, params)


def run_static(args, cfg, model, params) -> dict:
    """A batch of `args.batch` prompts of `args.prompt_len` tokens (and,
    drawn after them from the same generator as in the reference, the
    vision stub's patch embeddings or the encoder-decoder's frames) through
    one prefill, then `args.gen - 1` decode steps on the contiguous cache:
    the tokens, the prefill's seconds and the decode loop's seconds, each
    timed between synchronizes."""
    dev = model.device

    rng = np.random.default_rng(0)
    b = args.batch
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (b, args.prompt_len)),
                              dtype=torch.int32, device=dev)
    max_len = args.prompt_len + args.gen
    batch = {"tokens": prompts}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((b, cfg.frontend_len, cfg.d_model)), dtype=torch.float32,
            device=dev)
    if cfg.encdec:  # the audio stub's frame embeddings, encoded once by the prefill
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((b, cfg.frontend_len, cfg.d_model)), dtype=torch.float32,
            device=dev)

    prefill = make_prefill_step(model)
    decode = make_decode_step(model, sample=args.sample)
    generator = torch.Generator(device=dev).manual_seed(1)
    cache = model.init_cache(b, max_len)
    _sync(dev)
    t0 = time.time()
    logits, cache = prefill(params, batch, cache)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    t_prefill = time.time() - t0
    toks = [nxt]
    t0 = time.time()
    for _ in range(args.gen - 1):
        nxt, cache = decode(params, nxt, cache, generator if args.sample else None)
        toks.append(nxt)
    _sync(dev)
    t_decode = time.time() - t0
    out = torch.cat(toks, dim=1).cpu().numpy()
    tput = b * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] prefill {args.prompt_len} toks x{b}: {t_prefill:.2f}s; "
          f"decode {args.gen - 1} steps: {t_decode:.2f}s ({tput:.1f} tok/s)")
    print("[serve] sample output ids:", out[0, :16])
    return {"tokens": out, "prefill_s": t_prefill, "decode_s": t_decode}


if __name__ == "__main__":
    main()

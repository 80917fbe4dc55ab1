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

Parameters are drawn from a `torch.Generator` seeded 0 on the device.
In a job of more than one rank (`runtime.dist.initialize`), `main` serves
the static batch under a mesh as the reference does: the production mesh,
params laid out by `SERVE_RULES` (`sharding.place_params`), the prompts by
`launch.dryrun.batch_shardings` and the cache by `cache_sharding`, all
as DTensors; `run_static(..., mesh=)` does the same on any mesh (e.g.
`launch.mesh.make_emulated_mesh((2, 2))`). One rank runs unsharded.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from .. import device as _device
from ..configs import get_config
from ..core.decision_cache import DecisionCache
from ..core.policy import serving_policies
from ..models import build_model, reduced_for_smoke
from ..models import nn as rnn
from ..runtime import dist, sharding
from ..runtime.batcher import ContinuousBatcher, Request
from ..runtime.steps import greedy, make_decode_step, make_prefill_step
from .dryrun import batch_shardings


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


def build(args, mesh=None):
    """(cfg, model, params) for `args`: the config (reduced with --smoke),
    the model on --device, and parameters from a generator seeded 0 (laid
    out by `SERVE_RULES` on `mesh` when given)."""
    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg)
    model = build_model(cfg, device=dev)
    if mesh is not None:
        return cfg, model, sharding.place_params(model, mesh, sharding.SERVE_RULES)
    params = rnn.init_tree(model.desc(), torch.Generator(device=dev).manual_seed(0), device=dev)
    return cfg, model, params


def main(argv=None) -> dict:
    args = parse_args(argv)
    mesh = None
    if dist.is_multihost() and not args.continuous:
        from .mesh import make_production_mesh

        mesh = make_production_mesh(device=args.device)
    cfg, model, params = build(args, mesh)
    if args.continuous:
        return run_continuous(args, cfg, model, params)
    return run_static(args, cfg, model, params, mesh=mesh)


def run_static(args, cfg, model, params, *, mesh=None, rules=sharding.SERVE_RULES,
               teacher: np.ndarray | None = None, keep: bool = False,
               seq_shard: bool = False) -> dict:
    """A batch of `args.batch` prompts of `args.prompt_len` tokens (and,
    drawn after them from the same generator as in the reference, the
    vision stub's patch embeddings or the encoder-decoder's frames) through
    one prefill, then `args.gen - 1` decode steps on the contiguous cache:
    the tokens, the prefill's seconds and the decode loop's seconds, each
    timed between synchronizes.

    With `mesh`, everything runs under `sharding.activate(mesh, rules)`:
    `params` must be laid out on it (`sharding.place_params`); the prompts,
    patch embeddings and frames are laid out by `batch_shardings` and the
    cache by `cache_sharding`, and the
    tokens are gathered to every rank at the end; `seq_shard` splits
    the cache along its sequence where no head dim can take 'model'
    (`cache_sharding(seq_shard=True)`). `teacher` (B, n) feeds
    decode step i < n the token `teacher[:, i]` instead of the previous
    step's (the greedy tokens are still returned). `keep` adds the
    last-position logits of the prefill and of every step (``"logits"``,
    float32 host tensors (B, vocab)) and the final cache (``"cache"``)."""
    dev = model.device

    rng = np.random.default_rng(0)
    b = args.batch

    def place(values, dtype=torch.int32) -> torch.Tensor:
        """A batch leaf on the device; under a mesh laid out by
        `batch_shardings` (its leading batch dim over the data dims)."""
        t = torch.as_tensor(values, dtype=dtype, device=dev)
        return t if mesh is None else dist.put_global(t, batch_shardings({"t": t}, mesh, b)["t"])

    prompts = place(rng.integers(1, cfg.vocab, (b, args.prompt_len)))
    forced = [] if teacher is None else [place(teacher[:, i:i + 1]) for i in range(teacher.shape[1])]
    # the vision stub's patch embeddings take cache rows before the prompt
    # (the reference sizes its cache without them, and its prefill fails)
    patches = cfg.frontend_len if cfg.frontend == "vision" else 0
    max_len = patches + args.prompt_len + args.gen
    batch = {"tokens": prompts}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = place(rng.standard_normal((b, cfg.frontend_len, cfg.d_model)),
                                      torch.float32)
    if cfg.encdec:  # the audio stub's frame embeddings, encoded once by the prefill
        batch["frames"] = place(rng.standard_normal((b, cfg.frontend_len, cfg.d_model)),
                                torch.float32)

    prefill = make_prefill_step(model)
    step = make_decode_step(model, sample=args.sample)
    kept: list = []

    def decode(params, tokens, cache, generator):
        if not keep:
            return step(params, tokens, cache, generator)
        logits, cache = model.forward(params, {"tokens": tokens}, cache=cache)
        kept.append(logits[:, -1])
        return greedy(logits[:, -1]), cache

    generator = torch.Generator(device=dev).manual_seed(1)
    if keep and args.sample:
        raise ValueError("run_static(keep=True) keeps greedy runs' logits only")
    with sharding.activate(mesh, rules) if mesh is not None else contextlib.nullcontext():
        cache = model.init_cache(b, max_len, seq_shard=seq_shard)
        _sync(dev)
        t0 = time.time()
        logits, cache = prefill(params, batch, cache)
        nxt = greedy(logits[:, -1])
        if keep:
            kept.append(logits[:, -1])
        _sync(dev)
        t_prefill = time.time() - t0
        toks = [nxt]
        t0 = time.time()
        for i in range(args.gen - 1):
            fed = forced[i] if i < len(forced) else nxt
            nxt, cache = decode(params, fed, cache, generator if args.sample else None)
            toks.append(nxt)
        _sync(dev)
        t_decode = time.time() - t0
        out = dist.gather(torch.cat(toks, dim=1)).numpy()  # a collective under a mesh
        result = {"tokens": out, "prefill_s": t_prefill, "decode_s": t_decode}
        if keep:
            result["logits"] = [dist.gather(t).to(torch.float32) for t in kept]
            result["cache"] = cache
    tput = b * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] prefill {args.prompt_len} toks x{b}: {t_prefill:.2f}s; "
          f"decode {args.gen - 1} steps: {t_decode:.2f}s ({tput:.1f} tok/s)")
    print("[serve] sample output ids:", out[0, :16])
    return result


if __name__ == "__main__":
    main()

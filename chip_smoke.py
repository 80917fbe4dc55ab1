#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from `src/repro_torch/csrc/` (one nvcc per
source, in parallel), then, failing loudly (non-zero exit) at the first
phase that goes wrong:

1. prints the card's name and power limit, the torch/CUDA versions and
   the TF32 switches;
2. times the kernel build;
3. parity: each of the six kernels against its plain torch version on the
   card, at its path's shapes and at ragged ones — K1-K4 exact (K1/K2 also
   at every width residue mod 4 on either side of a 128-column strip, at
   heights and depths on either side of their runs, from an unaligned
   base, and on codes beyond 2^24 and beyond int32, +-inf and NaN), K5/K6 with
   equal bits and recon bit for bit (all three transforms, blocks whose
   maximum is an exact power of two, and the edge fields: maxima above
   2^127, subnormals, zeros, inf and NaN, clamped steps, m >= 2^24) — with
   its median time, the plain version's time, the bound, for K3/K4 the
   time of the one PyTorch call that computes the same function, and for
   K5/K6 the time on one block (the launch's fixed cost);
4. the main path: CESM-ATM-like 1800x3600 fields and the first
   Hurricane-like 100x500x500 fields that Algorithm 1 gives to SZ and to
   ZFP (`benchmarks/common.py`) through `compress(...,
   Policy.fixed_accuracy(eb_rel=1e-4), device_encode=True)` and
   `decompress`, asserting that the SZ fields ran K1 (2-D) and K2 (3-D),
   that a ZFP field is among them, that no field's device encode was
   declined and that every decoded value is within eb_abs;
5. `ops.lorenzo_decode` (K3/K4) on the main path's SZ fields, from the
   K1/K2 codes at their eb_sz, within eb + 4 spacing(max|x|);
6. the warm path (`[warm]`): `select_many` with a `DecisionCache` on the 17
   paper-sized fields in three calls (cold: all miss; identical: all hit,
   equal to the cold decisions; one field times 1000 and one nudged by an
   ulp: exactly those two invalidated), then `solve_many` under
   fixed_ratio(8) the same way, and with ``warm_start=True``;
7. warm checkpoint saves at full width (`[ckpt]`): the pytree phase's
   16-leaf tree through `CheckpointManager(CheckpointConfig(dir,
   cache=True, device_encode=True, workers=4))` at steps 0-2 (cold,
   identical, perturbed), with each save's ms, bytes, ratio and cache
   events, K1 and K2 launched and no decline; `restore_tree` of step 2
   without the two Hurricane lossy leaves (`CKPT_UNDECODED`: the host
   decoder's minutes) within each lossy leaf's bound and raw leaves bit
   for bit; a raw step carrying the same cache, a fresh
   manager's restore of it and all-hit save; `async_save` + `wait`;
   `workers=0` writing step 1's `data.bin` again;
8. the quality targets (fixed_psnr 60, fixed_ratio 8, fixed_ssim 0.97,
   fixed_correlation 0.995, fixed_ks 0.1): `solve_many` on the 17
   paper-sized fields under each mode beside `select_many` (one
   `[targets]` line a mode); `compress(..., device_encode=True)` and
   `decompress` round trips at full width (`[targets-rt]`: an ATM field
   within 1 dB of 60 dB, an ATM and a Hurricane SZ field within 10% of
   ratio 8); `compress_pytree` under a `PolicySet` with a rule per mode,
   every decoded leaf within its contract; K1 and K2 launched from it;
9. CPU against card at reduced sizes: decisions within the golden-suite
   tolerances and container bytes equal for the same `Selection`, and the
   target solves under each mode within the CPU parity suite's;
10. the KV page tier at the full width of phi4-mini-3.8b (32 layers, 8 KV
   heads of 128): one 2048-token request's bf16 K and V arenas on the
   card, every page stack evicted through `compress_page` under the
   serving policy (fixed_ratio 8, K6), restored with `decompress_page`,
   and evicted again (all decision-cache hits); eight flat (2048, 1024)
   pages through `bot_compress_kv` (K5); four stacks through the device
   encoder and four raw;
11. serving at the full width of phi4-mini-3.8b, weights drawn on the
   card from a generator seeded 0: `[serve-static]` runs
   `launch.serve.main` on the contiguous cache (batch 4, prompt 64, gen
   32); `[serve]` runs `run_continuous` (8 requests, prompts of 1024 and
   256 tokens, 64 new tokens each, Poisson arrivals at 0.25 per decode
   step, 4 slots, 16-token pages, `serving_policies(8.0)` with the long
   threshold at 512, an arena of `SERVE_ARENA_PAGES` pages), checking that
   every request completes with 64 tokens, that the arena evicts and
   restores, that long requests resolve to fixed_ratio and short ones to
   raw, that every restored lossy stack is within its bound of a copy
   taken at evict time, and that K6 ran the evictions; `[serve-raw]`
   runs the same requests under `Policy.raw()` on the default arena and
   on the small one, whose token streams must be equal; then the MoE and
   MLA decoders at their full published width, depth cut to fit the card:
   `[serve-moe]` serves llama4-scout-17b-a16e (4 of 48 layers) with a
   static prefill + decode and `[serve]`'s continuous traffic under the
   same checks (its lossy page stacks, (4, 16, 1024), evict through K6);
   `[serve-mla]` serves deepseek-v2-236b (the dense layer and 2 MoE layers
   of 60) with a static prefill + decode and the legacy contiguous
   batcher, 4 requests on 2 slots, each stream equal to the prompt decoded
   alone; both check `apply_moe` bit for bit across two runs;
   `[moe-mla-cpu-vs-card]` holds the reduced models on the card to the CPU
   (float32 logits without a cache, then a cached prefill and 8 decode
   steps); then the recurrent families at their full published width and
   depth, which have no paged cache: `[serve-hybrid]` serves zamba2-1.2b
   (38 Mamba2 layers, SSD chunk 256, the shared attention after each
   group of 6) and `[serve-xlstm]` xlstm-1.3b (6 groups of 7 mLSTM + 1
   sLSTM), each with a static prefill + decode (batch 4, prompt 64, gen
   32) and the legacy contiguous batcher (4 requests of 64/300/64/300
   tokens on 2 slots, 16 new each), every stream equal to its prompt
   decoded alone; `[recurrent-cpu-vs-card]` holds their reduced models on
   the card to the CPU as `[moe-mla-cpu-vs-card]` does;
12. training at the full width and depth of smollm-360m (409.0 M float32
   parameters drawn on the card from a generator seeded 0): `[train]` runs
   `launch.train.main` for 20 steps (batch 8 of 256 tokens) with
   error-feedback gradient compression and raw checkpoints every 10
   steps, and prints step ms, tokens/s, peak memory, the losses (which
   must fall) and the wire bits; every leaf of one step's compression is
   held to its contract (the dequantized gradient k * delta and the fused
   residual bit for bit against their plain form, |k * delta - g'| <= eb);
   `--resume --steps 25` must restore step 20 bit for bit and give finite
   losses; then one lossy save of the trained params under
   fixed_accuracy(1e-4) with the device encoders is timed (ms, bytes,
   ratio, codecs, and the device encoder's declines: the full-depth MLP
   stacks overflow the ZFP device encoder's int32 stream offsets, and the
   host coder takes them; not restored: the host Huffman decoder would
   take minutes). `[train-ckpt]` runs the launcher at the --smoke size with
   `--compress-ckpt --ckpt-opt-ratio 8`: each restored params leaf within
   1e-4 of its value range, the optimizer leaves under fixed_ratio, and a
   resume. `[train-cpu-vs-card]` takes 5 reduced float32 steps from the
   same weights on the CPU and the card (losses within
   `TRAIN_CARD_LOSS_RTOL`) and compresses the same gradients on both
   (bit for bit);
13. the encoder-decoder and the train step of the other families:
   `[serve-encdec]` serves seamless-m4t-large-v2 at full width and depth
   (24 + 24 layers, 2.04 B float32 parameters) through
   `launch.serve.run_static` with 1024 frames (the encoder run once, by
   the prefill) and holds its cached decode of 8 tokens to the parallel
   forward within 5e-2 * max|logit|; `[train-hybrid]` trains zamba2-1.2b
   at full width and depth through `launch.train.main` with gradient
   compression (10 steps of 8 x 256 tokens, one step's every leaf held to
   its contract), `[train-xlstm]` xlstm-1.3b without (5 steps of 4 x 256),
   `[train-encdec]` seamless-m4t-large-v2 through `make_train_step` with
   gradient compression (5 steps of 4 x 256 tokens and 1024 frames); the
   losses must fall; `[train-zoo-cpu-vs-card]` holds the loss and every
   gradient of the reduced llama4-scout, deepseek-v2, zamba2-1.2b,
   xlstm-1.3b and seamless-m4t-large-v2 on the card to the CPU's and
   prints whether the MoE gradients agree bit for bit across two card
   runs;
14. scale-out (`[sharded]`, after the target phases): four ranks on the
   card through `launch/mhrun.py` over gloo, a (2, 2) ('data', 'model')
   mesh, each rank mapping only its shards of the 17 paper fields, two
   512^3 NYX volumes (made first, one process a volume) and a
   replicated leaf onto the card; `plan_tree` under samples and stats at
   eb_rel 1e-4 and fixed_psnr(60) against the unsharded `select_many` /
   `solve_many` on the card (samples equal, stats within the golden
   tolerances, the same on every rank; the gathered fields named), with
   the gloo staging timed alone; a cooperative
   `CheckpointConfig(sharded=True, device_encode=True)` save (per-host
   files, commit markers, the v3 manifest, K1/K2 counted on every rank);
   an elastic `restore_tree` of ATM_00, ATM_03 and the leaf under (4, 1)
   within eb; smollm-360m's params and AdamW moments laid out by
   `TRAIN_RULES`, saved raw and restored under (1, 4) bit for bit; and
   K1/K2 at the shard shapes (`[sharded-kernels]`);
15. serving under a mesh (`[mesh-serve]`, after `[sharded]`):
   phi4-mini-3.8b at full width and 4 of its 32 layers served unsharded on the card
   (`launch.serve.run_static`: a prefill of 4 x 64 tokens and 16 greedy
   decode steps), then by four ranks over gloo on a (2, 2) ('data',
   'model') mesh through `run_static(mesh=)` under `SERVE_RULES` (params
   drawn from the same generator, each rank keeping its box; the cache
   laid out by `cache_sharding`): the prefill and 8 decode steps fed the
   unsharded tokens, each step's logits within `MESH_SERVE_RTOL` of
   max|logit| of the unsharded run's, every param and cache leaf on its
   rules' placements, the gathered cache within the same bound; then 8
   greedy steps (the tokens that differ printed with the unsharded top-2
   margin); prefill and decode ms beside the unsharded run's, the
   collectives of a prefill and of a decode step by kind, one decode step
   traced on rank 0, the peak memory of each rank. No kernel runs here;
16. training under a mesh (`[mesh-train]`, after `[mesh-serve]`):
   smollm-360m at full width and 4 of its 32 layers trained unsharded on the card
   (`launch.train.main`, 2 steps of 8 x 256 tokens with gradient
   compression), then by four ranks over gloo on a (2, 2) ('data',
   'model') mesh through `launch.train.run(mesh=)` under `TRAIN_RULES`
   (FSDP over 'data', TP over 'model'; params from the same generator,
   each rank keeping its box): the same steps with an `async_save` after
   the last and the final save, each step's loss within `MESH_TRAIN_RTOL`
   of the unsharded run's; a restore of that step under the mesh equal
   to the trained state bit for bit; a resumed run whose first loss is
   the unsharded params' loss on the same batch, within the same bound;
   each rank's step ms beside the unsharded step's, the collectives of
   one step by kind, the peak memory of each rank. No kernel runs here;
   the phase prints, in bytes, why llama4-scout and deepseek-v2 are not
   trained at full width (`MESH_TRAIN_NOT_RUN`);
17. the MoE and MLA decoders under a mesh (`[mesh-moe]`, after
   `[mesh-train]`): deepseek-v2-236b at full width and 2 of its 60 layers
   (the leading dense layer in `dense_blocks` and one MoE layer of 160
   experts, top-6, 2 shared, both MLA) served as 15 serves phi4-mini:
   unsharded, then four ranks on (2, 2) under `SERVE_RULES` (the experts
   and heads split over 'model', the routing global over the batch's
   split), each forced step's logits within `MESH_SERVE_RTOL`, every param
   and cache leaf (the MLA latent too) on its placements, the gathered
   caches within the bound, the share of tokens whose experts differ from
   the unsharded run at the forced steps. No kernel runs here;
18. the other families under a mesh (`[mesh-families]`, after
   `[mesh-moe]`): internvl2-76b (2 of 80 layers, 256 patch embeddings),
   seamless-m4t-large-v2 (2 + 2 of 24 + 24 layers, 1024 frames),
   zamba2-1.2b and xlstm-1.3b (8 layers each) at full width, each served
   unsharded, then ONE four-rank job on (2, 2) under `SERVE_RULES`
   serving each in turn as 15 serves phi4-mini: the prefill's and forced
   steps' logits within `MESH_SERVE_RTOL`, every param and cache leaf on
   its placements, the gathered caches (K/V, the Mamba2 and mLSTM/sLSTM
   states and conv windows, the encoder memory) within the bound, decode
   ms beside the unsharded run's, the collectives of a decode step, the
   peak of each rank. No kernel runs here;
19. the dry run's cache variants under a mesh (`[mesh-cache]`, after
   `[mesh-families]`): phi4-mini-3.8b (4 of 32 layers) with the int8 KV
   cache, and smollm-360m at full depth (15 query and 5 KV heads: no
   head dim divides 'model') with its cache split along its sequence
   (256 rows over 'model'), alone and with the int8 cache, each served
   unsharded, then ONE four-rank job on (2, 2) under `SERVE_RULES` as 18
   serves its models: logits within `MESH_SERVE_RTOL`, every leaf on its
   placements, the K/V leaves' sequence dim asserted Shard where the case
   splits it, the gathered caches (the int8 cache as codes x scale) within
   the bound, decode ms beside the unsharded run's, the collectives of a
   decode step, the peak of each rank. No kernel runs here;
20. the dry-run launcher (`[dryrun]`): the production cells of
   `DRYRUN_CELLS`, traced in the background from the start of the run
   (`python -m repro_torch.launch.dryrun` on fake tensors over a fake
   group of 256 or 512 ranks, full width and depth), each reporting ok or
   the reference's SKIP(full-attn), with its roofline terms, dominant
   term, useful-FLOPs ratio, argument MB and trace seconds; and its
   calibration on the card: smollm-360m decode_32k at one layer unit
   counted on fake tensors over a one-rank (1, 1) mesh, then run for real
   (FLOPs and argument bytes equal exactly, the `MemTracker` peak within
   `DRYRUN_PEAK_RTOL` of the card's), its ms beside the roofline's times.
   No kernel runs here;
21. one JSON line with every kernel's launches on its path, error, times,
   bound and library time.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits non-zero before printing any result.

    python3 chip_smoke.py --bot-times [--src OTHER_CHECKOUT/src]

only builds the kernels and prints the K5/K6 times of `bot_times` as one
JSON line, for the `repro_torch` under --src: run it on two checkouts in
turns (parent, change, change, parent) to compare them on one card.

    python3 chip_smoke.py --lorenzo-times [--src OTHER_CHECKOUT/src]

does the same for K1/K2 (`lorenzo_times`), and `--kv-times` for the KV
page tier's evict and restore (`kv_times`). `--serve` runs only the
phi4-mini serving phases of 11, `--moe-mla` only the MoE and MLA ones,
`--recurrent` only the zamba2-1.2b and xlstm-1.3b ones,
and `--decode-profile [ARCH]` traces full-width decode steps of
phi4-mini-3.8b or ARCH (`decode_profile`). `--train` runs only the training phases (12),
`--zoo` only the phases of 13, `--sharded` only the phase of 14 (with the
fields it needs), `--mesh-serve`, `--mesh-train`, `--mesh-moe`,
`--mesh-families`, `--mesh-cache` and `--dryrun` only the phases of 15,
16, 17, 18, 19 and 20, and `--train-profile` traces three full-width
train steps (`train_profile`).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the
#: tensor cores FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
EB_REL = 1e-4
#: golden-suite decision tolerances (tests/test_golden_decisions.py)
EB_SZ_RTOL = 1e-5
BR_ATOL = 5e-3
RAGGED_2D = [(300, 517), (8, 128), (4, 40)]
RAGGED_3D = [(7, 64, 64), (4, 4, 129)]
#: the BOT kernels' edge fields: every residue mod 4 on each axis
EDGE_2D = [(300, 517), (301, 518), (302, 519), (303, 516)]
EDGE_3D = [(5, 6, 7), (6, 7, 4), (7, 5, 6), (4, 4, 129)]
EDGE_KINDS = ["big", "tiny", "zero", "inf", "-inf", "nan"]
K1_SHAPES = [(1800, 3600), (300, 517), (8, 128), (4, 40), (1, 5)]
K2_SHAPES = [(100, 500, 500), (7, 64, 64), (4, 4, 129)]
#: K1/K2 edge cases: every width residue mod 4 on either side of a lane
#: strip of 128 columns, and a wide row of 4097; the values of each kind
#: (`encode_field`), each also from an unaligned base
ENCODE_WIDTHS = (127, 128, 129, 130, 131)
ENCODE_KINDS = ("beyond_2p24", "beyond_int32", "non_finite")
#: --lorenzo-times: the path shapes and one small shape (one run of one
#: strip)
K1_SMALL, K2_SMALL = (32, 128), (25, 4, 128)
#: phi4-mini-3.8b (src/repro/configs/phi4_mini_3_8b.py): 32 layers, 8 KV
#: heads, head dim 3072/24 = 128; the batcher's default page of 16 tokens
N_LAYERS, N_KV_HEADS, HEAD_DIM, PAGE_TOKENS = 32, 8, 128, 16
REQUEST_TOKENS = 2048
KV_RATIO = 8.0
#: the path shapes of the KV kernels: a cross-layer page stack (K6) and one
#: layer's K of the request as a flat page (K5)
K6_PATH_SHAPE = (N_LAYERS, PAGE_TOKENS, N_KV_HEADS * HEAD_DIM)
K5_PATH_SHAPE = (REQUEST_TOKENS, N_KV_HEADS * HEAD_DIM)
#: the serving phases (`launch.serve` flags): phi4-mini-3.8b at full width
SERVE_ARCH = ["--arch", "phi4-mini-3.8b"]
SERVE_STATIC = ["--batch", "4", "--prompt-len", "64", "--gen", "32"]
SERVE_CONTINUOUS = ["--continuous", "--requests", "8", "--prompt-len", "1024", "--gen", "64",
                    "--rate", "0.25", "--slots", "4", "--page-tokens", "16",
                    "--long-threshold", "512", "--target-ratio", "8.0"]
#: The page schedule depends only on the prompt lengths, the arrivals and
#: the arena (no token is EOS), so a CPU run of `run_continuous` at any
#: width gives it (tests/test_torch_batcher.py::test_full_width_serving_
#: schedule): with 136 pages (twice a 1088-token context) nothing is
#: evicted, since admission waits for free pages; 84 evicts nine times and
#: reuses 554 frozen pages.
SERVE_ARENA_PAGES = 84
KERNELS = {  # name: (TPU kernel it replaces, CUDA source)
    "lorenzo2d_encode": ("src/repro/kernels/lorenzo.py:54", "src/repro_torch/csrc/lorenzo.cu"),
    "lorenzo3d_encode": ("src/repro/kernels/lorenzo.py:143", "src/repro_torch/csrc/lorenzo.cu"),
    "dequantize2d": ("src/repro/kernels/lorenzo.py:188", "src/repro_torch/csrc/lorenzo.cu"),
    "dequantize3d": ("src/repro/kernels/lorenzo.py:218", "src/repro_torch/csrc/lorenzo.cu"),
    "bot2d_fused": ("src/repro/kernels/bot4.py:71", "src/repro_torch/csrc/bot4.cu"),
    "bot3d_fused": ("src/repro/kernels/bot4.py:152", "src/repro_torch/csrc/bot4.cu"),
}
#: float32 operations per value. Lorenzo encode: a division and a
#: rounding, then the 2^nd - 1 additions of the n-D difference. Dequantize:
#: one multiply. BOT: the transform pair, 7 operations (4 multiplies, 3
#: adds) per output per axis, forward and inverse (14 * nd per value), and
#: 13 elementwise ones (abs and max, the scaling, |c| / step, trunc, the
#: n_sb count and sums, (m + 0.5) * step, the sign, the final division).
OPS_PER_VALUE = {
    "lorenzo2d_encode": 2 + 3, "lorenzo3d_encode": 2 + 7,
    "dequantize2d": 1, "dequantize3d": 1,
    "bot2d_fused": 14 * 2 + 13, "bot3d_fused": 14 * 3 + 13,
}


def bound(name: str, shape) -> tuple[float, str]:
    """The least time (ms) the card could take for one call, and what sets
    it: each input read once and each output written once over the HBM
    rate (4 B in and 4 B out per value; the BOT kernels also write one
    4-byte bits value per block), against the operations over the float32
    peak."""
    numel = math.prod(shape)
    nbytes = numel * (4 + 4)
    if name.startswith("bot"):
        nbytes += 4 * math.prod(-(-s // 4) for s in shape)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = numel * OPS_PER_VALUE[name] / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(tag: str, msg) -> None:
    print(f"[{tag}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


#: clock cycles the card spins before each timed call (~10 ms on an H100),
#: longer than the host needs to enqueue any call timed here
SPIN_CYCLES = 20_000_000


def time_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median device time of `fn` over `reps` launches, each timed with CUDA
    events after overwriting a buffer larger than L2 (cold cache). The card
    spins (`torch.cuda._sleep`) between the flush and the start event, so
    the host has enqueued all of `fn`'s work before the start event runs:
    the events time the device's work, not the host's launch overhead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tie_field(np, shape, seed):
    """A seeded random walk along the last axis, with exact half-bin ties
    planted: x = (k + 0.5) * delta for a power-of-two delta."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    eb = 2.0 ** np.floor(np.log2(1e-3 * float(x.max() - x.min()) + 1e-30))
    flat = x.reshape(-1)
    ties = rng.integers(0, flat.size, size=max(1, flat.size // 50))
    flat[ties] = (np.round(flat[ties] / (2 * eb)) + 0.5) * (2 * eb)
    return x, float(eb)


def encode_field(np, shape, kind, seed):
    """(x, eb) for K1/K2: "ties", `tie_field`; "beyond_2p24" and
    "beyond_int32", N(0, 3e7) and N(0, 1e9) values at eb 0.5, whose codes
    and differences pass 2^24 (the float32 difference rounds) and the int32
    range (the cast saturates); "non_finite", `tie_field` with +inf, -inf
    and NaN on the first and last rows, columns and planes and inside."""
    rng = np.random.default_rng(seed)
    if kind in ("beyond_2p24", "beyond_int32"):
        sigma = 3e7 if kind == "beyond_2p24" else 1e9
        return rng.normal(0.0, sigma, shape).astype(np.float32), 0.5
    x, eb = tie_field(np, shape, seed)
    if kind == "non_finite":
        spots = [tuple(0 for _ in shape), tuple(s - 1 for s in shape)]
        spots += [tuple(int(rng.integers(0, s)) if a != axis else edge
                        for a, s in enumerate(shape))
                  for axis in range(len(shape)) for edge in (0, shape[axis] - 1)]
        spots += [tuple(int(rng.integers(0, s)) for s in shape) for _ in range(4)]
        for i, spot in enumerate(spots):
            x[spot] = (np.inf, -np.inf, np.nan)[i % 3]
    return x, eb


def lorenzo_runs() -> dict:
    """The run and strip sizes of the `repro_torch` in use
    (`csrc/lorenzo.cu`), whose edges the parity cases straddle."""
    import re

    from repro_torch.kernels import _build

    src = _build.SOURCES["lorenzo"].read_text()
    found = {k: re.search(rf"constexpr int {k} = (\d+);", src) for k in ("kRun2D", "kRows3D", "kRun3D")}
    return {k: int(m.group(1)) for k, m in found.items() if m}


def encode_edge_shapes(ndim: int) -> list:
    runs = lorenzo_runs()
    if ndim == 2:
        r = runs["kRun2D"]
        return [(5, w) for w in ENCODE_WIDTHS] + [(3, 4097)] + [(h, 132) for h in (r - 1, r, r + 1)]
    z, h = runs["kRun3D"], runs["kRows3D"]
    return ([(3, 5, w) for w in ENCODE_WIDTHS] + [(2, 3, 4097)]
            + [(d, 5, 128) for d in (z - 1, z, z + 1)] + [(3, y, 132) for y in (h - 1, h, h + 1)])


def on_card(torch, x, dev, unaligned: bool):
    """x on the card, contiguous; with `unaligned`, at a 4-byte offset into
    its buffer (not 16-byte aligned)."""
    t = torch.from_numpy(x).to(dev)
    if not unaligned:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def phase_parity(torch, np, dev, flush):
    from repro_torch.kernels import lorenzo, ref

    results = {}
    for name, shapes in (("lorenzo2d_encode", K1_SHAPES), ("lorenzo3d_encode", K2_SHAPES)):
        kernel = getattr(lorenzo, name)
        cases = [(shape, "ties") for shape in shapes]
        cases += [(shape, kind) for shape in encode_edge_shapes(len(shapes[0]))
                  for kind in ("ties",) + ENCODE_KINDS]
        worst = 0
        for i, (shape, kind) in enumerate(cases):
            x, eb = encode_field(np, shape, kind, 10 + i)
            for unaligned in (False, True):
                xt = on_card(torch, x, dev, unaligned)
                got = kernel(xt, eb)
                want = ref.lorenzo_encode_ref(xt, eb)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                check(err == 0, f"{name} differs from its plain version at {shape} {kind}"
                      f"{' unaligned' if unaligned else ''}: {err}")
                worst = max(worst, err)
        x, eb = tie_field(np, shapes[0], 99)
        xt = torch.from_numpy(x).to(dev)
        # the plain version gets the bound as a tensor already on the card,
        # so that no host-to-device copy synchronises inside the timing
        eb_dev = torch.tensor(eb, dtype=torch.float32, device=dev)
        ms = time_ms(torch, lambda: kernel(xt, eb), flush)
        plain_ms = time_ms(torch, lambda: ref.lorenzo_encode_ref(xt, eb_dev), flush)
        bound_ms, bound_by = bound(name, tuple(xt.shape))
        results[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        log("parity", f"{name}: exact on {len(cases)} fields, each aligned and unaligned "
            f"(ties at {shapes}; {('ties',) + ENCODE_KINDS} at "
            f"{encode_edge_shapes(len(shapes[0]))}); {list(shapes[0])}: {ms} ms "
            f"(plain {plain_ms} ms, bound {bound_ms} ms by {bound_by})")
    return results


def pow2_max_field(np, shape, seed):
    """Every 4-block's largest magnitude an exact power of two (the knife
    edge of ceil(log2 max|b|)), signs mixed, ragged edges included."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    k = rng.integers(-6, 7, size=tuple(-(-s // 4) for s in shape))
    scale = np.ldexp(1.0, k)
    for axis in range(len(shape)):
        scale = np.repeat(scale, 4, axis=axis)
    scale = scale[tuple(slice(0, s) for s in shape)]
    x = x * scale
    corner = tuple(slice(0, None, 4) for _ in shape)
    x[corner] = np.where(x[corner] < 0, -1.0, 1.0) * scale[corner]
    return x.astype(np.float32)


def kv_values(np, shape, seed):
    """KV-cache-like values (layers, tokens, channels): a random walk along
    tokens, scaled to O(1), times a per-(layer, channel) lognormal scale
    standing in for the outlier channels of real K caches."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.standard_normal(shape, dtype=np.float32), axis=-2, dtype=np.float32)
    walk *= np.float32(1.0 / np.sqrt(shape[-2]))
    walk *= np.exp(rng.standard_normal(shape[:-2] + (1, shape[-1]))).astype(np.float32)
    return walk


def phase_parity_dequantize(torch, np, dev, flush, results):
    """K3/K4 exact against float32(k) * 2eb, at the decode path's shapes and
    at ragged ones; timed beside `torch.mul(k, delta)`, the one PyTorch call
    that computes the same function."""
    from repro_torch.kernels import lorenzo, ref

    for name, shapes in (("dequantize2d", [(1800, 3600)] + RAGGED_2D),
                         ("dequantize3d", [(100, 500, 500)] + RAGGED_3D)):
        kernel = getattr(lorenzo, name)
        for i, shape in enumerate(shapes):
            rng = np.random.default_rng(30 + i)
            k = torch.from_numpy(rng.integers(-(2**30), 2**30, size=shape, dtype=np.int32)).to(dev)
            eb = float(rng.uniform(1e-5, 1.0))
            got = kernel(k, eb)
            want = ref.dequantize_ref(k, eb)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} differs from its plain version at {shape}")
        k = torch.from_numpy(np.random.default_rng(39).integers(
            -(2**20), 2**20, size=shapes[0], dtype=np.int32)).to(dev)
        eb = 1.2345e-3
        eb_dev = torch.tensor(eb, dtype=torch.float32, device=dev)
        delta = ref._delta(eb_dev, dev)  # 0-dim float32 on the card
        check(torch.equal(torch.mul(k, delta), kernel(k, eb)), f"{name}: torch.mul differs")
        ms = time_ms(torch, lambda: kernel(k, eb), flush)
        plain_ms = time_ms(torch, lambda: ref.dequantize_ref(k, eb_dev), flush)
        library_ms = time_ms(torch, lambda: torch.mul(k, delta), flush)
        bound_ms, bound_by = bound(name, shapes[0])
        results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
        log("parity", f"{name}: exact at {shapes}; {list(shapes[0])}: {ms} ms (plain "
            f"{plain_ms} ms, torch.mul {library_ms} ms, bound {bound_ms} ms by {bound_by})")


def edge_field(np, shape, kind, seed):
    """A uniform field in which about half the 4-blocks (the first always)
    hold one edge of the BOT kernels' arithmetic: "big", maxima in
    (2^127, FLT_MAX] (e = 128; FLT_MAX itself in the first block); "tiny",
    magnitudes from 1e-30 down into the subnormals (the 1e-30 floor of the
    block max); "zero", all zeros; "inf", "-inf", "nan", that value first
    in the block."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    pick = rng.random(tuple(-(-s // 4) for s in shape)) < 0.5
    pick.flat[0] = True
    mask = pick
    for axis in range(len(shape)):
        mask = np.repeat(mask, 4, axis=axis)
    mask = mask[tuple(slice(0, s) for s in shape)]
    if kind == "big":
        x = np.where(mask, x * (1.99 * 2.0**127), x)
        x[(0,) * len(shape)] = np.finfo(np.float32).max
    elif kind == "tiny":
        x = np.where(mask, x * 10.0 ** rng.uniform(-45.0, -30.0, shape), x)
    elif kind == "zero":
        x = np.where(mask, 0.0, x)
    else:
        corner = tuple(slice(0, None, 4) for _ in shape)
        x[corner] = np.where(pick, float(kind), x[corner])
    return x.astype(np.float32)


def edge_ebs(np, x):
    """Bounds that reach the other edges on an edge field: a usual one; one
    that makes coefficients m >= 2^24; 1e-25, where raw clamps to 2^-60 on
    O(1) blocks; 1e-37, where the tiny blocks keep planes and reconstruct
    into the subnormals; 1e30, where raw overflows to inf on zero and tiny
    blocks."""
    fin = x[np.isfinite(x)].astype(np.float64)
    r = float(fin.max() - fin.min())
    return [1e-3 * r, 1e-9 * r, 1e-25, 1e-37, 1e30]


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (so -0.0 differs from 0.0), any NaN equal to any NaN."""
    a, b = (torch.where(t.isnan(), float("nan"), t).view(torch.int32) for t in (a, b))
    return torch.equal(a, b)


def bot_path_case(torch, np, dev, shape):
    """K5's or K6's input on the KV path: KV-like values at its path shape
    on the card, the bound fixed_ratio(8) solves there, and the first
    4-block alone."""
    from repro_torch.core.policy import Policy
    from repro_torch.runtime import kvcomp

    page = torch.from_numpy(kv_values(np, shape, 60)).to(dev)
    eb = kvcomp._policy_eb(page, kvcomp._value_range(page), Policy.fixed_ratio(KV_RATIO))
    return page, eb, page[tuple(slice(0, 4) for _ in shape)].contiguous()


def phase_parity_bot(torch, np, dev, flush, results):
    """K5/K6 against their plain versions: bits equal and recon bit for bit
    (the largest difference is printed), at the KV path's shapes and at
    ragged ones, for zfp, hwt and dct2, on random walks and on blocks whose
    maximum is an exact power of two; and on the edge fields at every
    residue mod 4 of each axis under the edge bounds. Timed at the path's
    shape on KV-like values at the bound fixed_ratio(8) solves there, and
    on one block (the launch's fixed cost)."""
    from repro_torch.kernels import bot4, ref

    for name, shapes, edge_shapes in (
        ("bot2d_fused", [K5_PATH_SHAPE] + RAGGED_2D, EDGE_2D),
        ("bot3d_fused", [K6_PATH_SHAPE] + RAGGED_3D, EDGE_3D),
    ):
        kernel = getattr(bot4, name)
        cases = []
        for i, shape in enumerate(shapes):
            rng = np.random.default_rng(40 + i)
            walk = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
            for x in (walk, pow2_max_field(np, shape, 50 + i)):
                cases.append((f"{shape} {'walk' if x is walk else 'pow2max'}", x,
                              [1e-3 * float(x.max() - x.min())]))
        for i, shape in enumerate(edge_shapes):
            for kind in EDGE_KINDS:
                x = edge_field(np, shape, kind, 80 + i)
                cases.append((f"{shape} {kind}", x, edge_ebs(np, x)))
        worst = 0.0
        for label, x, ebs in cases:
            xt = torch.from_numpy(x).to(dev)
            for eb in ebs:
                for transform in ("zfp", "hwt", "dct2"):
                    recon, bits = kernel(xt, eb, transform)
                    want_r, want_b = ref.bot_fused_ref(xt, eb, transform)
                    torch.cuda.synchronize()
                    where = f"{label} eb={eb} {transform}"
                    check(torch.equal(bits, want_b), f"{name} bits differ from the plain version at {where}")
                    check(same_bits(torch, recon, want_r),
                          f"{name} recon differs from the plain version at {where}")
                    both = torch.isfinite(recon) & torch.isfinite(want_r)
                    worst = max(worst, float(torch.where(both, recon - want_r, 0.0).abs().max()))
        page, eb, block = bot_path_case(torch, np, dev, shapes[0])
        ms = time_ms(torch, lambda: kernel(page, eb), flush)
        plain_ms = time_ms(torch, lambda: ref.bot_fused_ref(page, eb), flush)
        block_ms = time_ms(torch, lambda: kernel(block, eb), flush)
        bound_ms, bound_by = bound(name, shapes[0])
        results[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
        log("parity", f"{name}: bits equal and recon bit for bit on {len(cases)} fields "
            f"(walks and power-of-two-max blocks at {shapes}; {EDGE_KINDS} blocks at "
            f"{edge_shapes}; zfp, hwt, dct2); largest recon difference {worst}; "
            f"{list(shapes[0])}: {ms} ms (plain {plain_ms} ms, bound {bound_ms} ms by "
            f"{bound_by}); one block {list(block.shape)}: {block_ms} ms")


#: the field names of `benchmarks.common`'s Hurricane and NYX suites
HURRICANE_NAMES = ("QICE", "PRECIP", "U", "V", "W", "P", "T", "QVAPOR", "QCLOUD", "QRAIN",
                   "QSNOW", "QGRAUP", "CLOUD")
NYX_NAMES = ("baryon_density", "dark_matter_density", "temperature", "velocity_x",
             "velocity_y", "velocity_z")


def suite_fields(suite: str, n: int) -> list:
    """(name, slope, seed, nonlinearity): the `_spectral_field` call that
    `benchmarks.common.hurricane_suite(n)` or `nyx_suite(n)` makes for
    each of its fields, in its order (`check_suite_fields` holds them to
    the suite)."""
    if suite == "hurricane":
        return [(f"{HURRICANE_NAMES[i % 13]}_{i}", -4.0 + 2.0 * i / max(n - 1, 1), 200 + i,
                 "relu" if HURRICANE_NAMES[i % 13].startswith("Q") else None) for i in range(n)]
    return [(NYX_NAMES[i], -2.8, 300 + i,
             "exp" if "density" in NYX_NAMES[i] or "temperature" in NYX_NAMES[i] else None)
            for i in range(n)]


def check_suite_fields(np, suite: str, n: int) -> None:
    """`suite_fields` drawn at a small size equal the suite's own fields."""
    import benchmarks.common as c

    size = (4, 8, 8)
    want = getattr(c, f"{suite}_suite")(n, size=size)
    got = {name: c._spectral_field(size, slope, seed, nl)
           for name, slope, seed, nl in suite_fields(suite, n)}
    check(list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in want),
          f"suite_fields('{suite}', {n}) differ from the suite's fields")


def start_suite_fields(suite: str, n: int, size: tuple, out: Path, prefix: str = "") -> list:
    """Start one process a field of `suite_fields(suite, n)` at `size`, each
    drawing it with `benchmarks.common._spectral_field` and writing it to
    `out` as `{prefix}{name}.npy`."""
    code = (
        "import sys, json, numpy as np; sys.path.insert(0, sys.argv[1]);"
        "from benchmarks.common import _spectral_field;"
        "size, name, slope, seed, nl = json.loads(sys.argv[3]);"
        "np.save(f'{sys.argv[2]}/{name}.npy', _spectral_field(tuple(size), slope, seed, nl))"
    )
    return [subprocess.Popen([sys.executable, "-c", code, str(ROOT), str(out),
                              json.dumps([list(size), prefix + name, slope, seed, nl])])
            for name, slope, seed, nl in suite_fields(suite, n)]


def paper_fields(np):
    """The paper-sized fields: 4 CESM-ATM-like 1800x3600 and all 13
    Hurricane-like 100x500x500 (`benchmarks/common.py`), ~1.4 GB float32.
    The Hurricane fields are drawn one process a field
    (`start_suite_fields`)."""
    import shutil

    from benchmarks.common import atm_suite

    t0 = time.perf_counter()
    out = ROOT / "build" / "paper_fields"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    check_suite_fields(np, "hurricane", HURRICANE_FIELDS)
    procs = start_suite_fields("hurricane", HURRICANE_FIELDS, (100, 500, 500), out)
    atm = atm_suite(4, size=(1800, 3600))
    for i, proc in enumerate(procs):
        check(proc.wait() == 0, f"Hurricane field {i}: its process exited {proc.returncode}")
    hurricane = {name: np.load(out / f"{name}.npy")
                 for name, *_ in suite_fields("hurricane", HURRICANE_FIELDS)}
    shutil.rmtree(out, ignore_errors=True)
    log("fields", f"generated {len(atm) + len(hurricane)} in {time.perf_counter() - t0:.1f} s")
    return atm, hurricane


#: the Hurricane-like fields of `paper_fields`
HURRICANE_FIELDS = 13


def phase_main(torch, np, dev, atm, hurricane):
    from benchmarks.common import psnr
    from repro_torch.core import Policy, compress, compression_ratio, decompress, select
    from repro_torch.core import device_encode as de
    from repro_torch.kernels import lorenzo

    fields = dict(atm)
    # the 3-D fields: the first Hurricane-like field Algorithm 1 gives to
    # SZ and the first it gives to ZFP, so both 3-D device paths run
    picked = {}
    for name, x in hurricane.items():
        codec = select(x, eb_rel=EB_REL, device=dev).codec
        log("fields", f"HUR_{name}: {codec}")
        if codec in ("sz", "zfp") and codec not in picked:
            picked[codec] = name
            fields[f"HUR_{name}"] = x
        if len(picked) == 2:
            break
    pol = Policy.fixed_accuracy(eb_rel=EB_REL)
    # warm the CUDA context and the code paths before anything is timed
    for shape in ((64, 96), (16, 32, 32)):
        compress(np.random.default_rng(0).standard_normal(shape).astype(np.float32),
                 pol, device_encode=True, device=dev)
    rows = []
    lorenzo.reset_launches()
    de.DECLINES.clear()
    for name, x in fields.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sel = select(x, eb_rel=EB_REL, device=dev)
        t1 = time.perf_counter()
        before = dict(lorenzo.LAUNCHES)
        declined = sum(de.DECLINES.values())
        cf = compress(x, pol, device_encode=True, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = sum(lorenzo.LAUNCHES.values()) - sum(before.values())
        device_encoded = sum(de.DECLINES.values()) == declined and cf.codec != "raw"
        y = decompress(cf, device=dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        yn = y.cpu().numpy()
        eb = cf.selection.eb_abs
        err = float(np.max(np.abs(x.astype(np.float64) - yn.astype(np.float64))))
        row = dict(
            field=name, shape=list(x.shape), codec=cf.codec,
            ratio=compression_ratio(cf), psnr=psnr(x, yn), max_err_over_eb=err / eb,
            select_ms=(t1 - t0) * 1e3, compress_ms=(t2 - t1) * 1e3,
            encode_ms=(t2 - t1 - (t1 - t0)) * 1e3, decompress_ms=(t3 - t2) * 1e3,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            device_encoded=device_encoded, kernel_launches=launches,
            br_sz=cf.selection.br_sz, br_zfp=cf.selection.br_zfp,
        )
        rows.append((row, x, cf))
        log("main", json.dumps(row))
        check(cf.selection.codec == sel.codec, f"{name}: decision changed between calls")
        check(device_encoded, f"{name}: device encode declined or raw")
        check(err <= eb, f"{name}: max |err| {err} exceeds eb_abs {eb}")
        check(cf.codec != "sz" or launches >= 1, f"{name}: SZ field ran no kernel")
    main_launches = dict(lorenzo.LAUNCHES)
    check(sum(de.DECLINES.values()) == 0, f"device encode declined: {dict(de.DECLINES)}")
    kinds = {(r["codec"], len(r["shape"])) for r, _, _ in rows}
    for need in (("sz", 2), ("sz", 3)):
        check(need in kinds, f"main path has no {need[1]}-D SZ field: {sorted(kinds)}")
    check(any(c == "zfp" for c, _ in kinds), f"main path has no ZFP field: {sorted(kinds)}")
    check(main_launches["lorenzo2d_encode"] >= 1, "K1 never launched on the main path")
    check(main_launches["lorenzo3d_encode"] >= 1, "K2 never launched on the main path")
    return rows, main_launches


def phase_kernels_at_main(torch, dev, rows, parity):
    """Each kernel against its plain version on the main path's own SZ
    fields at their eb_sz (after the launch counts were read)."""
    from repro_torch.kernels import ops, ref

    names = []
    for row, x, cf in rows:
        if cf.codec != "sz":
            continue
        xt = torch.from_numpy(x).to(dev)
        got = ops.lorenzo_encode(xt, cf.selection.eb_sz)
        want = ref.lorenzo_encode_ref(xt, cf.selection.eb_sz)
        err = int((got.long() - want.long()).abs().max())
        kname = "lorenzo2d_encode" if x.ndim == 2 else "lorenzo3d_encode"
        parity[kname]["max_abs_err"] = max(parity[kname]["max_abs_err"], err)
        check(err == 0, f"{kname} differs from its plain version on {row['field']}")
        names.append(row["field"])
    log("main", f"kernels exact at eb_sz on {names}")


def phase_decode(torch, np, dev, rows):
    """`ops.lorenzo_decode` (prefix sum, then K3/K4) on the main path's SZ
    fields, from the K1/K2 codes at their eb_sz. Returns the K3/K4 launch
    counts of this run."""
    from repro_torch.kernels import lorenzo, ops

    lorenzo.reset_launches()
    for row, x, cf in rows:
        if cf.codec != "sz":
            continue
        eb = cf.selection.eb_sz
        y = ops.lorenzo_decode(ops.lorenzo_encode(torch.from_numpy(x).to(dev), eb), eb)
        torch.cuda.synchronize()
        err = float(np.max(np.abs(y.cpu().numpy().astype(np.float64) - x)))
        tol = eb + 4 * float(np.spacing(np.float32(np.abs(x).max())))
        check(err <= tol, f"{row['field']}: lorenzo_decode off by {err} > {tol}")
        log("decode", f"{row['field']} {list(x.shape)}: max|decode - x| = {err} <= {tol}")
    launches = {k: lorenzo.LAUNCHES[k] for k in ("dequantize2d", "dequantize3d")}
    check(launches["dequantize2d"] >= 1, "K3 never launched on the decode path")
    check(launches["dequantize3d"] >= 1, "K4 never launched on the decode path")
    return launches


def phase_cpu_vs_card(torch, np, dev):
    from benchmarks.common import atm_suite, hurricane_suite
    from repro_torch.core import encode_with_selection, select

    fields = dict(atm_suite(4, size=(384, 768)))
    fields.update(hurricane_suite(4, size=(32, 96, 96)))
    identical = 0
    for name, x in fields.items():
        s_cpu = select(x, eb_rel=EB_REL, device="cpu")
        s_gpu = select(x, eb_rel=EB_REL, device=dev)
        check(s_cpu.codec == s_gpu.codec, f"{name}: codec {s_cpu.codec} on CPU, {s_gpu.codec} on card")
        check(abs(s_cpu.eb_sz - s_gpu.eb_sz) <= EB_SZ_RTOL * abs(s_cpu.eb_sz),
              f"{name}: eb_sz {s_cpu.eb_sz} vs {s_gpu.eb_sz}")
        for k in ("br_sz", "br_zfp"):
            check(abs(getattr(s_cpu, k) - getattr(s_gpu, k)) <= BR_ATOL,
                  f"{name}: {k} {getattr(s_cpu, k)} vs {getattr(s_gpu, k)}")
        b_cpu = encode_with_selection(x, s_gpu, device_encode=True, device="cpu").data
        b_gpu = encode_with_selection(x, s_gpu, device_encode=True, device=dev).data
        check(b_cpu == b_gpu, f"{name}: container bytes differ between CPU and card")
        same = s_cpu == s_gpu
        identical += same
        log("cpu-vs-card", f"{name} {tuple(x.shape)} {s_gpu.codec}: bytes equal, decision "
            + ("identical" if same else "within tolerance"))
    log("cpu-vs-card", f"{len(fields)} fields, {identical} decisions bit-identical")


def phase_kv(torch, np, dev, times: dict | None = None):
    """The KV page tier at phi4-mini-3.8b's full width. Returns the launch
    counts of K6 (the eviction) and K5 (the flat pages); fills `times` with
    the evict, re-evict and restore medians and the evict's step medians
    (host ms)."""
    from repro_torch.core import device_encode as de
    from repro_torch.core.decision_cache import DecisionCache
    from repro_torch.core.policy import Policy, serving_policies
    from repro_torch.core.zfp import zfp_decompress
    from repro_torch.kernels import bot4, ops
    from repro_torch.runtime import kvcomp

    n_pages = REQUEST_TOKENS // PAGE_TOKENS
    width = N_KV_HEADS * HEAD_DIM
    t0 = time.perf_counter()
    arenas = {}
    for i, key in enumerate(("k", "v")):
        # the batcher's arena layout, page 0 reserved as scratch
        arena = torch.zeros((N_LAYERS, n_pages + 1, PAGE_TOKENS, N_KV_HEADS, HEAD_DIM),
                            dtype=torch.bfloat16, device=dev)
        vals = torch.from_numpy(kv_values(np, (N_LAYERS, REQUEST_TOKENS, width), 70 + i))
        arena[:, 1:] = vals.to(dev).reshape(arena[:, 1:].shape).to(torch.bfloat16)
        arenas[key] = arena
    torch.cuda.synchronize()
    log("kv", f"K and V arenas {list(arenas['k'].shape)} bf16 on the card, "
        f"{2 * arenas['k'].numel() * 2 / 2**20:.0f} MiB, made in {time.perf_counter() - t0:.1f} s")

    def stacks():
        for key, arena in arenas.items():
            for p in range(n_pages):
                yield f"kv/long/0/{key}{p}", arena[:, 1 + p].reshape(N_LAYERS, PAGE_TOKENS, -1)

    pol = serving_policies(KV_RATIO).resolve("kv/long/0")
    check(pol.mode == "fixed_ratio", f"serving policy for a long request is {pol.mode}")
    cache = DecisionCache()

    def evict_all():
        out, ms = {}, []
        for name, page in stacks():
            t = time.perf_counter()
            out[name] = kvcomp.compress_page(page, pol, cache=cache, name=name, device=dev)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, ms

    warm = next(stacks())[1]
    kvcomp.compress_page(warm, pol, device=dev)  # warm the code paths
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bot4.reset_launches()
    stored, evict_ms = evict_all()
    k6_launches = bot4.LAUNCHES["bot3d_fused"]
    n_bot = sum(cp.codec == "bot" for cp in stored.values())
    check(n_bot == len(stored) == 2 * n_pages, f"{n_bot} of {len(stored)} stacks took the bot path")
    check(k6_launches == n_bot, f"K6 launched {k6_launches} times for {n_bot} bot pages")
    check(all(cache.events[n] == "miss" for n in stored), "first eviction was not all misses")

    restore_ms, worst = [], 0.0
    for name, page in stacks():
        cp = stored[name]
        t = time.perf_counter()
        back = kvcomp.decompress_page(cp, device=dev)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t) * 1e3)
        check(back.dtype == torch.bfloat16 and tuple(back.shape) == tuple(page.shape),
              f"{name}: restored {back.dtype} {tuple(back.shape)}")
        b32 = back.float()
        err = (b32 - page.float()).abs()
        check(bool((err <= cp.eb + 2.0**-8 * b32.abs()).all()),
              f"{name}: restored values off by more than eb + bf16 rounding")
        worst = max(worst, float(err.max()) / cp.eb)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # exact bit accounting: nbytes is ceil(sum(bits) / 8) of the kernel's bits
    for name, page in stacks():
        cp = stored[name]
        _, bits = ops.bot_fused(page.float(), cp.eb)
        total = float(bits.sum(dtype=torch.float64))
        check(cp.nbytes == -(-int(total) // 8), f"{name}: nbytes {cp.nbytes} vs bits {total}")

    again, evict2_ms = evict_all()
    check(all(cache.events[n] == "hit" for n in again), "re-eviction was not all cache hits")
    check(all(again[n].eb == stored[n].eb and again[n].nbytes == stored[n].nbytes for n in stored),
          "re-eviction changed a bound or a byte count")

    # where an evict's time goes: its steps one at a time on 32 stacks,
    # each ending in a synchronize (host clock)
    steps = {"page_to_f32": [], "fingerprint": [], "ratio_grid_solve": [],
             "bot3d_fused": [], "recon_to_host": []}
    for _, (name, page) in zip(range(32), stacks()):
        marks = [time.perf_counter()]
        page32 = page.to(torch.float32).contiguous()
        vr = kvcomp._value_range(page32)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        kvcomp._page_fingerprint(page, float(vr), pol)
        marks.append(time.perf_counter())
        eb = kvcomp._policy_eb(page32, vr, pol)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        recon, bits = ops.bot_fused(page32, eb)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        recon.to(torch.bfloat16).cpu()
        float(bits.sum(dtype=torch.float64))
        marks.append(time.perf_counter())
        for key, a, b in zip(steps, marks, marks[1:]):
            steps[key].append((b - a) * 1e3)
    step_ms = {k: statistics.median(v) for k, v in steps.items()}
    log("kv", "evict steps, median ms over 32 stacks: " + json.dumps(step_ms))

    raw_bytes = N_LAYERS * PAGE_TOKENS * width * 2
    ratios = [raw_bytes / cp.nbytes for cp in stored.values()]
    summary = dict(
        stacks=len(stored), stack_shape=list(K6_PATH_SHAPE), dtype="bfloat16",
        ratio_median=statistics.median(ratios), ratio_min=min(ratios), ratio_max=max(ratios),
        evict_ms_median=statistics.median(evict_ms), evict_ms_total=sum(evict_ms),
        restore_ms_median=statistics.median(restore_ms), restore_ms_total=sum(restore_ms),
        reevict_ms_median=statistics.median(evict2_ms), reevict_ms_total=sum(evict2_ms),
        max_err_over_eb=worst, peak_gib=peak_gib, k6_launches=k6_launches,
        cache=cache.stats(),
    )
    log("kv", json.dumps(summary))
    if times is not None:
        times.update({k: summary[k] for k in ("evict_ms_median", "reevict_ms_median",
                                              "restore_ms_median")}, steps=step_ms)

    # one layer's K of the request as a flat page, through bot_compress_kv (K5)
    flat = arenas["k"][:, 1:].reshape(N_LAYERS, REQUEST_TOKENS, width)
    bot4.reset_launches()
    for layer in range(8):
        page = flat[layer].float()
        for fpol in (None, Policy.fixed_ratio(KV_RATIO)):
            recon, bits = kvcomp.bot_compress_kv(page, fpol)
            eb = float(kvcomp._policy_eb(page, kvcomp._value_range(page),
                                         fpol or kvcomp.DEFAULT_KV_POLICY))
            err = float((recon - page).abs().max())
            check(recon.dtype == torch.float32 and err <= eb,
                  f"flat page {layer}: max err {err} > eb {eb}")
    k5_launches = bot4.LAUNCHES["bot2d_fused"]
    check(k5_launches == 16, f"K5 launched {k5_launches} times for 16 flat pages")
    log("kv", f"8 flat {list(K5_PATH_SHAPE)} pages under the default policy and fixed_ratio(8): "
        f"within eb, K5 launched {k5_launches} times")

    # the other codecs: the device encoder's ZFJX bytes, and raw. Under
    # the serving bound and under the page default (eb_rel 1e-2); a page the
    # device encoder declines (its rate model sized the arena too small)
    # takes the bot path, as in the reference
    pages = list(stacks())
    zfp_pages, declines = 0, sum(de.DECLINES.values())
    for dpol in (pol, kvcomp.DEFAULT_KV_POLICY):
        for name, page in pages[:4]:
            cp = kvcomp.compress_page(page, dpol, device_encode=True, device=dev)
            check(cp.codec in ("zfp", "bot"), f"{name}: codec {cp.codec}")
            if cp.codec == "zfp":
                zfp_pages += 1
                check(cp.nbytes == len(cp.payload) < raw_bytes, f"{name}: ZFJX does not beat raw")
                rec = torch.from_numpy(zfp_decompress(cp.payload)).to(dev)
                err = float((rec - page.float()).abs().max())
                check(err <= cp.eb, f"{name}: ZFJX page decodes off by {err} > eb {cp.eb}")
                log("kv", f"{name} ({dpol.mode}): device-encoded ZFJX, ratio "
                    f"{raw_bytes / cp.nbytes}, max err / eb {err / cp.eb}")
    declined = sum(de.DECLINES.values()) - declines
    check(zfp_pages >= 1, "no page stack took the device encoder")
    log("kv", f"{zfp_pages} of 8 device-encode calls gave ZFJX bytes, {declined} declined "
        f"({dict(de.DECLINES)})")
    for name, page in pages[-4:]:
        cp = kvcomp.compress_page(page, Policy.raw(), device=dev)
        back = kvcomp.decompress_page(cp, device=dev)
        check(torch.equal(back.view(torch.int16), page.contiguous().view(torch.int16)),
              f"{name}: raw page not bit-identical")
    log("kv", "4 raw stacks restore bit-identical")

    # the same stacks on the CPU: same decisions and byte counts
    for name, page in (pages[0], pages[-1]):
        on_card = kvcomp.compress_page(page, pol, device=dev)
        on_cpu = kvcomp.compress_page(page.cpu(), pol, device="cpu")
        check((on_card.codec, on_card.eb, on_card.nbytes) == (on_cpu.codec, on_cpu.eb, on_cpu.nbytes),
              f"{name}: card ({on_card.eb}, {on_card.nbytes}) vs CPU ({on_cpu.eb}, {on_cpu.nbytes})")
    log("kv", "card and CPU give the same bound and bytes on 2 stacks")
    return {"bot3d_fused": k6_launches, "bot2d_fused": k5_launches}


def cpu_vs_card_decode(torch, np, dev, cfg, prefill_tol=(1e-4, 1e-5)) -> tuple[float, float]:
    """`cfg` (a float32 config) on the CPU and on the card with the same
    weights: a 64-token prefill and 8 cached decode steps fed the CPU's
    greedy tokens. Logits within rtol, atol * max|logit| = `prefill_tol`
    after the prefill, and atol 1e-3 * max|logit| after decode steps (the
    caches hold bfloat16, where a float32 value an ulp apart can round to
    the other neighbour); the same greedy token wherever the CPU's top-2
    margin exceeds twice that. Returns max err / max|logit| after the
    prefill and the worst over all 9 steps."""
    from repro_torch.models import build_model
    from repro_torch.models import nn as mnn

    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device=dev)
    params = mnn.init_tree(cpu.desc(), torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(1, cfg.vocab, (2, 64)),
                           dtype=torch.int32)
    feeds = [toks]

    def run(model, p):
        cache = model.init_cache(2, 72)
        out = []
        for i in range(9):
            if i == len(feeds):  # the CPU run picks the greedy tokens both runs take
                feeds.append(torch.argmax(out[-1], dim=-1)[:, None].to(torch.int32))
            lg, cache = model.forward(p, {"tokens": feeds[i].to(model.device)}, cache)
            out.append(lg[:, -1].cpu())
        return out

    want = run(cpu, params)
    got = run(card, mnn.tree_map(lambda a: a.to(dev), params))
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        tol = (prefill_tol[0] * w.abs() + prefill_tol[1] * scale) if i == 0 else 1e-3 * scale
        check(bool(((g - w).abs() <= tol).all()),
              f"{cfg.name}: card logits differ from the CPU's at step {i} "
              f"(max err / max|logit| {float((g - w).abs().max()) / scale:.3g})")
        top = torch.topk(w, 2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 2 * 1e-3 * scale
        check(torch.equal(g.argmax(-1)[clear], w.argmax(-1)[clear]),
              f"{cfg.name}: card token differs at {i}")
        errs.append(float((g - w).abs().max()) / scale)
    return errs[0], max(errs)


def phase_serve_cpu_vs_card(torch, np, dev):
    """The served model at a small size against the same weights on the
    CPU: the reduced phi4-mini-3.8b at float32 (TF32 off), through
    `cpu_vs_card_decode`."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced_for_smoke

    cfg = reduced_for_smoke(get_config("phi4-mini-3.8b")).scaled(dtype="float32")
    prefill, worst = cpu_vs_card_decode(torch, np, dev, cfg)
    log("serve-cpu-vs-card", f"reduced {cfg.name} at float32: prefill and 8 decode steps on the "
        f"card within tolerance of the CPU (max err / max|logit| {prefill:.3g} after the cached "
        f"prefill, {worst:.3g} at worst)")


def static_report(torch, args, out: dict, vocab: int) -> dict:
    """The checks and numbers of one `serve.run_static` (the loop
    `serve.main` runs): `args.gen` tokens a row within the vocabulary;
    prefill ms, decode ms per step and tok/s over the whole decode loop,
    peak memory since the caller's reset."""
    toks = out["tokens"]
    check(toks.shape == (args.batch, args.gen) and 0 <= toks.min() and toks.max() < vocab,
          f"{args.arch}: static tokens {toks.shape}, range [{toks.min()}, {toks.max()}]")
    steps = args.gen - 1
    return dict(
        arch=args.arch, batch=args.batch, prompt=args.prompt_len, gen=args.gen,
        prefill_ms=out["prefill_s"] * 1e3, decode_ms_per_step=out["decode_s"] * 1e3 / steps,
        decode_tok_s=args.batch * steps / out["decode_s"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def phase_serve_static(torch, np, dev):
    """The served model at a small size on the card against the CPU, then
    `launch.serve.main` on the contiguous cache at full width: prefill ms,
    decode ms per step and tok/s, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    phase_serve_cpu_vs_card(torch, np, dev)
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(SERVE_ARCH + SERVE_STATIC)
    args = serve.parse_args(SERVE_ARCH + SERVE_STATIC)
    log("serve-static", json.dumps(static_report(torch, args, out, get_config(args.arch).vocab)))


class ServeProbe:
    """Times the batcher's prefill, decode, evict and resume, and each
    stack's `decompress_page` within a resume (each ending in a
    synchronize), and keeps a copy of every page stack evicted and every
    stack restored, for `check_restored`. Patches `ContinuousBatcher` and
    `kvcomp` while in use."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = {"prefill": [], "decode": [], "evict": [], "resume": [], "decompress": []}
        self.prefill_len, self.evict_stacks, self.evict_mode = [], [], []
        self.copies, self.stored, self.back = {}, [], []

    def _timed(self, key, fn):
        """`fn` timed; a call that returns False (a resume refused for want
        of pages) is not counted."""
        torch = self.torch

        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            if out is not False:
                self.ms[key].append((time.perf_counter() - t) * 1e3)
            return out

        return run

    def __enter__(self):
        from repro_torch.runtime import batcher, kvcomp

        cls = batcher.ContinuousBatcher
        self._saved = [(cls, n, getattr(cls, n)) for n in ("_prefill", "_decode", "_evict", "_resume")]
        self._saved += [(kvcomp, n, getattr(kvcomp, n)) for n in ("compress_page", "decompress_page")]
        prefill, evict = cls._prefill, cls._evict
        compress, decompress = kvcomp.compress_page, kvcomp.decompress_page

        def counted_prefill(b, prompt):
            self.prefill_len.append(len(prompt))
            return prefill(b, prompt)

        def counted_evict(b, slot):
            n = len(self.stored)
            self.evict_mode.append(b.requests[b.slot_req[slot]].policy.mode)
            evict(b, slot)
            self.evict_stacks.append(len(self.stored) - n)

        def kept_compress(page, policy, **kw):
            cp = compress(page, policy, **kw)
            self.copies[id(cp)] = page.clone()
            self.stored.append(cp)
            return cp

        def kept_decompress(cp, **kw):
            out = decompress(cp, **kw)
            self.back.append((cp, out))
            return out

        cls._prefill = self._timed("prefill", counted_prefill)
        cls._decode = self._timed("decode", cls._decode)
        cls._evict = self._timed("evict", counted_evict)
        cls._resume = self._timed("resume", cls._resume)
        kvcomp.compress_page = kept_compress
        kvcomp.decompress_page = self._timed("decompress", kept_decompress)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False

    def check_restored(self, tag: str) -> dict:
        """Every restored stack against the copy taken when it was evicted:
        a raw one bit for bit, a lossy one within its bound plus the arena's
        bfloat16 rounding. Returns the restored stacks by codec."""
        torch = self.torch
        count = {"raw": 0, "bot": 0}
        for cp, out in self.back:
            page = self.copies[id(cp)]
            check(out.shape == page.shape and out.dtype == page.dtype,
                  f"{tag}: restored {out.dtype} {tuple(out.shape)}")
            if cp.codec == "raw":
                check(torch.equal(out.view(torch.int16), page.contiguous().view(torch.int16)),
                      f"{tag}: a raw stack did not restore bit for bit")
            else:
                back = out.float()
                err = (back - page.float()).abs()
                check(bool((err <= cp.eb + 2.0**-8 * back.abs()).all()),
                      f"{tag}: a restored stack is off by {float(err.max())} > eb {cp.eb}")
            count[cp.codec] += 1
        return count


def _median(xs):
    return statistics.median(xs) if xs else None


def check_continuous(tag: str, args, out: dict, probe, k6: int, peak_gib: float) -> dict:
    """The checks of a lossy `run_continuous` under `ServeProbe`: every
    request completes with `args.gen` tokens, the arena evicts and restores,
    long requests resolve to fixed_ratio and short ones to raw, every
    restored stack is within its bound of its copy at evict, and K6 ran
    once per lossy stack. Returns the run's numbers."""
    reqs = out["requests"]
    check(out["completed"] == len(reqs) == args.requests, f"{tag}: {out['completed']} completed")
    check(all(len(r.out) == args.gen for r in reqs), f"{tag}: a request got another count of tokens")
    check(out["evictions"] > 0 and out["restores"] > 0,
          f"{tag}: evictions {out['evictions']}, restores {out['restores']}")
    for r in reqs:
        want = "fixed_ratio" if len(r.prompt) + r.max_new >= args.long_threshold else "raw"
        check(r.policy.mode == want, f"{tag}: request {r.rid} resolved to {r.policy.mode}")
    restored = probe.check_restored(tag)
    lossy = [cp for cp in probe.stored if cp.codec == "bot"]
    check(len(lossy) >= 1 and restored["bot"] >= 1, f"{tag}: no lossy stack evicted and restored")
    check(k6 == len(lossy), f"{tag}: K6 launched {k6} times for {len(lossy)} lossy stacks")
    per_stack = {mode: [ms / n for ms, n, m in zip(probe.ms["evict"], probe.evict_stacks,
                                                   probe.evict_mode) if n and m == mode]
                 for mode in ("fixed_ratio", "raw")}
    by_len = {n: [ms for ms, m in zip(probe.ms["prefill"], probe.prefill_len) if m == n]
              for n in sorted(set(probe.prefill_len))}
    return dict(
        requests=len(reqs), steps=out["steps"], arena_pages=args.arena_pages,
        decode_tok_s=out["decode_tok_s"], decode_ms_per_step=_median(probe.ms["decode"]),
        prefill_ms={n: _median(v) for n, v in by_len.items()},
        evict_ms_per_request=_median(probe.ms["evict"]),
        evict_ms_per_stack={m: _median(v) for m, v in per_stack.items()},
        evict_ms=probe.ms["evict"], evict_stacks=probe.evict_stacks, evict_mode=probe.evict_mode,
        restore_ms_each=probe.ms["resume"], decompress_ms_per_stack=_median(probe.ms["decompress"]),
        restore_ms=_median(probe.ms["resume"]), evictions=out["evictions"],
        restores=out["restores"], page_reuses=out["page_reuses"],
        decision_hits=out["decision_hits"], peak_resident_kv_bytes=out["peak_resident_kv_bytes"],
        lossy_stacks=len(lossy), lossy_store_bytes=sum(cp.nbytes for cp in lossy),
        lossy_raw_bytes=sum(probe.copies[id(cp)].numel() * 2 for cp in lossy),  # bfloat16
        raw_stacks=len(probe.stored) - len(lossy), restored=restored,
        k6_launches=k6, peak_gib=peak_gib)


def phase_serve(torch, np, dev):
    """Continuous serving at full width with compress-on-evict (K6).
    Returns K6's launches and (args, cfg, model, params) for the raw runs."""
    from repro_torch.kernels import bot4
    from repro_torch.launch import serve

    args = serve.parse_args(SERVE_ARCH + SERVE_CONTINUOUS
                            + ["--arena-pages", str(SERVE_ARENA_PAGES)])
    t0 = time.perf_counter()
    cfg, model, params = serve.build(args)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in _leaves(params))
    log("serve", f"{args.arch}: {n_params:,} float32 parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    bot4.reset_launches()
    with ServeProbe(torch) as probe:
        out = serve.run_continuous(args, cfg, model, params)
    k6 = bot4.LAUNCHES["bot3d_fused"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("serve", json.dumps(check_continuous("serve", args, out, probe, k6, peak_gib)))
    return k6, (args, cfg, model, params)


def phase_serve_raw(torch, np, dev, served):
    """The same requests under `Policy.raw()` on the default arena and on
    the small one: eviction at raw must not change a token."""
    from repro_torch.core.policy import Policy
    from repro_torch.kernels import bot4
    from repro_torch.launch import serve

    args, cfg, model, params = served
    runs = {}
    bot4.reset_launches()
    for label, pages in (("calm", None), ("tight", args.arena_pages)):
        run_args = serve.parse_args(SERVE_ARCH + SERVE_CONTINUOUS
                                    + ([] if pages is None else ["--arena-pages", str(pages)]))
        with ServeProbe(torch) as probe:
            out = serve.run_continuous(run_args, cfg, model, params, policies=Policy.raw())
        runs[label] = out
        log("serve-raw", json.dumps(dict(
            arena=label, arena_pages=pages, steps=out["steps"], decode_tok_s=out["decode_tok_s"],
            decode_ms_per_step=_median(probe.ms["decode"]), evictions=out["evictions"],
            restores=out["restores"], page_reuses=out["page_reuses"],
            evict_ms_per_request=_median(probe.ms["evict"]), restore_ms=_median(probe.ms["resume"]),
            restored=probe.check_restored(f"serve-raw {label}"),
            peak_resident_kv_bytes=out["peak_resident_kv_bytes"])))
    check(runs["calm"]["evictions"] == 0, "serve-raw: the default arena evicted")
    check(runs["tight"]["evictions"] > 0 and runs["tight"]["restores"] > 0,
          "serve-raw: the small arena did not evict")
    check(bot4.LAUNCHES["bot3d_fused"] == 0, "serve-raw: a raw eviction launched K6")
    for a, b in zip(runs["calm"]["requests"], runs["tight"]["requests"]):
        check(a.out == b.out, f"serve-raw: request {a.rid}'s tokens changed under eviction")
    log("serve-raw", f"{len(runs['calm']['requests'])} token streams equal with and without "
        f"{runs['tight']['evictions']} raw evictions")


def decode_profile(torch, np, dev, arch: str = SERVE_ARCH[1]) -> dict:
    """Where a full-width decode step of `arch` goes (`[serve-static]`'s
    shapes: batch 4 after a 64-token prefill; the MoE and MLA models at
    the depth of their serving phases): host ms a step over 5 steps,
    then over 5 steps traced by `torch.profiler` the device's busy ms a
    step (its kernels' summed durations), its idle share of the traced
    steps, the kernels launched a step and the 12 ops with the most device
    time (ms a step)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    layers = {MOE_ARCH: MOE_LAYERS, MLA_ARCH: MLA_LAYERS}.get(arch, get_config(arch).n_layers)
    cfg, model, params = full_width_model(torch, dev, arch, layers)
    toks = torch.as_tensor(np.random.default_rng(0).integers(1, cfg.vocab, (4, 64)),
                           dtype=torch.int32, device=dev)
    cache = model.init_cache(4, 64 + 16)
    batch = {"tokens": toks}
    if cfg.encdec:  # the audio stub's frames, encoded by the prefill
        batch["frames"] = torch.randn((4, cfg.frontend_len, cfg.d_model),
                                      generator=torch.Generator(device=dev).manual_seed(1),
                                      device=dev)
    logits, cache = make_prefill_step(model)(params, batch, cache)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    decode = make_decode_step(model)
    for _ in range(3):
        nxt, cache = decode(params, nxt, cache)
    steps = 5
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        nxt, cache = decode(params, nxt, cache)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            nxt, cache = decode(params, nxt, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    avgs = sorted(prof.key_averages(), key=dev_us, reverse=True)[:12]
    return dict(
        arch=arch, n_layers=layers, untraced_ms_per_step=untraced_ms, traced_ms_per_step=wall_ms,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms, kernels_per_step=len(kernels) / steps,
        top_ops_device_ms_per_step={e.key: dev_us(e) / 1e3 / steps for e in avgs},
        top_ops_calls_per_step={e.key: e.count / steps for e in avgs})


def serve_only(torch, np, dev) -> dict:
    """The serving phases alone; returns K6's launches from `[serve]`."""
    phase_serve_static(torch, np, dev)
    k6, served = phase_serve(torch, np, dev)
    phase_serve_raw(torch, np, dev, served)
    return {"serve_k6_launches": k6}


#: the MoE and MLA serving phases: each model at its full published width,
#: its depth cut to what one card's 80 GB holds in float32 weights
#: (llama4-scout: ~2.2 B parameters a layer and 2 x 1.03 B for embed and
#: head, 10.9 B in 4 of 48 layers; deepseek-v2: the dense layer and 2 MoE
#: layers of ~3.97 B each with 2 x 0.52 B for embed and head, 9.3 B in 3 of
#: 60 layers)
MOE_ARCH, MOE_LAYERS = "llama4-scout-17b-a16e", 4
MLA_ARCH, MLA_LAYERS = "deepseek-v2-236b", 3
#: `[serve-mla]`'s legacy batcher: 4 requests on 1 slot. Its slots share one
#: clock and admit only at clock 0, so a second slot would never be admitted
#: once the first request's prefill has moved the clock: each request is a
#: wave of its own.
MLA_REQUESTS, MLA_SLOTS, MLA_PROMPT, MLA_GEN = 4, 1, 64, 16


def full_width_model(torch, dev, name: str, n_layers: int | None = None):
    """(cfg, model, params): `name` at full width cut to `n_layers` (None:
    its full depth), its float32 weights drawn on the card from a
    generator seeded 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import nn as mnn

    cfg = get_config(name)
    cfg = cfg.scaled(n_layers=n_layers or cfg.n_layers)
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = mnn.init_tree(model.desc(), torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n = sum(a.numel() for a in _leaves(params))
    log(name, f"{n:,} float32 parameters ({n * 4 / 1e9:.1f} GB) in {cfg.n_layers} layers drawn "
        f"on the card in {time.perf_counter() - t0:.2f} s")
    return cfg, model, params


def static_serve(torch, name: str, cfg, model, params) -> dict:
    """`serve.run_static`, the loop `[serve-static]` times through
    `serve.main`, at `[serve-static]`'s shapes on a model built here."""
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", name] + SERVE_STATIC)
    torch.cuda.reset_peak_memory_stats()
    return static_report(torch, args, serve.run_static(args, cfg, model, params), cfg.vocab)


def moe_twice_equal(torch, cfg, params, x) -> bool:
    """`apply_moe` of the first MoE layer, run twice on `x`: bit for bit?"""
    from repro_torch.models import blocks
    from repro_torch.models import nn as mnn

    p = mnn.layer(params["blocks"], 0)["mlp"]
    with torch.no_grad():
        a = blocks.apply_moe(p, x, cfg)
        b = blocks.apply_moe(p, x, cfg)
    return bool(torch.equal(a, b))


def free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def check_k6_on_path(torch, tag: str, probe) -> int:
    """K6 against its plain version at the shape and bounds a serving run
    gave it: each lossy stack's copy taken at evict, at the bound solved
    for it there, through `bot4.bot3d_fused` and `ref.bot_fused_ref`; bits
    equal, recon bit for bit, and the kernel's recon and byte count equal
    to what the eviction stored. Call it after reading the run's launch
    count. Returns the stacks checked."""
    from repro_torch.kernels import bot4, ref

    lossy = [cp for cp in probe.stored if cp.codec == "bot"]
    for i, cp in enumerate(lossy):
        page = probe.copies[id(cp)].float().contiguous()
        recon, bits = bot4.bot3d_fused(page, cp.eb)
        want_r, want_b = ref.bot_fused_ref(page, cp.eb)
        where = f"{tag}: lossy stack {i} {tuple(page.shape)} at eb={cp.eb}"
        check(torch.equal(bits, want_b), f"{where}: K6 bits differ from the plain version")
        check(same_bits(torch, recon, want_r), f"{where}: K6 recon differs from the plain version")
        stored = cp.payload.to(recon.device)
        check(torch.equal(recon.to(stored.dtype).view(torch.int16), stored.view(torch.int16)),
              f"{where}: the stored recon is not K6's")
        check(cp.nbytes == -(-int(float(want_b.sum(dtype=torch.float64))) // 8),
              f"{where}: stored {cp.nbytes} bytes for another bit count")
    return len(lossy)


def phase_serve_moe(torch, np, dev) -> int:
    """llama4-scout-17b-a16e at full width (4 of 48 layers): the static
    prefill + decode, then `run_continuous` with `[serve]`'s traffic and
    arena (compress-on-evict through K6, page stacks of (4, 16, 1024)),
    under `check_continuous`, and K6 against its plain version on every
    lossy stack the run evicted (`check_k6_on_path`); `apply_moe` at full
    width bit for bit across two runs. Returns K6's launches in the
    continuous run."""
    from repro_torch.kernels import bot4
    from repro_torch.launch import serve

    cfg, model, params = full_width_model(torch, dev, MOE_ARCH, MOE_LAYERS)
    x = torch.randn((1, 1024, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    check(moe_twice_equal(torch, cfg, params, x), "serve-moe: apply_moe differs between two runs")
    del x
    static = static_serve(torch, MOE_ARCH, cfg, model, params)
    log("serve-moe", json.dumps(dict(arch=cfg.name, n_layers=cfg.n_layers, static=static)))
    args = serve.parse_args(["--arch", MOE_ARCH] + SERVE_CONTINUOUS
                            + ["--arena-pages", str(SERVE_ARENA_PAGES)])
    torch.cuda.reset_peak_memory_stats()
    bot4.reset_launches()
    with ServeProbe(torch) as probe:
        out = serve.run_continuous(args, cfg, model, params)
    k6 = bot4.LAUNCHES["bot3d_fused"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    report = check_continuous("serve-moe", args, out, probe, k6, peak_gib)
    check(tuple(probe.stored[0].shape) == (MOE_LAYERS, 16, cfg.n_kv_heads * cfg.dh),
          f"serve-moe: page stack {probe.stored[0].shape}")
    k6_checked = check_k6_on_path(torch, "serve-moe", probe)
    log("serve-moe", json.dumps(dict(arch=cfg.name, apply_moe_bit_for_bit=True,
                                     k6_path_stacks_bit_for_bit=k6_checked, **report)))
    return k6


def _alone(torch, model, params, prompt, n: int, rows: int, max_len: int) -> list:
    """Greedy decode of one prompt without the batcher: its own batch-1
    prefill into a contiguous cache, copied leaf by leaf into row 0 of a
    `rows`-row cache whose other rows stay idle (along the batch axis the
    batcher's splice finds, `splice_rows`), then `n - 1` decode steps.
    The decode batch has the batcher's shape, so both take the same matrix
    kernels and their tokens can be held equal bit for bit."""
    from repro_torch.runtime.batcher import splice_rows

    dev = model.device
    one = model.init_cache(1, max_len)
    logits, one = model.forward(params, {"tokens": torch.as_tensor(prompt, device=dev)[None]}, one)
    cache = model.init_cache(rows, max_len)
    splice_rows(cache, one, 0, rows)
    cache["pos"] = one["pos"]
    toks = [int(torch.argmax(logits[0, -1]))]
    feed = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    for _ in range(n - 1):
        feed[0, 0] = toks[-1]
        logits, cache = model.forward(params, {"tokens": feed}, cache)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks


def phase_serve_mla(torch, np, dev) -> None:
    """deepseek-v2-236b at full width (the dense layer and 2 MoE layers of
    60): `apply_moe` bit for bit across two runs, the static prefill +
    decode, then `ContinuousBatcher(paged=False)` (MLA keeps the contiguous
    latent cache) with 4 requests on 1 slot, admitted one wave each, each
    token stream equal to the prompt decoded alone (`_alone`)."""
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    cfg, model, params = full_width_model(torch, dev, MLA_ARCH, MLA_LAYERS)
    check("dense_blocks" in params and cfg.moe.n_dense_layers == 1, "serve-mla: no dense layer")
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    check(moe_twice_equal(torch, cfg, params, x), "serve-mla: apply_moe differs between two runs")
    del x
    static = static_serve(torch, MLA_ARCH, cfg, model, params)
    log("serve-mla", json.dumps(dict(arch=cfg.name, n_layers=cfg.n_layers, static=static)))
    rng = np.random.default_rng(0)
    max_len = MLA_PROMPT + MLA_GEN
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, MLA_PROMPT).astype(np.int32),
                    max_new=MLA_GEN) for i in range(MLA_REQUESTS)]
    b = ContinuousBatcher(model, params, slots=MLA_SLOTS, max_len=max_len, eos_id=-1)
    check(not b.paged, "serve-mla: MLA took the paged pool")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    b.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    check(all(r.done and len(r.out) == MLA_GEN for r in reqs), "serve-mla: a request did not complete")
    for r in reqs:
        want = _alone(torch, model, params, r.prompt, MLA_GEN, MLA_SLOTS, max_len)
        check(r.out == want, f"serve-mla: request {r.rid}'s tokens differ from its lone decode")
    log("serve-mla", json.dumps(dict(
        arch=cfg.name, requests=MLA_REQUESTS, slots=MLA_SLOTS, prompt=MLA_PROMPT, gen=MLA_GEN,
        batcher_s=run_s, tokens_per_s=MLA_REQUESTS * MLA_GEN / run_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, streams_equal_alone=True,
        apply_moe_bit_for_bit=True)))


def cpu_vs_card_forward(torch, np, dev, cfg) -> float:
    """`cfg` (a float32 config) without a cache on the CPU and on the card
    with the same weights (a generator seeded 0), 2 x 40 tokens: logits
    within rtol 1e-4 and atol 1e-5 * max|logit|. Returns max err /
    max|logit|."""
    from repro_torch.models import build_model
    from repro_torch.models import nn as mnn

    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device=dev)
    params = mnn.init_tree(cpu.desc(), torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)),
                           dtype=torch.int32)
    with torch.no_grad():
        want, _ = cpu.forward(params, {"tokens": toks})
        got, _ = card.forward(mnn.tree_map(lambda a: a.to(dev), params), {"tokens": toks.to(dev)})
    scale = float(want.abs().max())
    err = float((got.cpu() - want).abs().max()) / scale
    check(bool(((got.cpu() - want).abs() <= 1e-4 * want.abs() + 1e-5 * scale).all()),
          f"{cfg.name}: card logits differ from the CPU's ({err:.3g})")
    return err


def phase_moe_mla_cpu_vs_card(torch, np, dev) -> None:
    """The reduced llama4-scout and deepseek-v2 at float32 with the CPU's
    weights: the forward without a cache (deepseek's parallel MLA path)
    within rtol 1e-4 and atol 1e-5 * max|logit| of the CPU's, and
    `cpu_vs_card_decode` at the cache's tolerance (atol 1e-3 * max|logit|)
    from the prefill on, since a prefill into the cache already reads its
    bfloat16 keys (MLA: the absorbed path over the bfloat16 latent); the
    reduced MoE blocks in bfloat16 bit for bit across two card runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn

    for name in (MOE_ARCH, MLA_ARCH):
        cfg = reduced_for_smoke(get_config(name)).scaled(dtype="float32")
        err = cpu_vs_card_forward(torch, np, dev, cfg)
        # a prefill into the cache already reads bfloat16 keys (MLA: latents)
        prefill, worst = cpu_vs_card_decode(torch, np, dev, cfg, prefill_tol=(0.0, 1e-3))
        bf = cfg.scaled(dtype="bfloat16")
        p16 = mnn.init_tree(build_model(bf, device=dev).desc(),
                            torch.Generator(device=dev).manual_seed(2), device=dev)
        x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev).to(torch.bfloat16)
        check(moe_twice_equal(torch, bf, p16, x), f"{name}: reduced apply_moe differs between runs")
        log("moe-mla-cpu-vs-card", f"reduced {name} at float32: forward within tolerance of the CPU "
            f"(max err / max|logit| {err:.3g}), the cached prefill ({prefill:.3g}) and 8 decode "
            f"steps too ({worst:.3g} at worst); "
            "bfloat16 apply_moe bit for bit across two card runs")


def moe_mla_only(torch, np, dev) -> dict:
    """The MoE and MLA phases alone; returns K6's launches from `[serve-moe]`."""
    k6 = phase_serve_moe(torch, np, dev)
    free_card(torch)
    phase_serve_mla(torch, np, dev)
    free_card(torch)
    phase_moe_mla_cpu_vs_card(torch, np, dev)
    return {"serve_moe_k6_launches": k6}


#: the recurrent families at their full published width and depth:
#: zamba2-1.2b (38 Mamba2 layers in 6 groups of 6 and a tail of 2, each
#: group followed by the shared attention; 1.18 B float32 parameters) and
#: xlstm-1.3b (6 groups of 7 mLSTM + 1 sLSTM; 3.53 B, its wq/wk/wv d_in x
#: d_in as in the reference). Neither has a paged cache, so both serve on
#: the legacy contiguous batcher: 4 requests on 2 slots, prompts of 64 and
#: 300 tokens (300 crosses the 256-token chunk), 16 new tokens each. Its
#: shared clock admits only at clock 0, so each request is a wave of its
#: own and the second slot decodes idle.
HYBRID_ARCH, XLSTM_ARCH = "zamba2-1.2b", "xlstm-1.3b"
REC_PROMPTS, REC_SLOTS, REC_GEN = (64, 300, 64, 300), 2, 16


def phase_serve_recurrent(torch, np, dev, tag: str, name: str) -> dict:
    """`name` at full width and depth: `serve.run_static` (batch 4, prompt
    64, gen 32), then `ContinuousBatcher` on the legacy contiguous cache
    with `REC_PROMPTS` on `REC_SLOTS` slots, each request's 16 tokens
    equal to its prompt decoded alone (`_alone`)."""
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    cfg, model, params = full_width_model(torch, dev, name)
    static = static_serve(torch, name, cfg, model, params)
    log(tag, json.dumps(dict(arch=cfg.name, n_layers=cfg.n_layers, static=static)))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, n).astype(np.int32),
                    max_new=REC_GEN) for i, n in enumerate(REC_PROMPTS)]
    max_len = max(REC_PROMPTS) + REC_GEN
    b = ContinuousBatcher(model, params, slots=REC_SLOTS, max_len=max_len, eos_id=-1)
    check(not b.paged, f"{tag}: {name} took the paged pool")
    resident = b.resident_kv_bytes()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    b.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(r.done and len(r.out) == REC_GEN for r in reqs), f"{tag}: a request did not complete")
    for r in reqs:
        want = _alone(torch, model, params, r.prompt, REC_GEN, REC_SLOTS, max_len)
        check(r.out == want, f"{tag}: request {r.rid}'s tokens differ from its lone decode")
    report = dict(arch=cfg.name, requests=len(reqs), prompts=list(REC_PROMPTS), slots=REC_SLOTS,
                  gen=REC_GEN, batcher_s=run_s, tokens_per_s=len(reqs) * REC_GEN / run_s,
                  resident_kv_bytes=resident, peak_gib=peak, streams_equal_alone=True)
    log(tag, json.dumps(report))
    return dict(static=static, batcher=report)


def phase_recurrent_cpu_vs_card(torch, np, dev) -> None:
    """The reduced zamba2-1.2b and xlstm-1.3b at float32 with the CPU's
    weights: the forward without a cache within rtol 1e-4 and atol 1e-5 *
    max|logit| of the CPU's, then `cpu_vs_card_decode` (a cached prefill
    and 8 greedy decode steps) at the cache's tolerance, atol 1e-3 *
    max|logit| from the prefill on (the hybrid's prefill reads bfloat16
    keys back from its cache, xLSTM's conv state is bfloat16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced_for_smoke

    for name in (HYBRID_ARCH, XLSTM_ARCH):
        cfg = reduced_for_smoke(get_config(name)).scaled(dtype="float32")
        err = cpu_vs_card_forward(torch, np, dev, cfg)
        prefill, worst = cpu_vs_card_decode(torch, np, dev, cfg, prefill_tol=(0.0, 1e-3))
        log("recurrent-cpu-vs-card", f"reduced {name} at float32: forward within tolerance of the "
            f"CPU (max err / max|logit| {err:.3g}), the cached prefill ({prefill:.3g}) and 8 "
            f"decode steps too ({worst:.3g} at worst)")


def recurrent_only(torch, np, dev) -> dict:
    """The recurrent families' phases alone; returns their reports."""
    out = {}
    for tag, name in (("serve-hybrid", HYBRID_ARCH), ("serve-xlstm", XLSTM_ARCH)):
        out[tag] = phase_serve_recurrent(torch, np, dev, tag, name)
        free_card(torch)
    phase_recurrent_cpu_vs_card(torch, np, dev)
    return out


#: the training phases (`launch.train` flags): smollm-360m at full width and
#: depth, 409.0 M float32 parameters, with error-feedback gradient compression
TRAIN_ARCH = ["--arch", "smollm-360m"]
TRAIN_RUN = ["--steps", "20", "--seq", "256", "--batch", "8", "--compress-grads",
             "--ckpt-every", "10", "--log-every", "5"]
TRAIN_RESUME_STEPS = 25
#: the compressed step whose every leaf is held to its contract
TRAIN_CHECKED_STEP = 5
#: [train-cpu-vs-card]: losses of 5 steps at float32 within this relative
#: tolerance (the card's float32 matmuls sum in other orders than the CPU's,
#: and Adam's normalized step and the gradient codes amplify ulps, see
#: tests/test_torch_train.py)
TRAIN_CARD_LOSS_RTOL = 1e-4


class TrainProbe:
    """Wraps `launch.train`'s train step and `optim.compress.compress` while
    in use: times every step (synchronized on both sides), keeps each
    step's metrics and the last (params, opt_state) the step returned (the
    step updates them in place, so after the run they hold its final
    state), checks every leaf of one step's compression against its
    contract on the card, and times the checkpoint manager's saves and
    restores."""

    def __init__(self, torch, check_step: int | None = None):
        self.torch = torch
        self.check_step = check_step
        self.step_ms, self.metrics, self.save_ms, self.restore_ms = [], [], [], []
        self.state = None
        self.checked = None
        self.restored = None
        self._calls = 0

    def __enter__(self):
        from repro_torch.checkpoint import manager
        from repro_torch.launch import train
        from repro_torch.optim import compress

        torch = self.torch
        self._saved = [(train, "make_train_step", train.make_train_step),
                       (compress, "compress", compress.compress),
                       (manager.CheckpointManager, "save", manager.CheckpointManager.save),
                       (manager.CheckpointManager, "restore_tree",
                        manager.CheckpointManager.restore_tree)]
        make, real_compress = train.make_train_step, compress.compress
        save, restore_tree = manager.CheckpointManager.save, manager.CheckpointManager.restore_tree

        def timed_make(*a, **kw):
            step = make(*a, **kw)

            def timed(params, opt_state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(params, opt_state, batch)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                self.metrics.append({k: float(v) for k, v in out[2].items()})
                self.state = out[:2]
                return out

            return timed

        def checked_compress(cfg, grads, state):
            self._calls += 1
            if self._calls != self.check_step:
                return real_compress(cfg, grads, state)
            # compress writes neither: its outputs are fresh tensors
            g_in, r_in = _leaves(grads), _leaves(state["residual"])
            out = real_compress(cfg, grads, state)
            self.checked = check_compress_contract(torch, cfg, g_in, r_in, _leaves(out[0]),
                                                   _leaves(out[1]["residual"]))
            return out

        def timed_save(mgr, *a, **kw):
            t0 = time.perf_counter()
            out = save(mgr, *a, **kw)
            self.save_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def kept_restore(mgr, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step, tree = restore_tree(mgr, *a, **kw)
            torch.cuda.synchronize()
            self.restore_ms.append((time.perf_counter() - t0) * 1e3)
            if self.restored is not None:
                self.restored(step, tree)
            return step, tree

        train.make_train_step = timed_make
        compress.compress = checked_compress
        manager.CheckpointManager.save = timed_save
        manager.CheckpointManager.restore_tree = kept_restore
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def check_compress_contract(torch, cfg, g_in, r_in, gq, resid) -> dict:
    """Every leaf of one compression step against its plain form on the
    card: with g' = g + r, vr = max g' - min g', eb = eb_rel * vr and
    delta = 2 eb, k = round(g' / delta); the dequantized leaf must be
    k * delta bit for bit, the residual the fused multiply-add g' - k*delta
    (float64, rounded once) bit for bit, and |k*delta - g'| <= eb up to one
    float32 rounding of each of the division and the product,
    eb + 2^-24 (|g'| + |k*delta|). The float64 checks take a leaf 2^24
    values at a time, so they fit beside a full-width model's training
    state. Returns the worst error over eb."""
    worst, values = 0.0, 0
    for g, r, q, res in zip(g_in, r_in, gq, resid):
        gp = g.float() + r
        vr = torch.clamp(gp.max() - gp.min(), min=1e-12)
        eb = vr * cfg.eb_rel
        delta = 2.0 * eb
        for gs, qs, rs in zip(*(t.reshape(-1).split(1 << 24) for t in (gp, q, res))):
            k = torch.round(gs / delta)
            check(torch.equal(qs, k * delta), "train: a dequantized gradient is not k * delta")
            fma = (gs.double() - k.double() * delta.double()).float()
            check(torch.equal(rs, fma), "train: a residual is not the fused g' - k * delta")
            err = (qs.double() - gs.double()).abs()
            bound = eb.double() + 2.0**-24 * (gs.double().abs() + qs.double().abs())
            check(bool((err <= bound).all()),
                  "train: a dequantized gradient is off by more than eb")
            worst = max(worst, float((err / eb.double()).max()))
        values += g.numel()
    return {"leaves": len(gq), "values": values, "max_err_over_eb": worst}


def _train_dir(name: str) -> Path:
    """A fresh scratch directory under the checkout's ignored build/."""
    import shutil

    d = ROOT / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    return d


def phase_train(torch, np, dev) -> dict:
    """Training at the full width and depth of smollm-360m through
    `launch.train.main`: 20 steps with gradient compression and raw
    checkpoints every 10 steps (step ms, tokens/s, peak memory, losses,
    wire bits; every leaf of one step's compression held to its contract),
    a resume from step 20 to 25 (the restored tree bit for bit against the
    trained one), then one lossy save of the trained params, timed, with
    the device encoder's declines."""
    import shutil

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core import Policy, device_encode
    from repro_torch.kernels import lorenzo
    from repro_torch.launch import train

    ckpt = _train_dir("train_ckpt")
    args = TRAIN_ARCH + TRAIN_RUN + ["--device", str(dev), "--ckpt-dir", str(ckpt)]
    targs = train.parse_args(args)
    torch.cuda.reset_peak_memory_stats()
    with TrainProbe(torch, check_step=TRAIN_CHECKED_STEP) as probe:
        out = train.main(args)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    params, opt_state = probe.state
    losses = out["losses"]
    n_params = sum(p.numel() for p in _leaves(params))
    check(len(losses) == targs.steps and all(math.isfinite(v) for v in losses),
          f"train: losses {losses}")
    check(statistics.mean(losses[-5:]) < losses[0], f"train: the loss did not fall: {losses}")
    check(probe.checked is not None, "train: the compression contract was not checked")
    check(sorted(os.listdir(ckpt)) == ["LATEST", "step_000000010", "step_000000020"],
          f"train: checkpoints {sorted(os.listdir(ckpt))}")
    step_ms = probe.step_ms
    tokens = targs.batch * targs.seq
    first = dict(
        arch=targs.arch, params=n_params, steps=targs.steps, seq=targs.seq, batch=targs.batch,
        step_ms_median=statistics.median(step_ms[1:]), first_step_ms=step_ms[0],
        step_ms=step_ms, tokens_per_s=tokens / (statistics.median(step_ms[1:]) / 1e3),
        peak_gib=peak_gib, first_loss=losses[0], last_loss=losses[-1], losses=losses,
        wire_bits_per_value=probe.metrics[-1]["wire_bits_per_value"],
        grad_norm_last=probe.metrics[-1]["grad_norm"], compress_contract=probe.checked,
        raw_save_ms=probe.save_ms, run_s=out["seconds"])
    log("train", json.dumps(first))

    # resume from step 20: the restored tree is the trained one, bit for bit
    want = {"params": params, "opt": opt_state["adam"]}
    seen = {}

    def compare(step, tree):
        seen["step"] = step
        got, exp = _leaves(tree), _leaves(want)
        check(len(got) == len(exp) and all(torch.equal(a, b) for a, b in zip(got, exp)),
              f"train: step {step} did not restore bit for bit")

    with TrainProbe(torch) as probe2:
        probe2.restored = compare
        again = train.main(args + ["--resume", "--steps", str(TRAIN_RESUME_STEPS)])
    check(seen.get("step") == targs.steps, f"train: resumed from {seen.get('step')}")
    check(len(again["losses"]) == TRAIN_RESUME_STEPS - targs.steps
          and all(math.isfinite(v) for v in again["losses"]), f"train: resumed {again['losses']}")
    log("train", json.dumps(dict(
        resumed_from=seen["step"], restored_bit_for_bit=True, restore_ms=probe2.restore_ms[0],
        losses=again["losses"], step_ms_median=statistics.median(probe2.step_ms[1:]))))
    del again, probe2
    shutil.rmtree(ckpt, ignore_errors=True)

    # one lossy save of the trained params at full depth: the ZFP device
    # encoder declines the MLP stacks (int32 stream offsets, ROADMAP §C)
    # and the host coder takes them
    lossy = _train_dir("train_lossy")
    mgr = CheckpointManager(CheckpointConfig(str(lossy), policy=Policy.fixed_accuracy(eb_rel=1e-4),
                                             compress=True, device_encode=True), device=dev)
    lorenzo.reset_launches()
    declines = dict(device_encode.DECLINES)
    path, save_ms = _timed(torch, lambda: mgr.save(targs.steps, {"params": params}))
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    codecs = {}
    for row in man["fields"]:
        codecs[row["codec"]] = codecs.get(row["codec"], 0) + 1
    declined = {k: v - declines.get(k, 0) for k, v in device_encode.DECLINES.items()
                if v != declines.get(k, 0)}
    log("train", json.dumps(dict(
        lossy_save_ms=save_ms, data_bytes=man["total_bytes"], raw_bytes=man["raw_bytes"],
        ratio=man["raw_bytes"] / man["total_bytes"], codecs=codecs,
        codec_of={row["name"]: row["codec"] for row in man["fields"]},
        k1_launches=lorenzo.LAUNCHES["lorenzo2d_encode"],
        k2_launches=lorenzo.LAUNCHES["lorenzo3d_encode"],
        declined=sum(declined.values()), declines=declined)))
    shutil.rmtree(lossy, ignore_errors=True)
    return first


def phase_train_ckpt(torch, np, dev) -> dict:
    """The launcher's lossy checkpoints at the --smoke size: params under
    fixed_accuracy(1e-4), the optimizer state under fixed_ratio(8)
    (`--ckpt-opt-ratio 8`), saved every 5 of 10 steps and resumed to 15.
    Every restored params leaf of at least 64 values within 1e-4 * its value
    range; every float optimizer leaf of at least 64 values resolved to
    fixed_ratio."""
    import shutil

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.launch import train

    ckpt = _train_dir("train_smoke_ckpt")
    args = ["--smoke", "--device", str(dev), "--ckpt-dir", str(ckpt), "--ckpt-every", "5",
            "--compress-ckpt",
            "--ckpt-opt-ratio", "8", "--log-every", "5"]
    with TrainProbe(torch) as probe:
        out = train.main(args + ["--steps", "10"])
    with open(ckpt / "step_000000010" / "manifest.json") as f:
        rows = json.load(f)["fields"]
    modes = {}
    for row in rows:
        size = math.prod(row["shape"])
        if row["name"].startswith("opt/") and row["dtype"] == "float32" and size >= 64:
            check(row["policy"]["mode"] == "fixed_ratio", f"train-ckpt: {row['name']} resolved "
                  f"to {row['policy']['mode']}")
        modes[row["policy"]["mode"]] = modes.get(row["policy"]["mode"], 0) + 1
    _, flat = CheckpointManager(CheckpointConfig(str(ckpt)), device=dev).restore(10)
    from repro_torch.core import pytree

    worst = 0.0
    for path, want in pytree.flatten_with_path({"params": out["params"]})[0]:
        name = pytree.leaf_name(path)
        if want.numel() < 64:
            continue
        vr = float(want.max() - want.min())
        err = float((flat[name] - want).abs().max())
        check(err <= 1e-4 * vr * (1 + 1e-5), f"train-ckpt: {name} off by {err} > 1e-4 * {vr}")
        worst = max(worst, err / (1e-4 * vr))
    negative_v = sum(int((t < 0).sum()) for n, t in flat.items() if n.startswith("opt/v/"))
    with TrainProbe(torch) as probe2:
        again = train.main(args + ["--steps", "15", "--resume"])
    check(len(again["losses"]) == 5 and math.isfinite(again["losses"][0]),
          f"train-ckpt: resumed {again['losses']}")
    res = dict(steps=10, policies=modes, max_err_over_bound=worst, restore_ms=probe2.restore_ms,
               save_ms=probe.save_ms, negative_v_values=negative_v, resumed_losses=again["losses"])
    log("train-ckpt", json.dumps(res))
    shutil.rmtree(ckpt, ignore_errors=True)
    return res


def _grad_tree(torch, np, seed):
    """A gradient-shaped tree of numpy draws (scales 1e-6 to 10, a constant
    leaf) and a residual tree, for the compressor on two devices."""
    rng = np.random.default_rng(seed)
    leaves = {"embed": ((512, 128), 1e-6), "blocks/w": ((4, 128, 256), 10.0),
              "blocks/n": ((4, 128), 1e-2), "tiny": ((1000,), 0.1), "const": ((7, 9), 0.0)}
    grads, resid = {}, {}
    for name, (shape, scale) in leaves.items():
        g = rng.standard_normal(shape) * scale if scale else np.full(shape, 0.375)
        r = rng.standard_normal(shape) * 1e-3 * (scale or 1.0)
        *outer, key = name.split("/")
        for tree, arr in ((grads, g), (resid, r)):
            for k in outer:
                tree = tree.setdefault(k, {})
            tree[key] = torch.from_numpy(arr.astype(np.float32))
    return grads, {"residual": resid}


def phase_train_cpu_vs_card(torch, np, dev) -> dict:
    """The reduced smollm-360m at float32 from the same initial weights: 5
    train steps with gradient compression on the CPU and on the card, the
    losses within `TRAIN_CARD_LOSS_RTOL`; then one `compress` call on the
    same gradients and residuals on both devices, the dequantized gradients
    and residuals bit for bit, and the wire bits within 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn
    from repro_torch.optim import AdamWConfig, GradCompressConfig
    from repro_torch.optim import compress as gcomp
    from repro_torch.runtime.steps import init_opt_state, make_train_step

    cfg = reduced_for_smoke(get_config("smollm-360m")).scaled(dtype="float32")
    gc = GradCompressConfig(eb_rel=1e-3)
    opt = AdamWConfig(lr=1e-3, total_steps=100, warmup_steps=5)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    init = mnn.init_tree(build_model(cfg, device="cpu").desc(), torch.Generator().manual_seed(0),
                         device="cpu")
    losses = {}
    for where in ("cpu", dev):
        model = build_model(cfg, device=where)
        params = mnn.tree_map(lambda a: a.clone().to(where), init)
        state = init_opt_state(params, gc)
        step = make_train_step(model, opt, gc)
        losses[str(where)] = []
        for s in range(5):
            batch = {k: torch.from_numpy(v).to(where) for k, v in synthetic_batch(dcfg, s).items()}
            params, state, m = step(params, state, batch)
            losses[str(where)].append(float(m["loss"]))
    want, got = losses["cpu"], losses[str(dev)]
    rel = max(abs(a / b - 1) for a, b in zip(got, want))
    check(rel <= TRAIN_CARD_LOSS_RTOL, f"train-cpu-vs-card: losses {got} vs {want}")
    grads, state = _grad_tree(torch, np, 11)
    on = {}
    for where in ("cpu", dev):
        g = mnn.tree_map(lambda a: a.to(where), grads)
        st = {"residual": mnn.tree_map(lambda a: a.to(where), state["residual"])}
        on[str(where)] = gcomp.compress(gc, g, st)
    (cq, cs, cm), (dq, ds, dm) = on["cpu"], on[str(dev)]
    for a, b in zip(_leaves(cq) + _leaves(cs), _leaves(dq) + _leaves(ds)):
        check(torch.equal(a, b.cpu()), "train-cpu-vs-card: compressed gradients differ")
    wb = (float(cm["wire_bits_per_value"]), float(dm["wire_bits_per_value"]))
    check(abs(wb[1] / wb[0] - 1) <= 1e-6, f"train-cpu-vs-card: wire bits {wb}")
    res = dict(losses_cpu=want, losses_card=got, max_rel_loss_diff=rel,
               compress_bit_for_bit=True, wire_bits=wb)
    log("train-cpu-vs-card", json.dumps(res))
    return res


def train_only(torch, np, dev) -> dict:
    """The training phases alone."""
    return {"train": phase_train(torch, np, dev), "train_ckpt": phase_train_ckpt(torch, np, dev),
            "train_cpu_vs_card": phase_train_cpu_vs_card(torch, np, dev)}


#: the encoder-decoder and the train step of the families beyond the dense
#: decoders. seamless-m4t-large-v2 at full width and depth (24 encoder + 24
#: decoder layers, d_model 1024, vocab 256206; 2.04 B float32 parameters):
#: served with `[serve-static]`'s shapes and 1024 frames, its cached decode
#: held to the parallel forward over `ENCDEC_CHECK_TOKENS` tokens within
#: 5e-2 * max|logit| (tests/test_arch_smoke.py's bound: bfloat16 K/V in the
#: cache against the float32 parallel path); trained through
#: `make_train_step` with gradient compression (the launcher feeds no
#: frames). zamba2-1.2b and xlstm-1.3b train at full width and depth through
#: `launch.train.main`; llama4-scout and deepseek-v2 only at reduced size (a
#: full-width layer's params, gradients and Adam moments pass one card).
ENCDEC_ARCH, ENCDEC_CHECK_TOKENS = "seamless-m4t-large-v2", 8
TRAIN_HYBRID_RUN = ["--arch", HYBRID_ARCH, "--steps", "10", "--seq", "256", "--batch", "8",
                    "--compress-grads", "--log-every", "5"]
TRAIN_XLSTM_RUN = ["--arch", XLSTM_ARCH, "--steps", "5", "--seq", "256", "--batch", "4",
                   "--log-every", "1"]
ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_BATCH = 5, 256, 4
ZOO_ARCHS = (MOE_ARCH, MLA_ARCH, HYBRID_ARCH, XLSTM_ARCH, ENCDEC_ARCH)
#: [train-zoo-cpu-vs-card]: the card's gradients within this share of
#: max|g| of the CPU's (plus rtol 1e-4). The card's float32 matmuls sum in
#: other orders than the CPU's, and the sLSTM's 64-step recurrence carries
#: the differences back: the reduced xlstm-1.3b's sLSTM input weights lie
#: up to 2.1e-5 of max|g| apart, the other families within 1.2e-5
#: (NVIDIA H100 80GB HBM3, 700.00 W); the CPU tests' float32 rule against
#: the reference is 1e-5.
ZOO_CARD_GRAD_ATOL = 5e-5


def phase_serve_encdec(torch, np, dev) -> dict:
    """seamless-m4t-large-v2 at full width and depth through
    `serve.run_static` (batch 4, prompt 64, gen 32, 1024 frames drawn after
    the prompts): the tokens in range, the encoder run once (by the
    prefill; the decode steps read the cached memory); then a cached decode
    of `ENCDEC_CHECK_TOKENS` tokens, frames with the first, against the
    parallel forward of the same tokens within 5e-2 * max|logit|."""
    cfg, model, params = full_width_model(torch, dev, ENCDEC_ARCH)
    encodes = []
    encode = model.encode

    def counted(p, frames, remat=None):
        encodes.append(tuple(frames.shape))
        return encode(p, frames, remat)

    model.encode = counted
    static = static_serve(torch, ENCDEC_ARCH, cfg, model, params)
    check(encodes == [(4, cfg.frontend_len, cfg.d_model)],
          f"serve-encdec: the static run encoded {encodes}, not once in the prefill")
    rng = np.random.default_rng(1)
    n = ENCDEC_CHECK_TOKENS
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (4, n)), dtype=torch.int32, device=dev)
    frames = torch.as_tensor(rng.standard_normal((4, cfg.frontend_len, cfg.d_model)),
                             dtype=torch.float32, device=dev)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks, "frames": frames})
        cache = model.init_cache(4, n)
        outs = []
        for t in range(n):
            b = {"tokens": toks[:, t:t + 1]}
            if t == 0:
                b["frames"] = frames
            lg, cache = model.forward(params, b, cache)
            outs.append(lg)
    model.encode = encode
    rel = float((torch.cat(outs, dim=1) - full).abs().max()) / float(full.abs().max())
    check(math.isfinite(rel) and rel < 5e-2,
          f"serve-encdec: cached decode vs parallel forward {rel:.3g} of max|logit|")
    check(int(cache["pos"]) == n and len(encodes) == 3,
          f"serve-encdec: pos {int(cache['pos'])}, encodes {len(encodes)}")
    # the cross K/V each decode step recomputes over every frame in every
    # decoder layer (as the reference does): 2 projections of 2 * d * d a frame
    cross_flop = 2 * 2 * 4 * cfg.frontend_len * cfg.d_model * cfg.n_kv_heads * cfg.dh * cfg.n_layers
    report = dict(arch=cfg.name, enc_layers=cfg.n_enc_layers, dec_layers=cfg.n_layers,
                  frames=cfg.frontend_len, static=static, encoder_runs_in_static=1,
                  decode_vs_parallel_max_err_over_max_logit=rel,
                  cross_kv_gflop_per_decode_step=cross_flop / 1e9)
    log("serve-encdec", json.dumps(report))
    return report


def _losses_fall(losses) -> bool:
    k = max(1, len(losses) // 3)
    return (all(math.isfinite(v) for v in losses)
            and statistics.mean(losses[-k:]) < statistics.mean(losses[:k]))


def train_report(run: dict, probe, losses, peak_gib, n_params) -> dict:
    """A training phase's numbers: `run` gives arch, seq and batch, `probe`
    (a `TrainProbe`) the step times, metrics and checked contract."""
    step_ms = probe.step_ms
    med = statistics.median(step_ms[1:])
    return dict(arch=run["arch"], params=n_params, steps=len(losses), seq=run["seq"],
                batch=run["batch"], step_ms_median=med, first_step_ms=step_ms[0], step_ms=step_ms,
                tokens_per_s=run["batch"] * run["seq"] / (med / 1e3), peak_gib=peak_gib,
                losses=losses, compress_contract=probe.checked,
                wire_bits_per_value=probe.metrics[-1].get("wire_bits_per_value"))


def phase_train_launcher(torch, np, dev, tag: str, run: list) -> dict:
    """`launch.train.main(run)` at full width and depth: the losses finite
    and falling, step ms, tokens/s, peak memory; with --compress-grads every
    leaf of the 5th step's compression held to its contract."""
    from repro_torch.launch import train

    args = run + ["--device", str(dev)]
    targs = train.parse_args(args)
    torch.cuda.reset_peak_memory_stats()
    with TrainProbe(torch, check_step=TRAIN_CHECKED_STEP if targs.compress_grads else None) as probe:
        out = train.main(args)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = out["losses"]
    check(len(losses) == targs.steps and _losses_fall(losses), f"{tag}: losses {losses}")
    check(not targs.compress_grads or probe.checked is not None,
          f"{tag}: the compression contract was not checked")
    n_params = sum(p.numel() for p in _leaves(probe.state[0]))
    report = train_report(vars(targs), probe, losses, peak, n_params)
    log(tag, json.dumps(report))
    del out, probe
    return report


def phase_train_encdec(torch, np, dev) -> dict:
    """seamless-m4t-large-v2 at full width and depth through
    `make_train_step` with `GradCompressConfig()` (the launcher's AdamW
    rule), batches of 4 x 256 tokens and 1024 frames: the losses finite and
    falling, every leaf of the 3rd step's compression held to its
    contract, step ms, tokens/s, peak memory."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.optim import AdamWConfig, GradCompressConfig
    from repro_torch.runtime.steps import init_opt_state, make_train_step

    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = full_width_model(torch, dev, ENCDEC_ARCH)
    n = ENCDEC_TRAIN_STEPS
    gc = GradCompressConfig()
    state = init_opt_state(params, gc)
    step = make_train_step(model, AdamWConfig(lr=3e-4, total_steps=n,
                                              warmup_steps=min(20, n // 5)), gc)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=ENCDEC_TRAIN_SEQ, global_batch=ENCDEC_TRAIN_BATCH)
    losses = []
    with TrainProbe(torch, check_step=3) as probe:
        for s in range(n):
            batch = synthetic_batch(dcfg, s)
            batch["frames"] = np.random.default_rng(s).standard_normal(
                (dcfg.global_batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            probe.step_ms.append((time.perf_counter() - t0) * 1e3)
            probe.metrics.append({k: float(v) for k, v in m.items()})
            losses.append(probe.metrics[-1]["loss"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(_losses_fall(losses), f"train-encdec: losses {losses}")
    check(probe.checked is not None, "train-encdec: the compression contract was not checked")
    n_params = sum(p.numel() for p in _leaves(params))
    report = train_report(dict(arch=cfg.name, seq=ENCDEC_TRAIN_SEQ, batch=ENCDEC_TRAIN_BATCH),
                          probe, losses, peak, n_params)
    report["frames"] = cfg.frontend_len
    log("train-encdec", json.dumps(report))
    return report


def _zoo_grads(torch, model, params, batch):
    """The loss and the gradient of every leaf, as `make_train_step` takes
    them."""
    from repro_torch.core import pytree as pt

    leaves, treedef = pt.flatten_with_path(params)
    tracked = [p.detach().requires_grad_(True) for _, p in leaves]
    loss, _ = model.loss(pt.unflatten(treedef, tracked), batch)
    grads = torch.autograd.grad(loss, tracked)
    return loss.detach(), [(pt.leaf_name(path), g) for (path, _), g in zip(leaves, grads)]


def phase_train_zoo_cpu_vs_card(torch, np, dev) -> dict:
    """The reduced llama4-scout, deepseek-v2, zamba2-1.2b, xlstm-1.3b and
    seamless-m4t-large-v2 at float32 (TF32 off), the same weights on the
    CPU and the card: the loss within rtol 1e-5 and every gradient leaf
    within rtol 1e-4 and atol `ZOO_CARD_GRAD_ATOL` * max|g| of the CPU's
    (the top-1 router's gradient, zero but for rounding, within 1e-6 of
    the model's largest in both); then one `make_train_step` with gradient compression on each
    device, losses within rtol 1e-5. The MoE gradients are computed twice
    on the card and whether they agree bit for bit is printed: their
    backward scatters with atomics, so a rerun may not."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn
    from repro_torch.optim import AdamWConfig, GradCompressConfig
    from repro_torch.runtime.steps import init_opt_state, make_train_step

    out = {}
    for name in ZOO_ARCHS:
        cfg = reduced_for_smoke(get_config(name)).scaled(dtype="float32")
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
        batch = synthetic_batch(dcfg, 0)
        if cfg.encdec:
            batch["frames"] = np.random.default_rng(0).standard_normal(
                (4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        init = mnn.init_tree(build_model(cfg, device="cpu").desc(),
                             torch.Generator().manual_seed(0), device="cpu")
        runs = []  # the CPU's, then the card's
        for where in ("cpu", dev):
            model = build_model(cfg, device=where)
            params = mnn.tree_map(lambda a: a.clone().to(where), init)
            b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
            runs.append((model, params, b, _zoo_grads(torch, model, params, b)))
        (_, _, _, (wl, want)), (gmodel, gparams, gb, (gl, got)) = runs
        check(abs(float(gl) / float(wl) - 1) <= 1e-5, f"{name}: card loss {gl} vs CPU {wl}")
        top = max(float(g.abs().max()) for _, g in want)
        zero = {"blocks/mlp/router"} if cfg.moe is not None and cfg.moe.top_k == 1 else set()
        worst = 0.0
        for (n, g), (_, w) in zip(got, want):
            g = g.cpu()
            if n in zero:
                check(max(float(g.abs().max()), float(w.abs().max())) <= 1e-6 * top,
                      f"{name}: {n}'s gradient is not zero but for rounding")
                continue
            scale = float(w.abs().max())
            check(bool(((g - w).abs() <= 1e-4 * w.abs() + ZOO_CARD_GRAD_ATOL * scale).all()),
                  f"{name}: card gradient {n} differs from the CPU's")
            worst = max(worst, float((g - w).abs().max()) / max(scale, 1e-30))
        res = dict(loss_rel_err=abs(float(gl) / float(wl) - 1), worst_grad_err_over_max=worst)
        if cfg.moe is not None:
            _, again = _zoo_grads(torch, gmodel, gparams, gb)
            res["moe_rerun_grads_bit_for_bit"] = all(
                torch.equal(a, b) for (_, a), (_, b) in zip(got, again))
        gc = GradCompressConfig(eb_rel=1e-3)
        opt = AdamWConfig(lr=1e-3, total_steps=100, warmup_steps=5)
        losses = []
        for model, params, b, _ in runs:
            _, _, m = make_train_step(model, opt, gc)(params, init_opt_state(params, gc), b)
            losses.append(float(m["loss"]))
        check(abs(losses[1] / losses[0] - 1) <= 1e-5, f"{name}: train step loss {losses}")
        res["train_step_loss_cpu_card"] = losses
        out[name] = res
        log("train-zoo-cpu-vs-card", f"reduced {name} at float32: {json.dumps(res)}")
        del runs, gmodel, gparams
    return out


def zoo_only(torch, np, dev) -> dict:
    """The encoder-decoder's serving and the zoo's training phases alone."""
    out = {"serve_encdec": phase_serve_encdec(torch, np, dev)}
    free_card(torch)
    out["train_hybrid"] = phase_train_launcher(torch, np, dev, "train-hybrid", TRAIN_HYBRID_RUN)
    free_card(torch)
    out["train_xlstm"] = phase_train_launcher(torch, np, dev, "train-xlstm", TRAIN_XLSTM_RUN)
    free_card(torch)
    out["train_encdec"] = phase_train_encdec(torch, np, dev)
    free_card(torch)
    out["train_zoo_cpu_vs_card"] = phase_train_zoo_cpu_vs_card(torch, np, dev)
    return out


def train_profile(torch, np, dev) -> dict:
    """Where a full-width train step's time goes (`[train]`'s shapes:
    smollm-360m, batch 8 of 256 tokens, gradient compression): host ms a
    step over 3 steps, then over 3 steps traced by `torch.profiler` the
    device's busy ms a step (its kernels' summed durations), its idle share
    of the traced steps, the kernels launched a step and the 12 ops with
    the most device time (ms a step)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models import nn as mnn
    from repro_torch.optim import AdamWConfig, GradCompressConfig
    from repro_torch.runtime.steps import init_opt_state, make_train_step

    targs = train.parse_args(TRAIN_ARCH + TRAIN_RUN)
    cfg = get_config(targs.arch)
    model = build_model(cfg, device=dev)
    params = mnn.init_tree(model.desc(), torch.Generator(device=dev).manual_seed(0), device=dev)
    gc = GradCompressConfig()
    state = init_opt_state(params, gc)
    step = make_train_step(model, AdamWConfig(lr=targs.lr, total_steps=100, warmup_steps=20), gc)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=targs.seq, global_batch=targs.batch)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(dcfg, s).items()}
               for s in range(8)]
    for b in batches[:2]:
        params, state, m = step(params, state, b)
    steps = 3
    torch.cuda.synchronize()
    t = time.perf_counter()
    for b in batches[2:2 + steps]:
        params, state, m = step(params, state, b)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches[2 + steps:2 + 2 * steps]:
            params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    avgs = sorted(prof.key_averages(), key=dev_us, reverse=True)[:12]
    return dict(
        arch=targs.arch, batch=targs.batch, seq=targs.seq,
        untraced_ms_per_step=untraced_ms, traced_ms_per_step=wall_ms,
        device_busy_ms_per_step=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
        kernels_per_step=len(kernels) / steps,
        top_ops_device_ms_per_step={e.key: dev_us(e) / 1e3 / steps for e in avgs},
        top_ops_calls_per_step={e.key: e.count / steps for e in avgs},
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)


#: the pytree phase's leaves in the reference's order (`jax.tree_util`)
PYTREE_NAMES = [
    "atm/ATM_00", "atm/ATM_01", "atm/ATM_02", "atm/ATM_03", "bf16", "const", "f64",
    "folded", "frozen", "hur/sz", "hur/zfp", "ids", "lr", "mask", "nan", "step",
]


def phase_select_many(torch, np, dev, atm, hurricane):
    """`select_many` on the 17 paper-sized fields against the card's
    per-field `select` of each, to the golden tolerances; a codec may
    differ only where the two rates lie within 5e-3 bits/value. Times both
    (host clock, after a warm-up call)."""
    from repro_torch.core import select, select_many

    fields = {**atm, **{f"HUR_{k}": v for k, v in hurricane.items()}}
    arrs = list(fields.values())
    select_many(arrs, eb_rel=EB_REL, device=dev)  # warm-up
    t0 = time.perf_counter()
    many = select_many(arrs, eb_rel=EB_REL, device=dev)
    many_ms = (time.perf_counter() - t0) * 1e3
    per_field_ms, flips = 0.0, []
    for (name, x), m in zip(fields.items(), many):
        t0 = time.perf_counter()
        s = select(x, eb_rel=EB_REL, device=dev)
        per_field_ms += (time.perf_counter() - t0) * 1e3
        if m.codec != s.codec:
            check(abs(s.br_sz - s.br_zfp) < BR_ATOL and abs(m.br_sz - m.br_zfp) < BR_ATOL,
                  f"{name}: select_many picks {m.codec}, select {s.codec}")
            flips.append(name)
            log("select_many", f"{name}: codec {m.codec} vs {s.codec} at rates "
                f"sz {m.br_sz} / {s.br_sz}, zfp {m.br_zfp} / {s.br_zfp}")
        check(abs(m.eb_sz - s.eb_sz) <= EB_SZ_RTOL * s.eb_sz, f"{name}: eb_sz {m.eb_sz} vs {s.eb_sz}")
        for k in ("br_sz", "br_zfp"):
            check(abs(getattr(m, k) - getattr(s, k)) <= BR_ATOL,
                  f"{name}: {k} {getattr(m, k)} vs {getattr(s, k)}")
    codecs = {c: sum(m.codec == c for m in many) for c in ("sz", "zfp", "raw")}
    log("select_many", json.dumps(dict(
        fields=len(arrs), codecs=codecs, codec_flips=flips, select_many_ms=many_ms,
        per_field_select_ms=per_field_ms, speedup=per_field_ms / many_ms)))


#: the target phase's modes at the reference's own test targets
TARGET_MODES = [("fixed_psnr", 60.0), ("fixed_ratio", 8.0), ("fixed_ssim", 0.97),
                ("fixed_correlation", 0.995), ("fixed_ks", 0.1)]
#: solve decisions on the card against the port's on the CPU (the CPU
#: parity suite's tolerances against the reference)
TARGET_EB_RTOL = 1e-4


def _target_policy(mode, target):
    from repro_torch.core import Policy

    return getattr(Policy, mode)(target)


def phase_targets(torch, np, dev, atm, hurricane):
    """`solve_many` on the 17 paper-sized fields under each target mode
    (host clock ending in a synchronize, after a warm-up solve of two small
    fields per mode), beside `select_many` on the same fields; the metric
    modes' one host copy of the sampled blocks and their host statistics.
    Returns the solutions of each mode by field name."""
    from repro_torch.core import Policy, select_many, solve_many
    from repro_torch.core import controller as ctl

    fields = {**atm, **{f"HUR_{k}": v for k, v in hurricane.items()}}
    arrs = list(fields.values())
    rng = np.random.default_rng(5)
    small = [np.cumsum(rng.standard_normal(s), axis=0).astype(np.float32)
             for s in ((96, 192), (16, 48, 48))]
    for mode, target in TARGET_MODES:
        solve_many(small, _target_policy(mode, target), device=dev)
    select_many(arrs, eb_rel=EB_REL, device=dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    select_many(arrs, eb_rel=EB_REL, device=dev)
    torch.cuda.synchronize()
    select_ms = (time.perf_counter() - t0) * 1e3
    by_mode = {}
    for mode, target in TARGET_MODES:
        pol = _target_policy(mode, target)
        ctl.HOST_WORK.update(copy_bytes=0, copy_ms=0.0, stats_ms=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols = solve_many(arrs, pol, device=dev)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3
        for name, s in zip(fields, sols):
            check(s.selection.codec in ("sz", "zfp", "raw"), f"{mode} {name}: codec {s.selection.codec}")
            check(math.isfinite(s.est_bitrate) and s.selection.eb_abs > 0,
                  f"{mode} {name}: bound {s.selection.eb_abs}, rate {s.est_bitrate}")
        metric = mode in ctl.qual.MODE_METRIC
        check((ctl.HOST_WORK["copy_bytes"] > 0) == metric, f"{mode}: host work {ctl.HOST_WORK}")
        codecs = {c: sum(s.selection.codec == c for s in sols) for c in ("sz", "zfp", "raw")}
        on = sum(bool(s.on_target) for s in sols)
        check(on >= 1, f"{mode}: no field on target")
        log("targets", json.dumps(dict(
            mode=mode, target=target, fields=len(arrs), solve_ms=solve_ms,
            select_many_ms=select_ms, codecs=codecs, on_target=on,
            host_copy_ms=ctl.HOST_WORK["copy_ms"] if metric else None,
            host_copy_mb=ctl.HOST_WORK["copy_bytes"] / 1e6 if metric else None,
            host_stats_ms=ctl.HOST_WORK["stats_ms"] if metric else None)))
        by_mode[mode] = dict(zip(fields, sols))
    return by_mode


def _psnr_db(np, x, y):
    from benchmarks.common import psnr

    return psnr(x, np.asarray(y).reshape(x.shape))


def phase_target_roundtrips(torch, np, dev, atm, hurricane, by_mode):
    """`compress(..., device_encode=True)` then `decompress` under a target
    at full width: an ATM field under fixed_psnr(60) (within 1 dB), an ATM
    field and the first Hurricane field the solve gives to SZ under
    fixed_ratio(8) (the stream's ratio within 10%; the ATM one decoded).
    Returns the K1/K2 launches of the compresses."""
    from repro_torch.core import compress, decompress, solve
    from repro_torch.kernels import lorenzo

    ratio_sols = by_mode["fixed_ratio"]
    hur = next(k for k in hurricane if ratio_sols[f"HUR_{k}"].selection.codec == "sz")
    cases = [("ATM_00", atm["ATM_00"], ("fixed_psnr", 60.0), True),
             ("ATM_01", atm["ATM_01"], ("fixed_ratio", 8.0), True),
             (f"HUR_{hur}", hurricane[hur], ("fixed_ratio", 8.0), False)]
    launches = {"lorenzo2d_encode": 0, "lorenzo3d_encode": 0}
    for name, x, (mode, target), decode in cases:
        pol = _target_policy(mode, target)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sol = solve(x, pol, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lorenzo.reset_launches()
        cf = compress(x, pol, device_encode=True, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = {k: lorenzo.LAUNCHES[k] for k in launches}
        for k in launches:
            launches[k] += got[k]
        check(cf.codec == sol.selection.codec, f"{name}: compress chose {cf.codec}, solve "
              f"{sol.selection.codec}")
        ratio = x.size * 4 / len(cf.data)
        row = dict(field=name, shape=list(x.shape), mode=mode, target=target, codec=cf.codec,
                   on_target=bool(sol.on_target), ratio=ratio, solve_ms=(t1 - t0) * 1e3,
                   compress_ms=(t2 - t1) * 1e3, solve_share=(t1 - t0) / (t2 - t1),
                   k1_launches=got["lorenzo2d_encode"], k2_launches=got["lorenzo3d_encode"])
        check(cf.codec != "sz" or sum(got.values()) == 1, f"{name}: SZ field ran {got}")
        if decode:
            y = decompress(cf, device=dev)
            torch.cuda.synchronize()
            row.update(decompress_ms=(time.perf_counter() - t2) * 1e3,
                       psnr=_psnr_db(np, x, y.cpu().numpy()))
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log("targets-rt", json.dumps(row))
        if mode == "fixed_psnr":
            check(abs(row["psnr"] - target) <= 1.0, f"{name}: PSNR {row['psnr']} for {target}")
        else:
            check(abs(ratio / target - 1.0) <= 0.10, f"{name}: ratio {ratio} for {target}")
    return launches


def phase_target_pytree(torch, np, dev, atm, hurricane):
    """`compress_pytree(..., device_encode=True)` under a `PolicySet` with
    one rule per target mode (512x512 ATM crops, a 32x128x128 Hurricane
    crop), decoded by `decompress_pytree`; every leaf meets its contract on
    the decoded values. Returns the K1/K2 launches of the compress."""
    from repro_torch.core import Policy, PolicySet, compress_pytree, decompress_pytree
    from repro_torch.core import quality
    from repro_torch.kernels import lorenzo

    crops = [x[:512, :512].copy() for x in atm.values()]
    tree = {"psnr": {"atm": crops[0], "hur": hurricane["U_2"][:32, :128, :128].copy()},
            "ratio": {"atm": crops[1]}, "ssim": {"atm": crops[2]}, "corr": {"atm": crops[3]},
            "ks": {"atm": atm["ATM_00"][-512:, -512:].copy()}}
    rules = [(f"{k}/*", _target_policy(m, t)) for k, (m, t) in zip(
        ("psnr", "ratio", "ssim", "corr", "ks"), TARGET_MODES)]
    pset = PolicySet(default=Policy.fixed_accuracy(eb_rel=EB_REL), rules=rules)
    lorenzo.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ct = compress_pytree(tree, pset, device_encode=True, device=dev)
    torch.cuda.synchronize()
    compress_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: lorenzo.LAUNCHES[k] for k in ("lorenzo2d_encode", "lorenzo3d_encode")}
    out = decompress_pytree(ct, device=dev)
    achieved = {}
    for group, leaves in tree.items():
        for leaf, x in leaves.items():
            name = f"{group}/{leaf}"
            pol, cf = pset.resolve(name), ct.fields[name]
            y = out[group][leaf].cpu().numpy()
            if pol.mode == "fixed_psnr":
                a = _psnr_db(np, x, y)
                ok = abs(a - pol.target_psnr) <= 1.0
            elif pol.mode == "fixed_ratio":
                a = x.size * 4 / cf.nbytes
                ok = abs(a / pol.target_ratio - 1.0) <= 0.10
            else:
                metric = quality.MODE_METRIC[pol.mode]
                a = quality.measured_metric(metric, x, y)
                gap = quality.metric_gap(metric, a, getattr(pol, f"target_{metric}"))
                ok = gap <= quality.TOLERANCE[metric]
            achieved[name] = (cf.codec, a)
            check(ok, f"{name}: {pol.mode} achieved {a}")
    log("targets-pytree", json.dumps(dict(
        leaves=len(ct.fields), achieved=achieved, compress_ms=compress_ms, ratio=ct.ratio,
        k1_launches=launches["lorenzo2d_encode"], k2_launches=launches["lorenzo3d_encode"])))
    return launches


def phase_targets_cpu_vs_card(torch, np, dev):
    """The fields of `phase_cpu_vs_card` under each target mode: the card's
    `solve_many` against the port's on the CPU."""
    from benchmarks.common import atm_suite, hurricane_suite
    from repro_torch.core import solve_many

    fields = dict(atm_suite(4, size=(384, 768)))
    fields.update(hurricane_suite(4, size=(32, 96, 96)))
    arrs = list(fields.values())
    for mode, target in TARGET_MODES:
        pol = _target_policy(mode, target)
        on_cpu = solve_many(arrs, pol, device="cpu")
        on_card = solve_many(arrs, pol, device=dev)
        identical = 0
        for name, c, g in zip(fields, on_cpu, on_card):
            cs, gs = c.selection, g.selection
            check((cs.codec, c.on_target) == (gs.codec, g.on_target),
                  f"{mode} {name}: {cs.codec}/{c.on_target} on CPU, {gs.codec}/{g.on_target} on card")
            for k in ("eb_abs", "eb_sz"):
                check(abs(getattr(cs, k) - getattr(gs, k)) <= TARGET_EB_RTOL * abs(getattr(cs, k)),
                      f"{mode} {name}: {k} {getattr(cs, k)} vs {getattr(gs, k)}")
            check(abs(c.est_bitrate - g.est_bitrate) <= BR_ATOL,
                  f"{mode} {name}: est_bitrate {c.est_bitrate} vs {g.est_bitrate}")
            identical += c == g
        log("targets-cpu-vs-card", f"{mode}: {len(arrs)} fields agree, {identical} identical")


def pytree(torch, np, dev, atm, hurricane, rows):
    """The pytree phase's tree: the main path's six fields, a folded 5-D
    float32 leaf, float64, bfloat16 (on the card), int, bool, 0-d float,
    constant, NaN-poisoned and policy-raw leaves."""
    rng = np.random.default_rng(90)
    hur = {cf.codec: x for row, x, cf in rows if x.ndim == 3}
    cube = hurricane["U_2"][:16, :128, :128]
    nan = atm["ATM_01"][:256, :256].copy()
    nan[100, 17] = np.nan
    return {
        "atm": dict(atm),
        "hur": {"sz": hur["sz"], "zfp": hur["zfp"]},
        "folded": cube.reshape(2, 2, 4, 128, 128),
        "f64": atm["ATM_02"][:512, :512].astype(np.float64),
        "bf16": torch.from_numpy(atm["ATM_03"][:256, :512].copy()).to(dev, torch.bfloat16),
        "ids": rng.integers(0, 50_000, (4096,)).astype(np.int32),
        "mask": rng.integers(0, 2, (128, 128)).astype(bool),
        "step": np.array(1234, np.int64),
        "lr": 3e-4,
        "const": np.full((64, 64), 2.5, np.float32),
        "nan": nan,
        "frozen": atm["ATM_00"][:300, :300].copy(),
    }


def phase_pytree(torch, np, dev, atm, hurricane, rows, card):
    """`compress_pytree(tree, pset, device_encode=True)` on the card with the
    default workers, then `decompress_pytree` of its ten small leaves (the
    six full-width leaves are decoded, from the same device-encoded streams,
    by the checkpoint phase's restores). Returns the K1/K2 launches of the
    compress."""
    from repro_torch.core import (
        CompressedTree, Policy, PolicySet, compress_pytree, decompress_pytree,
    )
    from repro_torch.core import pytree as pt
    from repro_torch.core import device_encode as de
    from repro_torch.core.selector import _fold_ndim
    from repro_torch.kernels import lorenzo

    tree = pytree(torch, np, dev, atm, hurricane, rows)
    pset = PolicySet(default=Policy.fixed_accuracy(eb_rel=EB_REL),
                     rules=[("frozen", Policy.raw())])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lorenzo.reset_launches()
    de.DECLINES.clear()
    t0 = time.perf_counter()
    ct = compress_pytree(tree, pset, device_encode=True, device=dev)
    torch.cuda.synchronize()
    compress_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(lorenzo.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(list(ct.fields) == PYTREE_NAMES, f"leaf names {list(ct.fields)}")
    check(sum(de.DECLINES.values()) == 0, f"device encode declined: {dict(de.DECLINES)}")
    ranks = {n: len(_fold_ndim(np.empty(cf.shape, np.uint8)).shape) for n, cf in ct.fields.items()}
    for kname, rank in (("lorenzo2d_encode", 2), ("lorenzo3d_encode", 3)):
        n_sz = sum(cf.codec == "sz" and ranks[n] == rank for n, cf in ct.fields.items())
        check(n_sz >= 1, f"no {rank}-D SZ leaf in the tree")
        check(launches[kname] == n_sz, f"{kname}: {launches[kname]} launches for {n_sz} leaves")
    want_raw = {"bf16", "const", "frozen", "ids", "lr", "mask", "nan", "step"}
    check({n for n, cf in ct.fields.items() if cf.codec == "raw"} == want_raw,
          f"raw leaves {ct.selection_bits}")
    check(ct.fields["hur/zfp"].codec == "zfp", "the ZFP field was not given to ZFP")
    small = {k: v for k, v in tree.items() if k not in ("atm", "hur")}
    small_names = [pt.leaf_name(p) for p, _ in pt.flatten_with_path(small)[0]]
    small_ct = CompressedTree({n: ct.fields[n] for n in small_names}, pt.flatten_with_path(small)[1])
    t0 = time.perf_counter()
    out = decompress_pytree(small_ct, device=dev)
    torch.cuda.synchronize()
    decompress_ms = (time.perf_counter() - t0) * 1e3
    flat = {n: v for n, v in zip(small_names, _leaves(small))}
    back = {n: v for n, v in zip(small_names, _leaves(out))}
    for name, x in flat.items():
        y, cf = back[name], ct.fields[name]
        xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        check(y.device.type == dev.type and tuple(y.shape) == tuple(xt.shape)
              and y.dtype == xt.dtype, f"{name}: restored {y.dtype} {tuple(y.shape)} on {y.device}")
        if cf.codec == "raw" and cf.selection is None:
            check(torch.equal(_bytes(torch, y), _bytes(torch, xt)), f"{name}: raw leaf not bit for bit")
        elif cf.codec == "raw":  # degenerate: the float32 view's bits
            check(torch.equal(_bytes(torch, y.float()), _bytes(torch, xt.float())),
                  f"{name}: degenerate raw leaf changed")
        else:
            err = float((y.cpu().double() - xt.cpu().double()).abs().max())
            check(err <= cf.selection.eb_abs, f"{name}: max |err| {err} > eb {cf.selection.eb_abs}")
    serial = compress_pytree(tree, pset, device_encode=True, device=dev, workers=0)
    check(all(serial.fields[n].data == ct.fields[n].data for n in PYTREE_NAMES),
          "workers=0 bytes differ from the threaded compress")
    log("pytree", json.dumps(dict(
        leaves=len(ct.fields), codecs=ct.selection_bits, ratio=ct.ratio, nbytes=ct.nbytes,
        raw_nbytes=ct.raw_nbytes, compress_ms=compress_ms, decompressed=len(small_names),
        decompress_ms=decompress_ms, peak_gib=peak_gib, k1_launches=launches["lorenzo2d_encode"],
        k2_launches=launches["lorenzo3d_encode"], card=card)))
    return launches


def _perturbed(np, fields: dict, jump: str, nudge: str) -> dict:
    """`fields` with `jump` times 1000 and the first value of `nudge` moved
    up by one ulp (the golden warm trajectory's step 2)."""
    out = dict(fields)
    out[jump] = fields[jump] * np.float32(1000.0)
    bumped = fields[nudge].copy()
    bumped.flat[0] = np.nextafter(bumped.flat[0], np.float32(np.inf))
    out[nudge] = bumped
    return out


def _timed(torch, fn):
    """(fn(), host ms around it, the card synchronized on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _events(cache) -> dict:
    return {e: sum(v == e for v in cache.events.values()) for e in ("miss", "hit", "invalidated")}


def phase_warm(torch, np, dev, atm, hurricane):
    """The warm path on the 17 paper-sized fields: `select_many` with a
    `DecisionCache` in three calls (cold: all miss; identical: all hit, each
    `Selection` equal to the cold one; one field times 1000 and one nudged
    by an ulp: exactly those two invalidated), then `solve_many` under
    fixed_ratio(8) the same way, and a third solve with ``warm_start=True``
    re-solving the invalidated pair from their previous bounds. Host clock
    ending in a synchronize, after a warm-up call."""
    from repro_torch.core import DecisionCache, Policy, select_many, solve_many

    fields = {**atm, **{f"HUR_{k}": v for k, v in hurricane.items()}}
    names = list(fields)
    jump, nudge = names[0], names[len(atm)]
    steps = [fields, fields, _perturbed(np, fields, jump, nudge)]
    select_many(list(fields.values()), eb_rel=EB_REL, device=dev)  # warm-up

    def trajectory(label, run, cache):
        out, ms = [], []
        for k, flds in enumerate(steps):
            cache.reset_stats()
            got, t = _timed(torch, lambda: run(list(flds.values()), cache))
            out.append(got)
            ms.append(t)
            ev = _events(cache)
            want = ({"miss": len(names), "hit": 0, "invalidated": 0}, {"miss": 0, "hit": len(names),
                    "invalidated": 0}, {"miss": 0, "hit": len(names) - 2, "invalidated": 2})[k]
            check(ev == want, f"{label} call {k}: events {ev}, expected {want}")
            log("warm", json.dumps(dict(solver=label, call=("cold", "identical", "perturbed")[k],
                                        ms=t, events=ev)))
        check(out[1] == out[0], f"{label}: the warm decisions differ from the cold ones")
        check(cache.events[jump] == cache.events[nudge] == "invalidated",
              f"{label}: {jump} / {nudge} not invalidated")
        return out, ms

    pol = Policy.fixed_accuracy(eb_rel=EB_REL)
    sels, sel_ms = trajectory(
        "select_many", lambda a, c: select_many(a, policy=pol, cache=c, names=names, device=dev),
        DecisionCache())
    cold = select_many(list(steps[2].values()), policy=pol, device=dev)
    for k in (jump, nudge):
        i = names.index(k)
        check(sels[2][i] == select_many([steps[2][k]], policy=pol, device=dev)[0],
              f"{k}: the re-decision differs from a cold call on it")
        check(sels[2][i].codec == cold[i].codec, f"{k}: codec differs from the full cold call")
    ratio = Policy.fixed_ratio(8.0)
    sols, sol_ms = trajectory(
        "solve_many", lambda a, c: solve_many(a, ratio, cache=c, names=names, device=dev),
        DecisionCache())
    ws = DecisionCache(warm_start=True)
    solve_many(list(fields.values()), ratio, cache=ws, names=names, device=dev)
    ws.reset_stats()
    warm_sols, ws_ms = _timed(
        torch, lambda: solve_many(list(steps[2].values()), ratio, cache=ws, names=names, device=dev))
    check(_events(ws)["invalidated"] == 2, f"warm_start: events {_events(ws)}")
    pair = {}
    for k in (jump, nudge):
        i = names.index(k)
        a, b = warm_sols[i], sols[2][i]
        check(a.on_target and math.isfinite(a.est_bitrate),
              f"{k}: warm-started solve missed its target ({a.est_bitrate})")
        pair[k] = dict(warm_start_eb=a.selection.eb_abs, cold_eb=b.selection.eb_abs,
                       warm_start_bitrate=a.est_bitrate, cold_bitrate=b.est_bitrate)
    log("warm", json.dumps(dict(
        fields=len(names), select_ms=sel_ms, solve_ratio8_ms=sol_ms, warm_start_ms=ws_ms,
        warm_start_pair=pair)))


#: the checkpoint phase's steps: cold, identical, perturbed
CKPT_STEPS = ("cold", "identical", "perturbed")
#: `[ckpt]`'s leaves its step-2 restore does not decode: the host Huffman
#: decoder takes ~60 s for each 100x500x500 Hurricane leaf (the main path
#: and `[decode]` decode those fields); the saves keep every leaf whole
CKPT_UNDECODED = ("hur/sz", "hur/zfp")


def phase_ckpt(torch, np, dev, atm, hurricane, rows, card):
    """Warm checkpoint saves at full width: the pytree phase's 16-leaf tree
    through `CheckpointManager(CheckpointConfig(dir, cache=True,
    device_encode=True, workers=4))` at steps 0, 1 and 2 (cold, identical,
    one field times 1000 and one nudged by an ulp), each save's ms,
    `data.bin` bytes, ratio and cache events; no device encode declined.
    `restore_tree` of step 2 but `CKPT_UNDECODED`: each lossy leaf within
    its bound, raw leaves bit for bit, on the card. Step 3 saves the tree raw (its manifest carries
    the same decision cache); a fresh manager on the directory restores it
    (bit for bit, no lossy leaf decoded a second time) and saves again, all
    hits; one `async_save` + `wait`; `workers=0` on step 1's tree writes
    step 1's `data.bin`. Returns the K1/K2 launches of the phase."""
    import tempfile

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core import Policy, PolicySet
    from repro_torch.core import device_encode as de
    from repro_torch.kernels import lorenzo

    tree = pytree(torch, np, dev, atm, hurricane, rows)
    perturbed = dict(tree, atm=dict(tree["atm"]), hur=dict(tree["hur"]))
    perturbed["atm"]["ATM_00"] = tree["atm"]["ATM_00"] * np.float32(1000.0)
    bumped = tree["hur"]["sz"].copy()
    bumped.flat[0] = np.nextafter(bumped.flat[0], np.float32(np.inf))
    perturbed["hur"]["sz"] = bumped
    trees = [tree, tree, perturbed]
    pset = PolicySet(default=Policy.fixed_accuracy(eb_rel=EB_REL), rules=[("frozen", Policy.raw())])

    def config(d, **kw):
        return CheckpointConfig(d, policy=pset, cache=True, device_encode=True,
                                **{"workers": 4, **kw})

    def manifest(path):
        with open(Path(path) / "manifest.json") as f:
            return json.load(f)

    with tempfile.TemporaryDirectory() as tmp:
        d = str(Path(tmp) / "run")
        mgr = CheckpointManager(config(d), device=dev)
        lorenzo.reset_launches()
        de.DECLINES.clear()
        paths = []
        for step, t in enumerate(trees):
            mgr.cache.reset_stats()
            path, ms = _timed(torch, lambda: mgr.save(step, t))
            paths.append(path)
            man = manifest(path)
            ev = _events(mgr.cache)
            log("ckpt", json.dumps(dict(
                step=step, kind=CKPT_STEPS[step], save_ms=ms, data_bytes=man["total_bytes"],
                raw_bytes=man["raw_bytes"], ratio=man["raw_bytes"] / man["total_bytes"],
                events=ev, codecs=man["selection_bits"])))
            lossy = len(mgr.cache.entries)
            want = ({"miss": lossy, "hit": 0, "invalidated": 0},
                    {"miss": 0, "hit": lossy, "invalidated": 0},
                    {"miss": 0, "hit": lossy - 2, "invalidated": 2})[step]
            check(ev == want, f"ckpt step {step}: events {ev}, expected {want}")
        launches = dict(lorenzo.LAUNCHES)
        with open(Path(paths[1]) / "data.bin", "rb") as f:
            step1_data = f.read()  # keep_n prunes step 1 before the serial save
        check(sum(de.DECLINES.values()) == 0, f"ckpt: device encode declined: {dict(de.DECLINES)}")
        for name in ("lorenzo2d_encode", "lorenzo3d_encode"):
            check(launches[name] >= 1, f"ckpt: {name} never launched by the saves")
        decoded = {k: v for k, v in perturbed.items() if k != "hur"}
        check(set(CKPT_UNDECODED) == {f"hur/{k}" for k in perturbed["hur"]},
              f"ckpt: undecoded {CKPT_UNDECODED}")
        (step, got), restore_ms = _timed(torch, lambda: mgr.restore_tree(decoded))
        check(step == 2, f"restored step {step}")
        rows_by_name = {r["name"]: r for r in manifest(paths[2])["fields"]}
        src = {n: v for n, v in zip(PYTREE_NAMES, _leaves(perturbed))}
        names = [n for n in PYTREE_NAMES if n not in CKPT_UNDECODED]
        flat = dict(zip(names, _leaves(got)))
        del got
        err_over_eb = {}
        for name in names:
            x = src[name]
            y, row = flat[name], rows_by_name[name]
            xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
            check(y.device.type == dev.type and tuple(y.shape) == tuple(xt.shape)
                  and y.dtype == xt.dtype, f"{name}: restored {y.dtype} {tuple(y.shape)} on {y.device}")
            if row["codec"] in ("sz", "zfp"):
                err = float((y.cpu().double() - xt.cpu().double()).abs().max())
                err_over_eb[name] = err / row["eb"]
                check(err <= row["eb"], f"{name}: max |err| {err} > eb {row['eb']}")
            elif row["codec"] == "none":
                check(torch.equal(_bytes(torch, y), _bytes(torch, xt)), f"{name}: raw leaf not bit for bit")
            else:  # degenerate: the float32 view's bits
                check(torch.equal(_bytes(torch, y.float()), _bytes(torch, xt.float())),
                      f"{name}: degenerate raw leaf changed")
        del flat
        # a raw step carries the same decision cache in its manifest: the
        # fresh manager's restore reloads it without decoding the lossy
        # leaves again (the host decoder's minutes are spent once, above)
        mgr.save(3, perturbed, lossy=lambda name: False)
        fresh = CheckpointManager(config(d), device=dev)
        (step, flat), fresh_restore_ms = _timed(torch, fresh.restore)
        check(step == 3, f"fresh manager restored step {step}")
        for name, x in src.items():
            xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
            check(torch.equal(_bytes(torch, flat[name]), _bytes(torch, xt)),
                  f"{name}: raw step not bit for bit")
        del flat
        fresh.cache.reset_stats()
        _, fresh_ms = _timed(torch, lambda: fresh.save(4, perturbed))
        check(_events(fresh.cache) == {"miss": 0, "hit": lossy, "invalidated": 0},
              f"fresh manager: events {_events(fresh.cache)}")
        thread, enqueue_ms = _timed(torch, lambda: mgr.async_save(5, perturbed))
        _, wait_ms = _timed(torch, mgr.wait)
        check(thread.save_result["path"].endswith("step_000000005"), f"async: {thread.save_result}")
        serial_dir = str(Path(tmp) / "serial")
        serial = CheckpointManager(config(serial_dir, workers=0), device=dev)
        path, serial_ms = _timed(torch, lambda: serial.save(1, tree))
        with open(Path(path) / "data.bin", "rb") as f:
            check(f.read() == step1_data, "workers=0 data.bin differs from the threaded step 1")
    log("ckpt", json.dumps(dict(
        restore_ms=restore_ms, undecoded=CKPT_UNDECODED, max_err_over_eb=err_over_eb,
        fresh_restore_ms=fresh_restore_ms,
        fresh_save_ms=fresh_ms, async_enqueue_ms=enqueue_ms, async_wait_ms=wait_ms,
        serial_save_ms=serial_ms, k1_launches=launches["lorenzo2d_encode"],
        k2_launches=launches["lorenzo3d_encode"], declines=0, card=card)))
    return launches


def _bytes(torch, t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def _leaves(tree):
    from repro_torch.core import pytree as pt

    return [leaf for _, leaf in pt.flatten_with_path(tree)[0]]


def zfp_peak(torch, np, dev) -> dict:
    """Peak device memory of `compress(..., device_encode=True)` and of the
    ZFP device encoder alone on the 100x500x500 HUR_QICE_0 field (the main
    path's ZFP field), for the `repro_torch` on sys.path."""
    from benchmarks.common import hurricane_suite
    from repro_torch.core import Policy, compress, select
    from repro_torch.core import device_encode as de

    x = torch.from_numpy(hurricane_suite(1, size=(100, 500, 500))["QICE_0"]).to(dev)
    sel = select(x, eb_rel=EB_REL, device=dev)
    check(sel.codec == "zfp", f"QICE_0 went to {sel.codec}")
    out = {"field_gib": x.numel() * 4 / 2**30}
    for key, fn in (
        ("compress", lambda: compress(x, Policy.fixed_accuracy(eb_rel=EB_REL),
                                      device_encode=True, device=dev)),
        ("zfp_encode_device", lambda: de.zfp_encode_device(x, sel.eb_abs)),
    ):
        fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{key}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        check(got is not None, f"{key} declined")
    return out


def select_profile(torch, np, dev) -> dict:
    """Where `select_many`'s time goes on the 17 paper-sized fields: the
    host clock of its gather half (`_build_select_members`) and of its
    batches (`_run_select_batches`), each ending in a synchronize, and the
    `torch.profiler` table of one whole call (top ops by device time, then
    by host time), printed before the JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import codecs, selector

    atm, hurricane = paper_fields(np)
    arrs = list(atm.values()) + list(hurricane.values())
    selector.select_many(arrs, eb_rel=EB_REL, device=dev)  # warm-up
    out = {}
    for rep in range(2):
        results = [None] * len(arrs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        groups = selector._build_select_members(
            arrs, range(len(arrs)), results, None, EB_REL, 0.05, "zfp", codecs.DEFAULT_CODECS, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        selector._run_select_batches(groups, results, 0.05, "zfp", codecs.DEFAULT_CODECS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[f"gather_ms_{rep}"] = (t1 - t0) * 1e3
        out[f"batches_ms_{rep}"] = (t2 - t1) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        selector.select_many(arrs, eb_rel=EB_REL, device=dev)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    print(avg.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    print(avg.table(sort_by="cpu_time_total", row_limit=25), flush=True)
    return out


def bot_times(torch, np, dev) -> dict:
    """Device ms of K5 and K6 at the KV path's shapes and on one block, and
    the host ms of one K6 call through `ops.bot_fused` ending in a
    synchronize (the evict's "K6 + sync" step; median of 200), for the
    `repro_torch` on sys.path; and, as the floor of any launch, the device ms
    of PyTorch's fill of one value."""
    from repro_torch.kernels import bot4, ops

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    out = {}
    for name, shape in (("bot2d_fused", K5_PATH_SHAPE), ("bot3d_fused", K6_PATH_SHAPE)):
        kernel = getattr(bot4, name)
        page, eb, block = bot_path_case(torch, np, dev, shape)
        out[f"{name}_ms"] = time_ms(torch, lambda: kernel(page, eb), flush)
        out[f"{name}_block_ms"] = time_ms(torch, lambda: kernel(block, eb), flush)
    host = []  # the last page is K6's
    for _ in range(200):
        t = time.perf_counter()
        ops.bot_fused(page, eb)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    out["bot3d_fused_call_sync_host_ms"] = statistics.median(host)
    tiny = torch.empty(1, device=dev)
    out["one_value_fill_ms"] = time_ms(torch, tiny.zero_, flush)  # any launch's floor
    return out


def kv_times(torch, np, dev) -> dict:
    """The KV phase alone (`phase_kv`): its evict, re-evict and restore
    medians and the evict's step medians, host ms."""
    out = {}
    phase_kv(torch, np, dev, out)
    return out


def lorenzo_times(torch, np, dev) -> dict:
    """Device ms of K1 and K2 at the main path's shapes and at one small
    shape, each after a check that the kernel equals its plain version
    there, for the `repro_torch` on sys.path; and the device ms of
    PyTorch's fill of one value, the floor of any launch."""
    from repro_torch.kernels import lorenzo, ref

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    out = {**lorenzo_runs()}
    for name, shapes in (("lorenzo2d_encode", (K1_SHAPES[0], K1_SMALL)),
                         ("lorenzo3d_encode", (K2_SHAPES[0], K2_SMALL))):
        kernel = getattr(lorenzo, name)
        for suffix, shape in zip(("", "_small"), shapes):
            x, eb = tie_field(np, shape, 99)
            xt = torch.from_numpy(x).to(dev)
            check(torch.equal(kernel(xt, eb), ref.lorenzo_encode_ref(xt, eb)),
                  f"{name} differs from its plain version at {shape}")
            out[f"{name}{suffix}_ms"] = time_ms(torch, lambda: kernel(xt, eb), flush)
    tiny = torch.empty(1, device=dev)
    out["one_value_fill_ms"] = time_ms(torch, tiny.zero_, flush)
    return out


# ---------------------------------------------------------------------------
# [sharded]: the shard-local engine and the multi-host checkpoint, 4 ranks
# ---------------------------------------------------------------------------

#: 4 ranks share the card: NCCL refuses two ranks on one GPU, so gloo
SHARDED_RANKS, SHARDED_BACKEND, SHARDED_MESH = 4, "gloo", (2, 2)
#: NYX-like volumes at the paper's size (`benchmarks/common.py`), made at
#: the phase's start, one process a volume, before anything is timed
NYX_FIELDS, NYX_SIZE = 2, (512, 512, 512)
#: layouts over ('data', 'model'): three ATM fields split by rows over
#: 'data' (900-row shards, replicated over 'model'), one over both (900 x
#: 1800), the NYX volumes over both (256 x 256 x 512), every Hurricane
#: field over 'data' on dim 1 (250 wide: not 4-aligned, so gathered), a
#: small replicated leaf
SHARDED_LAYOUTS = {
    "ATM_00": ("data", None), "ATM_01": ("data", None), "ATM_02": ("data", None),
    "ATM_03": ("data", "model"), "nyx": ("data", "model", None),
    "hur": (None, "data", None), "norm": (None,),
}
#: the elastic restore's subset: the host Huffman decoder takes 11-64 s a
#: field, so the restore reads the fields whose shards each rank decodes
#: in seconds; the save is never cut
SHARDED_RESTORE = ("atm/ATM_00", "atm/ATM_03", "norm")
SHARDED_TIMEOUT_S = 300.0
STATE_ARCH = "smollm-360m"


def sharded_dir() -> Path:
    return ROOT / "build" / "sharded"


def start_nyx() -> list:
    """Start one process a NYX field, each writing its volume as .npy under
    `sharded_dir()/fields` (numpy's FFT, ~45 s a 512^3 field;
    `start_suite_fields`)."""
    import shutil

    import numpy as np

    out = sharded_dir() / "fields"
    shutil.rmtree(sharded_dir(), ignore_errors=True)
    out.mkdir(parents=True)
    check_suite_fields(np, "nyx", NYX_FIELDS)
    return start_suite_fields("nyx", NYX_FIELDS, NYX_SIZE, out, prefix="nyx_")


#: K1/K2 at the shard shapes the [sharded] save encodes: an ATM field's
#: 900-row and 900 x 1800 shards, a NYX volume's 256 x 256 x 512
SHARD_KERNEL_SHAPES = (("lorenzo2d_encode", (900, 3600)), ("lorenzo2d_encode", (900, 1800)),
                       ("lorenzo3d_encode", (256, 256, 512)))


def shard_kernel_times(torch, np, dev) -> list:
    """K1/K2 at `SHARD_KERNEL_SHAPES`, each exact against its plain version
    first: device ms (`time_ms`), plain ms and the bound."""
    from repro_torch.kernels import lorenzo, ref

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows = []
    for i, (name, shape) in enumerate(SHARD_KERNEL_SHAPES):
        kernel = getattr(lorenzo, name)
        x, eb = tie_field(np, shape, 200 + i)
        xt = torch.from_numpy(x).to(dev)
        eb_dev = torch.tensor(eb, dtype=torch.float32, device=dev)
        err = int((kernel(xt, eb).long() - ref.lorenzo_encode_ref(xt, eb_dev).long()).abs().max())
        check(err == 0, f"{name} differs from its plain version at {shape}: {err}")
        ms = time_ms(torch, lambda: kernel(xt, eb), flush)
        plain_ms = time_ms(torch, lambda: ref.lorenzo_encode_ref(xt, eb_dev), flush)
        bound_ms, bound_by = bound(name, shape)
        rows.append(dict(name=name, shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        log("sharded-kernels", json.dumps(rows[-1]))
    del flush
    return rows


def _selection_record(s) -> dict:
    return dict(codec=s.codec, eb_abs=s.eb_abs, eb_sz=s.eb_sz, br_sz=s.br_sz,
                br_zfp=s.br_zfp, psnr_target=s.psnr_target, vr=s.vr, r_sp=s.r_sp)


def phase_sharded(torch, np, dev, atm, hurricane, card) -> dict:
    """`[sharded]`: four ranks on the one card through `launch/mhrun.py`
    (gloo, a (2, 2) ('data', 'model') mesh), each mapping only its own
    shard of the 17 paper fields and two 512^3 NYX volumes onto the card
    (made first, while the paper fields are written out: set-up, untimed).
    `plan_tree` under samples and stats at eb_rel 1e-4 and under samples at
    fixed_psnr(60) is held to the card's unsharded `select_many` /
    `solve_many` (samples equal, stats to the golden tolerances), the same
    on every rank; a cooperative `CheckpointConfig(sharded=True,
    device_encode=True)` save (per-host files, commit markers, the v3
    manifest; K1/K2 counted on every rank); an elastic `restore_tree` of
    `SHARDED_RESTORE` under (4, 1), within eb; then smollm-360m's params
    and AdamW moments laid out by `TRAIN_RULES`, saved raw and restored
    under (1, 4) bit for bit. Returns the phase's K1/K2 launches."""
    from repro_torch.core import Policy, select_many, solve_many
    from repro_torch.launch import mhrun

    free_card(torch)
    fdir = sharded_dir() / "fields"
    t0 = time.perf_counter()
    procs = start_nyx()
    try:
        fields: dict = {}
        for name, x in atm.items():
            np.save(fdir / f"atm_{name}.npy", x)
            fields[f"atm/{name}"] = (str(fdir / f"atm_{name}.npy"), SHARDED_LAYOUTS[name])
        for name, x in hurricane.items():
            np.save(fdir / f"hur_{name}.npy", x)
            fields[f"hur/{name}"] = (str(fdir / f"hur_{name}.npy"), SHARDED_LAYOUTS["hur"])
        for p in procs:
            p.wait(timeout=600)
            check(p.returncode == 0, f"NYX field generation failed ({p.returncode})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for path in sorted(fdir.glob("nyx_*.npy")):
        fields[f"nyx/{path.stem[4:]}"] = (str(path), SHARDED_LAYOUTS["nyx"])
    check(sum(k.startswith("nyx/") for k in fields) == NYX_FIELDS, "NYX fields missing")
    np.save(fdir / "norm.npy", np.linspace(0.9, 1.1, 4096, dtype=np.float32))
    fields["norm"] = (str(fdir / "norm.npy"), SHARDED_LAYOUTS["norm"])
    write_s = time.perf_counter() - t0
    shard_kernel_times(torch, np, dev)
    # the unsharded baseline on the card: the same fields, in the same order,
    # from host memory
    arrays = [np.load(p) for p, _ in fields.values()]
    nbytes = sum(a.nbytes for a in arrays)
    pol = Policy.fixed_accuracy(eb_rel=EB_REL)
    base, base_ms = {}, {}
    for mode, run in (("fixed_accuracy", lambda: select_many(arrays, policy=pol, device=dev)),
                      ("fixed_psnr", lambda: [s.selection for s in solve_many(
                          arrays, Policy.fixed_psnr(60.0), device=dev)])):
        sels, base_ms[mode] = _timed(torch, run)
        base[mode] = [_selection_record(s) for s in sels]
    del arrays
    free_card(torch)
    log("sharded", f"{len(fields)} fields, {nbytes / 1e9:.2f} GB written as .npy in "
        f"{write_s:.1f} s; unsharded select_many {base_ms['fixed_accuracy']:.1f} ms, "
        f"solve_many(fixed_psnr 60) {base_ms['fixed_psnr']:.1f} ms on the card")
    ckpt = sharded_dir() / "ckpt"
    t0 = time.perf_counter()
    results = mhrun.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-worker"], SHARDED_RANKS,
        scenario="sharded", backend=SHARDED_BACKEND, timeout_s=SHARDED_TIMEOUT_S,
        workdir=str(sharded_dir() / "mhrun"), build_kernels=True,
        args=dict(fields=fields, base=base, ckpt=str(ckpt), state_ckpt=str(sharded_dir() / "state")),
    )
    job_s = time.perf_counter() - t0
    payloads = mhrun.require_success(results)
    p0 = payloads[0]
    log("sharded", f"backend {p0['backend']}, ranks {[p['rank'] for p in payloads]}, mesh "
        f"{p0['mesh']}, job {job_s:.1f} s")
    log("sharded", json.dumps(dict(shard_local=p0["paths"]["shard-local"],
                                   gathered=p0["paths"]["gather"])))
    for p in payloads[1:]:
        check(p["decisions"] == p0["decisions"], f"rank {p['rank']} holds other decisions")
    for p in payloads:
        check(not p["mismatches"], f"rank {p['rank']}: decisions off the unsharded ones: "
              f"{p['mismatches'][:3]}")
    for mode in ("samples", "stats", "fixed_psnr"):
        unsharded = base_ms["fixed_psnr" if mode == "fixed_psnr" else "fixed_accuracy"]
        log("sharded", json.dumps(dict(
            mode=mode, plan_ms=max(p["plan_ms"][mode] for p in payloads),
            plan_ms_by_rank=[p["plan_ms"][mode] for p in payloads], unsharded_ms=unsharded,
            equal=p0["equal"][mode], fields=len(fields))))
    # where the samples time goes: the gloo staging of the gathered fields
    # alone, and the engine on the shard-local fields alone
    log("sharded", json.dumps(dict(
        gather_ms=max(p["gather_ms"] for p in payloads), gathered_gb=p0["gathered_gb"],
        plan_ms_shard_local=max(p["plan_ms_local"] for p in payloads),
        shard_local_fields=len(p0["paths"]["shard-local"]))))
    # the cooperative save: per-host files, commit markers, the v3 manifest
    step = ckpt / "step_000000001"
    with open(step / "manifest.json") as f:
        man = json.load(f)
    check(man["version"] == 3 and man["layout"] == "segments", "sharded manifest is not v3 segments")
    check(man["hosts"] == list(range(SHARDED_RANKS)), f"manifest hosts {man['hosts']}")
    host_bytes = {}
    for h in man["hosts"]:
        check((step / f"commit.{h}").exists(), f"commit.{h} missing")
        host_bytes[h] = (step / f"data.{h}.bin").stat().st_size
        check(host_bytes[h] == man["completion"][str(h)], f"data.{h}.bin size off its completion")
    launches = {k: sum(p["launches"][k] for p in payloads)
                for k in ("lorenzo2d_encode", "lorenzo3d_encode")}
    for name, n in launches.items():
        check(n >= 1, f"[sharded]: {name} never launched by the save")
    for p in payloads:
        check(not p["declines"], f"rank {p['rank']}: device encode declined {p['declines']}")
    log("sharded", json.dumps(dict(
        save_ms=max(p["save_ms"] for p in payloads), save_ms_by_rank=[p["save_ms"] for p in payloads],
        data_bytes=man["total_bytes"], raw_bytes=man["raw_bytes"],
        ratio=man["raw_bytes"] / man["total_bytes"], bytes_by_host=host_bytes,
        codecs={k: sum(fl["codec"] == k for fl in man["fields"]) for k in ("sz", "zfp", "raw")},
        k1_by_rank=[p["launches"]["lorenzo2d_encode"] for p in payloads],
        k2_by_rank=[p["launches"]["lorenzo3d_encode"] for p in payloads], declines=0, card=card)))
    log("sharded", json.dumps(dict(
        restore="(4, 1)", fields=list(SHARDED_RESTORE),
        restore_ms=max(p["restore_ms"] for p in payloads),
        max_err_over_eb=max(max(p["restore_err"].values()) for p in payloads),
        segments_decoded=[p["restore_stats"]["segments_decoded"] for p in payloads])))
    log("sharded-state", json.dumps(dict(
        arch=STATE_ARCH, params=p0["state"]["params"], state_gb=p0["state"]["bytes"] / 1e9,
        save_ms=max(p["state"]["save_ms"] for p in payloads),
        restore_ms=max(p["state"]["restore_ms"] for p in payloads),
        restore="(1, 4)", bit_for_bit=all(p["state"]["equal"] for p in payloads),
        leaves_split=p0["state"]["split"], leaves=p0["state"]["leaves"])))
    for p in payloads:
        check(p["state"]["equal"], f"rank {p['rank']}: the train state did not restore bit for bit")
    log("sharded", json.dumps(dict(
        peak_gib_by_rank=[p["peak_gib"] for p in payloads],
        rank_s=[p["seconds"] for p in payloads], card=card)))
    import shutil

    shutil.rmtree(sharded_dir(), ignore_errors=True)
    return launches


def sharded_worker(spec: dict, rank: int) -> dict:
    """One rank of `[sharded]` (`phase_sharded` says what it checks)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import Policy
    from repro_torch.core import device_encode as de
    from repro_torch.core import sharded as shd
    from repro_torch.kernels import lorenzo
    from repro_torch.launch.mesh import describe_mesh, make_emulated_mesh
    from repro_torch.models import build_model
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import dist
    from repro_torch.runtime import sharding as rsh

    t_start = time.perf_counter()
    torch.set_num_threads(2)  # four ranks share the host's cores
    a = spec["args"]
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    mesh = make_emulated_mesh(SHARDED_MESH)
    mesh41 = make_emulated_mesh((4, 1))
    mesh14 = make_emulated_mesh((1, 4))

    def lay(m, spec_):
        return rsh.NamedSharding(m, rsh.spec_to_placements(m, tuple(spec_)))

    names = list(a["fields"])
    src = {k: np.load(path, mmap_mode="r") for k, (path, _) in a["fields"].items()}
    leaves = {k: dist.put_global(src[k], lay(mesh, sp)) for k, (_, sp) in a["fields"].items()}
    torch.cuda.synchronize()

    def timed(fn):
        dist.barrier("sharded:timed", 300.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    pol = Policy.fixed_accuracy(eb_rel=EB_REL)
    runs = {"samples": (pol, "samples", "fixed_accuracy"), "stats": (pol, "stats", "fixed_accuracy"),
            "fixed_psnr": (Policy.fixed_psnr(60.0), "auto", "fixed_psnr")}
    plan_ms, decisions, equal, mismatches, paths = {}, {}, {}, [], {}
    for mode, (p_, rec, base_key) in runs.items():
        plans, plan_ms[mode] = timed(
            lambda: shd.plan_tree([leaves[k] for k in names], p_, reconcile=rec))
        got = [_selection_record(p.selection) for p in plans]
        decisions[mode] = got
        want = a["base"][base_key]
        n_eq = 0
        for k, g, w in zip(names, got, want):
            if mode == "stats":
                ok = (g["codec"] == w["codec"] and g["eb_abs"] == w["eb_abs"]
                      and abs(g["eb_sz"] - w["eb_sz"]) <= EB_SZ_RTOL * abs(w["eb_sz"])
                      and abs(g["br_sz"] - w["br_sz"]) <= BR_ATOL
                      and abs(g["br_zfp"] - w["br_zfp"]) <= BR_ATOL)
            else:
                ok = g == w
            n_eq += ok
            if not ok:
                mismatches.append((mode, k, g, w))
        equal[mode] = n_eq
        if mode == "samples":
            paths = {"shard-local": [k for k, p in zip(names, plans) if p.path == "shard-local"],
                     "gather": [k for k, p in zip(names, plans) if p.path == "gather"]}
    del plans  # each holds its gathered fields' host copies
    # the samples time taken apart: the gathered fields' gloo staging alone
    # (every rank receives each whole field through the host), and the
    # engine on the shard-local fields alone
    gathered, gather_ms = timed(lambda: [dist.gather(leaves[k]) for k in paths["gather"]])
    gathered_gb = sum(g.numel() * g.element_size() for g in gathered) / 1e9
    del gathered
    _, plan_ms_local = timed(lambda: shd.plan_tree(
        [leaves[k] for k in paths["shard-local"]], pol, reconcile="samples"))
    # the cooperative save, every field lossy at eb_rel 1e-4, device encode
    tree = {}
    for k in names:
        node = tree
        *parents, leaf = k.split("/")
        for p_ in parents:
            node = node.setdefault(p_, {})
        node[leaf] = leaves[k]
    mgr = CheckpointManager(CheckpointConfig(a["ckpt"], policy=pol, sharded=True,
                                             device_encode=True, workers=4,
                                             barrier_timeout_s=300.0), device=dev)
    lorenzo.reset_launches()
    de.DECLINES.clear()
    _, save_ms = timed(lambda: mgr.save(1, tree))
    launches = dict(lorenzo.LAUNCHES)
    declines = dict(de.DECLINES)
    # the elastic restore of the subset under (4, 1)
    want_tree = {}
    shardings = {}
    for k in SHARDED_RESTORE:
        node, snode = want_tree, shardings
        *parents, leaf = k.split("/")
        for p_ in parents:
            node, snode = node.setdefault(p_, {}), snode.setdefault(p_, {})
        node[leaf] = leaves[k]
        snode[leaf] = lay(mesh41, a["fields"][k][1])
    (_, restored), restore_ms = timed(lambda: mgr.restore_tree(want_tree, shardings=shardings))
    with open(os.path.join(a["ckpt"], "step_000000001", "manifest.json")) as f:
        ebs = {fl["name"]: fl["eb"] for fl in json.load(f)["fields"]}
    errs = {}
    for k in SHARDED_RESTORE:
        node = restored
        for part in k.split("/"):
            node = node[part]
        check(node.device_mesh is mesh41, f"{k}: not on the (4, 1) mesh")
        st, sp = rsh.local_box(lay(mesh41, a["fields"][k][1]), tuple(src[k].shape))
        box = torch.from_numpy(np.array(src[k][tuple(slice(x, y) for x, y in zip(st, sp))]))
        err = float((node.to_local().cpu().double() - box.double()).abs().max())
        errs[k] = err / ebs[k]
        check(err <= ebs[k], f"{k}: restored max |err| {err} > eb {ebs[k]}")
    restore_stats = mgr.last_restore_stats
    del leaves, restored, tree, want_tree
    torch.cuda.empty_cache()
    # a training state laid out by the model's own rules, saved raw, restored
    # under (1, 4) bit for bit
    cfg = get_config(STATE_ARCH)
    desc = build_model(cfg, device=dev).desc()
    axes, abstract = mnn.axes_tree(desc), mnn.abstract_tree(desc)
    full = {"params": mnn.init_tree(desc, torch.Generator(device=dev).manual_seed(0), device=dev)}
    gen = torch.Generator(device=dev).manual_seed(1)
    full["opt"] = {
        "m": mnn.tree_map(lambda p: 1e-3 * torch.randn(p.shape, generator=gen, device=dev), full["params"]),
        "v": mnn.tree_map(lambda p: 1e-6 * torch.rand(p.shape, generator=gen, device=dev), full["params"]),
    }
    lay22 = rsh.tree_shardings(axes, rsh.TRAIN_RULES, mesh, abstract)
    lay14 = rsh.tree_shardings(axes, rsh.TRAIN_RULES, mesh14, abstract)
    state_lay = {"params": lay22, "opt": {"m": lay22, "v": lay22}}
    state14 = {"params": lay14, "opt": {"m": lay14, "v": lay14}}
    flat_full = _flat(full)
    flat_lay = _flat(state_lay)
    state = _nest({k: dist.put_global(v, flat_lay[k]) for k, v in flat_full.items()})
    smgr = CheckpointManager(CheckpointConfig(a["state_ckpt"], sharded=True, workers=4,
                                              barrier_timeout_s=300.0), device=dev)
    _, s_save_ms = timed(lambda: smgr.save(1, state, lossy=lambda name: False))
    (_, back), s_restore_ms = timed(lambda: smgr.restore_tree(state, shardings=state14))
    flat_14 = _flat(state14)
    equal_state = True
    for k, v in _flat(back).items():
        st, sp = rsh.local_box(flat_14[k], tuple(flat_full[k].shape))
        box = flat_full[k][tuple(slice(x, y) for x, y in zip(st, sp))]
        equal_state &= bool(v.device_mesh is mesh14 and torch.equal(v.to_local(), box))
    n_params = sum(v.numel() for k, v in flat_full.items() if k.startswith("params/"))
    state_rec = dict(
        params=n_params, bytes=sum(v.numel() * v.element_size() for v in flat_full.values()),
        save_ms=s_save_ms, restore_ms=s_restore_ms, equal=equal_state,
        leaves=len(flat_full),
        split=sum(any(isinstance(p, Shard) for p in s.placements) for s in flat_lay.values()),
    )
    return dict(
        rank=rank, backend=dist.backend(), mesh=describe_mesh(mesh)["shape"], plan_ms=plan_ms,
        gather_ms=gather_ms, gathered_gb=gathered_gb, plan_ms_local=plan_ms_local,
        decisions=decisions, equal=equal, mismatches=mismatches[:8], paths=paths,
        save_ms=save_ms, launches=launches, declines=declines, restore_ms=restore_ms,
        restore_err=errs, restore_stats=restore_stats, state=state_rec,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        seconds=time.perf_counter() - t_start,
    )


def _flat(tree) -> dict:
    from repro_torch.core import pytree as pt

    return {pt.leaf_name(p): v for p, v in pt.flatten_with_path(tree)[0]}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split("/")
        for p_ in parents:
            node = node.setdefault(p_, {})
        node[leaf] = v
    return out


def sharded_only(torch, np, dev) -> dict:
    """`[sharded]` alone: the paper fields, then the phase."""
    atm, hurricane = paper_fields(np)
    return {"launches": phase_sharded(torch, np, dev, atm, hurricane, card_line())}


# ---------------------------------------------------------------------------
# [mesh-serve] and [mesh-moe]: decoders served under SERVE_RULES, 4 ranks
# ---------------------------------------------------------------------------

#: phi4-mini-3.8b at full width and 4 of its 32 layers on a (2, 2)
#: ('data', 'model') mesh of 4 ranks sharing the card over gloo; a prefill
#: of 4 x 64 tokens, 8 decode steps fed the unsharded run's greedy tokens,
#: then 8 greedy ones (the depth cut pays for `[mesh-moe]` and
#: `[mesh-families]`)
MESH_SERVE_ARCH, MESH_SERVE_MESH, MESH_SERVE_RANKS = "phi4-mini-3.8b", (2, 2), 4
MESH_SERVE_LAYERS = 4
#: `[mesh-moe]`: deepseek-v2-236b at full width and 2 of its 60 layers (the
#: leading dense layer in `dense_blocks` and one MoE layer, both MLA) served
#: as `[mesh-serve]` serves phi4-mini
MESH_MOE_ARCH, MESH_MOE_LAYERS = "deepseek-v2-236b", 2
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_FORCED, MESH_SERVE_FREE = 4, 64, 8, 8
#: max(2e-2, d) of max|logit| per step, d the reference's own distance
#: between its sharded and unsharded bfloat16 runs of the reduced model on
#: these meshes (0.0096-0.0104, tests/test_torch_mesh.py)
MESH_SERVE_RTOL = 2e-2
MESH_SERVE_TIMEOUT_S = 600.0


def mesh_serve_dir() -> Path:
    return ROOT / "build" / "mesh_serve"


def _mesh_serve_args(device: str, arch: str, smoke: bool, prompt: int = MESH_SERVE_PROMPT,
                     steps: int = MESH_SERVE_FORCED + MESH_SERVE_FREE):
    from repro_torch.launch import serve

    return serve.parse_args(["--arch", arch, "--device", device, "--batch", str(MESH_SERVE_BATCH),
                             "--prompt-len", str(prompt), "--gen", str(1 + steps)]
                            + (["--smoke"] if smoke else []))


def _mesh_serve_build(torch, args, mesh=None, **cut):
    """`launch.serve.build(args, mesh)` with the config cut in depth by
    `cut` (`n_layers`, `n_enc_layers`: serve's launcher has no depth flag):
    (cfg, model, params), the params from a generator seeded 0, laid out
    by `SERVE_RULES` on `mesh` when given."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import sharding as rsh

    cfg = get_config(args.arch)
    cfg = (reduced_for_smoke(cfg) if args.smoke else cfg).scaled(**cut)
    model = build_model(cfg, device=args.device)
    if mesh is not None:
        return cfg, model, rsh.place_params(model, mesh, rsh.SERVE_RULES)
    gen = torch.Generator(device=model.device).manual_seed(0)
    return cfg, model, mnn.init_tree(model.desc(), gen, device=model.device)


def _cache_stacks(cache) -> dict:
    """The cache's stacked leaves by name ('blocks/k', 'dense_blocks/ckv',
    ...), without the clock."""
    return {k: v for k, v in _flat(cache).items() if k != "pos"}


def _choices_differ(np, got, want) -> float:
    """The share of tokens whose set of experts differs between two runs'
    expert choices, (B, L, k) each."""
    g, w = np.sort(np.asarray(got), axis=-1), np.sort(np.asarray(want), axis=-1)
    return float(np.mean(np.any(g != w, axis=-1)))


def _margin(np, row) -> float:
    top = np.partition(np.asarray(row, np.float64), -2)[-2:]
    return float(top[1] - top[0])


def phase_mesh_serve(torch, np, dev, card, arch: str = MESH_SERVE_ARCH, smoke: bool = False,
                     n_layers: int = MESH_SERVE_LAYERS, tag: str = "mesh-serve") -> dict:
    """`[mesh-serve]` (and `[mesh-moe]`, `tag`): `arch` at full width and
    `n_layers` layers served unsharded on the card by
    `launch.serve.run_static` (prefill of 4 x 64, 16 greedy decode steps),
    its last-position logits, tokens and cache kept on the host (and, for
    an MoE, each forced step's expert choices, `blocks.ROUTING_LOG`); then
    the card freed and four ranks (`launch/mhrun.py`, gloo) serving it
    through `run_static(mesh=)` on a (2, 2) ('data', 'model') mesh under
    `SERVE_RULES`, params drawn from the same generator and kept by box:
    the same prefill, 8 decode steps fed the unsharded greedy tokens
    (every step's logits within `MESH_SERVE_RTOL` of max|logit| of the
    unsharded step's), then 8 greedy steps (the tokens that differ printed
    with the unsharded top-2 margin). Every param and cache leaf must keep
    the placements the rules give, and the gathered cache's rows written
    by the forced steps (every stack's, the MLA latent too) must equal the
    unsharded cache's within the same bound. Prints prefill and decode ms
    (the maximum over ranks) beside the unsharded run's, the collectives
    of one prefill and one decode step by kind, the share of tokens whose
    experts differ from the unsharded run's at the forced steps, and the
    peak memory of each rank. No kernel of K1-K6 runs here."""
    import shutil

    from repro_torch.launch import mhrun, serve
    from repro_torch.models import blocks

    free_card(torch)
    wd = mesh_serve_dir()
    shutil.rmtree(wd, ignore_errors=True)
    wd.mkdir(parents=True)
    args = _mesh_serve_args(dev.type, arch, smoke)
    cfg, model, params = _mesh_serve_build(torch, args, n_layers=n_layers)
    n_params = sum(a.numel() for a in _leaves(params))
    blocks.ROUTING_LOG = [] if cfg.moe else None
    try:
        base = serve.run_static(args, cfg, model, params, keep=True)
        if cfg.moe:  # the prefill's and the forced steps' choices, a layer each
            n_moe = cfg.n_layers - cfg.moe.n_dense_layers
            np.savez(wd / "choices.npz", *[
                t.cpu().numpy() for t in blocks.ROUTING_LOG[: n_moe * (1 + MESH_SERVE_FORCED)]])
    finally:
        blocks.ROUTING_LOG = None
    base_ms = dict(prefill_ms=base["prefill_s"] * 1e3,
                   decode_ms_per_step=base["decode_s"] * 1e3 / (args.gen - 1))
    np.save(wd / "tokens.npy", base["tokens"])
    np.save(wd / "logits.npy", np.stack([t.numpy() for t in base["logits"]]))
    torch.save({k: v.cpu() for k, v in _cache_stacks(base["cache"]).items()}, wd / "cache.pt")
    del model, params, base["cache"]
    free_card(torch)
    t0 = time.perf_counter()
    results = mhrun.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-serve-worker"], MESH_SERVE_RANKS,
        scenario="mesh_serve", backend="gloo", timeout_s=MESH_SERVE_TIMEOUT_S,
        workdir=str(wd / "mhrun"), extra_env={"OMP_NUM_THREADS": "2"},
        args=dict(arch=arch, smoke=smoke, device=dev.type, dir=str(wd), n_layers=n_layers),
    )
    job_s = time.perf_counter() - t0
    payloads = mhrun.require_success(results)
    p0 = payloads[0]
    steps = 1 + MESH_SERVE_FORCED
    rel = p0["rel"]
    for p in payloads:
        check(p["tokens"] == p0["tokens"], f"rank {p['rank']} holds other tokens")
        check(not p["param_misplaced"], f"rank {p['rank']}: params off their rules' placements: "
              f"{p['param_misplaced'][:4]}")
        check(not p["cache_misplaced"], f"rank {p['rank']}: cache off cache_sharding's placements: "
              f"{p['cache_misplaced']}")
    check(len(rel) == steps, f"{len(rel)} logits compared, want {steps}")
    for i, d in enumerate(rel):
        check(d <= MESH_SERVE_RTOL, f"step {i}: sharded logits {d:.4g} of max|logit| off the "
              f"unsharded run's (bound {MESH_SERVE_RTOL})")
    experts = {tuple(e) for e in p0["expert_shards"]}
    expert_gathers = [g for p in payloads for g in p["staged_gathers"]
                      if tuple(g[1][-3:]) in experts]
    check(not expert_gathers, f"expert weights gathered: {expert_gathers[:4]}")
    for k, d in p0["cache_rel"].items():
        check(d <= MESH_SERVE_RTOL, f"cache {k}: {d:.4g} of max|cache| off the unsharded cache")
    want = np.load(wd / "tokens.npy")
    logits = np.load(wd / "logits.npy", mmap_mode="r")
    got = np.asarray(p0["tokens"])
    differ = [dict(row=int(r), step=int(c), sharded=int(got[r, c]), unsharded=int(want[r, c]),
                   unsharded_top2_margin=_margin(np, logits[c, r]))
              for r, c in zip(*np.nonzero(got != want))]
    log(tag, json.dumps(dict(
        arch=arch, layers=n_layers, params=n_params, mesh=p0["mesh"], backend=p0["backend"],
        ranks=len(payloads), job_s=job_s, rel_by_step=rel, bound=MESH_SERVE_RTOL,
        cache_rel=p0["cache_rel"], placements_ok=True, leaves=p0["leaves"], card=card)))
    log(tag, json.dumps(dict(tokens_differ=differ, forced_steps=MESH_SERVE_FORCED,
                             free_steps=MESH_SERVE_FREE)))
    routing = None
    if cfg.moe:
        with np.load(wd / "choices.npz") as z:
            want_choices = [z[f"arr_{i}"] for i in range(len(z.files))]
        check(len(p0["choices"]) == len(want_choices),
              f"{len(p0['choices'])} MoE routings recorded, want {len(want_choices)}")
        routing = [_choices_differ(np, g, w) for g, w in zip(p0["choices"], want_choices)]
        log(tag, json.dumps(dict(expert_choices_differ_by_step=routing,
                                 tokens_a_step=[int(np.prod(w.shape[:2])) for w in want_choices],
                                 top_k=cfg.moe.top_k, experts=cfg.moe.n_experts)))
    log(tag, json.dumps(dict(
        prefill_ms=max(p["prefill_ms"] for p in payloads),
        decode_ms_per_step=max(p["decode_ms"] for p in payloads),
        prefill_ms_by_rank=[p["prefill_ms"] for p in payloads],
        decode_ms_by_rank=[p["decode_ms"] for p in payloads],
        unsharded=base_ms, collectives_prefill=p0["comm_prefill"],
        collectives_decode_step=p0["comm_decode"],
        staged_gathers_by_dim={dim: sum(g[0] == dim for g in p0["staged_gathers"])
                               for dim in ("data", "model")},
        staged_gather_shapes=sorted({str(g[1]) for g in p0["staged_gathers"]}),
        expert_weight_gathers=len(expert_gathers),
        peak_gib_by_rank=[p["peak_gib"] for p in payloads], card=card)))
    if p0["trace"] is not None:
        log(tag, json.dumps(dict(traced_decode_step_rank0=p0["trace"], card=card)))
    shutil.rmtree(wd, ignore_errors=True)
    return dict(rel=rel, differ=len(differ), routing=routing, job_s=job_s)


def _mesh_step_trace(torch, step, traced: bool) -> dict | None:
    """One sharded decode step, traced by `torch.profiler` where `traced`
    (the other ranks run it plain, meeting it in its collectives): wall
    ms, device busy ms and idle share, kernels, the host ms of the gloo
    collectives (the ops named all_reduce, allreduce, allgather or wait),
    and the 10 ops with the most host self time."""
    if not traced:
        step()
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    avgs = prof.key_averages()
    comm = [e for e in avgs if any(w in e.key.lower()
                                   for w in ("all_reduce", "allreduce", "allgather", "wait"))]
    top = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
                kernels=len(kernels),
                collective_host_ms={e.key: e.self_cpu_time_total / 1e3 for e in comm},
                top_host_self_ms={e.key: e.self_cpu_time_total / 1e3 for e in top},
                top_calls={e.key: e.count for e in top})


#: redistributions of CUDA tensors over gloo: DTensor's own all-reduce of
#: a bfloat16 pending sum and all-gather of a split (which the path never
#: asks DTensor for), and the split gathered as `sharding.redistribute`
#: does it (`dist.all_gather` staged through the host): name -> (dtype,
#: the local shard's placement over 'model')
GLOO_PROBES = {"all_reduce_bf16": ("bfloat16", "partial"), "all_gather_f32": ("float32", "shard"),
               "staged_all_gather_f32": ("float32", "staged")}


def gloo_probe_worker(spec: dict, rank: int) -> dict:
    """One rank of a `GLOO_PROBES` case on a (1, 2) mesh: a pending sum or
    a split over 'model' redistributed to Replicate by DTensor itself."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.runtime import sharding as rsh

    dtype, kind = GLOO_PROBES[spec["args"]["case"]]
    mesh = make_emulated_mesh((1, 2))
    dev = torch.device("cuda", torch.cuda.current_device())
    if kind == "partial":
        local = torch.full((4, 8), 0.25 * (rank + 1), dtype=getattr(torch, dtype), device=dev)
        placements, want = (Replicate(), Partial()), torch.full((4, 8), 0.75)
    else:  # a split over 'model', gathered by DTensor or by the port
        local = torch.arange(8, dtype=getattr(torch, dtype), device=dev).reshape(2, 4) + 8 * rank
        placements, want = (Replicate(), Shard(0)), torch.arange(16.0).reshape(4, 4)
    x = DTensor.from_local(local, mesh, placements, run_check=False)
    if kind == "staged":
        got = rsh.redistribute(x, (Replicate(), Replicate())).to_local()
    else:
        got = x.redistribute(mesh, (Replicate(), Replicate())).to_local()
    return {"equal": bool(torch.equal(got.float().cpu(), want))}


def gloo_cuda_probes() -> dict:
    """Each `GLOO_PROBES` case as its own 2-rank job on the card (a crash
    ends only that job): "ok", "wrong values", the error, or the exit
    code of a rank that died."""
    from repro_torch.launch import mhrun

    out = {}
    for case in GLOO_PROBES:
        res = mhrun.run([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-serve-worker"], 2,
                        scenario="gloo_probe", backend="gloo", timeout_s=120.0,
                        workdir=str(mesh_serve_dir() / f"probe_{case}"), args={"case": case})
        bad = [r for r in res if not r.ok]
        if not bad:
            out[case] = "ok" if all(r.result["equal"] for r in res) else "wrong values"
        else:
            r = bad[0]
            out[case] = (r.result or {}).get("error") or f"rank {r.process_id} died, exit {r.returncode}"
    return out


def mesh_serve_worker(spec: dict, rank: int) -> dict:
    """One rank of `[mesh-serve]` (`phase_mesh_serve` says what it does)."""
    import numpy as np
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import batch_shardings
    from repro_torch.launch.mesh import describe_mesh, make_emulated_mesh
    from repro_torch.models import blocks
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import dist
    from repro_torch.runtime import sharding as rsh
    from repro_torch.runtime.steps import make_decode_step

    torch.set_num_threads(2)  # four ranks share the host's cores
    a = spec["args"]
    wd = Path(a["dir"])
    cuda = a["device"] == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    mesh = make_emulated_mesh(MESH_SERVE_MESH, device=a["device"])
    args = _mesh_serve_args(a["device"], a["arch"], a["smoke"])
    cfg, model, params = _mesh_serve_build(torch, args, mesh, n_layers=a["n_layers"])
    desc = model.desc()
    flat = _flat(params)
    rules = _flat(rsh.tree_shardings(mnn.axes_tree(desc), rsh.SERVE_RULES, mesh, mnn.abstract_tree(desc)))
    param_misplaced = [k for k, v in flat.items() if tuple(v.placements) != tuple(rules[k].placements)]
    teacher = np.load(wd / "tokens.npy")[:, :MESH_SERVE_FORCED]
    blocks.ROUTING_LOG = [] if cfg.moe else None
    try:
        res = serve.run_static(args, cfg, model, params, mesh=mesh, teacher=teacher, keep=True)
        n_moe = cfg.n_layers - cfg.moe.n_dense_layers if cfg.moe else 0
        # the prefill's and the forced steps' expert choices (gathered after the timed run)
        choices = [dist.gather(t, dst=0)
                   for t in (blocks.ROUTING_LOG or [])[: n_moe * (1 + MESH_SERVE_FORCED)]]
    finally:
        blocks.ROUTING_LOG = None
    cache = res["cache"]
    lay = rsh.cache_sharding(model.cache_desc(args.batch, args.prompt_len + args.gen), mesh,
                             args.batch, {cfg.n_kv_heads, cfg.n_heads})
    cache_misplaced = [k for k, v in _flat(cache).items()
                       if tuple(v.placements) != tuple(_flat(lay)[k].placements)]
    rows = args.prompt_len + MESH_SERVE_FORCED  # written from the same tokens in both runs
    whole = {k: dist.gather(v, dst=0) for k, v in _cache_stacks(cache).items()}
    rel, cache_rel = [], {}
    if rank == 0:
        base = np.load(wd / "logits.npy", mmap_mode="r")
        for i in range(1 + MESH_SERVE_FORCED):
            want = np.asarray(base[i])
            rel.append(float(np.abs(res["logits"][i].numpy() - want).max() / np.abs(want).max()))
        base_cache = torch.load(wd / "cache.pt")
        for k, v in whole.items():
            w = base_cache[k][:, :, :rows].to(torch.float32)
            cache_rel[k] = float((v[:, :, :rows].to(torch.float32) - w).abs().max() / w.abs().max())
    # on a fresh cache, not timed: the collectives of one prefill and of one
    # decode step (the argmax included), then one decode step traced on rank 0
    decode = make_decode_step(model)
    with rsh.activate(mesh, rsh.SERVE_RULES):
        c2 = model.init_cache(args.batch, args.prompt_len + 2)
        tok = dist.put_global(
            torch.as_tensor(np.repeat(teacher[:, :1], args.prompt_len, axis=1), dtype=torch.int32,
                            device=model.device),
            batch_shardings({"t": teacher}, mesh, args.batch)["t"])
        staged = []  # the host-staged gathers: (mesh dim, shard shape)
        gather_local = rsh._gather_local

        def logged(local, mesh_, j, d, extent):
            staged.append((mesh_.mesh_dim_names[j], list(local.shape)))
            return gather_local(local, mesh_, j, d, extent)

        rsh._gather_local = logged
        try:
            with CommDebugMode() as comm_p:
                _, c2 = model.forward(params, {"tokens": tok}, cache=c2)
            with CommDebugMode() as comm_d:
                nxt, c2 = decode(params, tok[:, :1], c2)
        finally:
            rsh._gather_local = gather_local
        trace = _mesh_step_trace(torch, lambda: decode(params, nxt, c2), rank == 0 and cuda)
    return dict(trace=trace,
        rank=rank, backend=dist.backend(), mesh=describe_mesh(mesh)["shape"],
        leaves=len(flat) + len(_flat(cache)), param_misplaced=param_misplaced,
        cache_misplaced=cache_misplaced, tokens=res["tokens"].tolist(), rel=rel, cache_rel=cache_rel,
        prefill_ms=res["prefill_s"] * 1e3, decode_ms=res["decode_s"] * 1e3 / (args.gen - 1),
        comm_prefill={str(k): v for k, v in comm_p.get_comm_counts().items()},
        comm_decode={str(k): v for k, v in comm_d.get_comm_counts().items()},
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0,
        choices=[c.numpy().tolist() for c in choices] if rank == 0 else [],
        staged_gathers=staged,
        expert_shards=sorted({tuple(v.to_local().shape[-3:]) for k, v in flat.items()
                              if "/mlp/w_" in k and "shared" not in k and v.ndim == 4}),
    )


def phase_mesh_moe(torch, np, dev, card, smoke: bool = False) -> dict:
    """`[mesh-moe]`: deepseek-v2-236b at full width and 2 of its 60 layers
    (`MESH_MOE_LAYERS`: the dense layer in `dense_blocks` and one MoE layer,
    both MLA; 5.36 B float32 parameters, 21.4 GB unsharded, ~10.8 GB a
    rank), served by `phase_mesh_serve`: the same checks, the MLA latent
    cache among the gathered leaves, and the share of tokens whose expert
    choice differs from the unsharded run at the forced steps."""
    return phase_mesh_serve(torch, np, dev, card, arch=MESH_MOE_ARCH, smoke=smoke,
                            n_layers=MESH_MOE_LAYERS, tag="mesh-moe")


def mesh_moe_only(torch, np, dev) -> dict:
    """`[mesh-moe]` alone."""
    return phase_mesh_moe(torch, np, dev, card_line())


def mesh_serve_only(torch, np, dev) -> dict:
    """`[mesh-serve]` alone, then `gloo_cuda_probes` (not in the whole
    smoke: the path takes neither redistribution)."""
    out = phase_mesh_serve(torch, np, dev, card_line())
    mesh_serve_dir().mkdir(parents=True, exist_ok=True)
    out["gloo_cuda"] = gloo_cuda_probes()
    log("mesh-serve", json.dumps(dict(gloo_cuda=out["gloo_cuda"])))
    import shutil

    shutil.rmtree(mesh_serve_dir(), ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# [mesh-families]: the vision frontend, the encoder-decoder, the hybrid and
# xLSTM served under SERVE_RULES, 4 ranks
# ---------------------------------------------------------------------------

#: each model at full width, cut in depth: internvl2-76b at 2 of its 80
#: layers (with its 256 patch embeddings), seamless-m4t-large-v2 at 2 of
#: its 24 encoder and 2 of its 24 decoder layers (1024 frames), zamba2-1.2b
#: at 8 of its 38 layers (a group of 6 Mamba2 layers with the shared
#: attention and a tail of 2), xlstm-1.3b at 8 of its 48 (a group of 7
#: mLSTM and 1 sLSTM)
MESH_FAMILIES = {
    "internvl2-76b": dict(n_layers=2),
    "seamless-m4t-large-v2": dict(n_layers=2, n_enc_layers=2),
    "zamba2-1.2b": dict(n_layers=8),
    "xlstm-1.3b": dict(n_layers=8),
}
MESH_FAMILIES_TIMEOUT_S = 900.0
#: each model's bound on its logits and caches, of max|x|: `MESH_SERVE_RTOL`'s
#: rule, max(2e-2, d), d the reference's own distance between its sharded
#: and unsharded bfloat16 runs of the reduced model on (2, 2)
#: (tests/test_torch_mesh_families.py: 0.0359 for zamba2, 0.0274 for xlstm,
#: 0.011 for the other two; through the recurrences a bfloat16 flip grows)
MESH_FAMILIES_RTOL = {"internvl2-76b": MESH_SERVE_RTOL, "seamless-m4t-large-v2": MESH_SERVE_RTOL,
                      "zamba2-1.2b": 3.6e-2, "xlstm-1.3b": 2.8e-2}
#: cache leaves held to another bound than their model's: the sLSTM's
#: normalized accumulators c and n move in the reference itself by 0.054
#: and 0.062 of max|x| between its sharded and unsharded bfloat16 runs of
#: the reduced xlstm on (2, 2), and by 0.118 and 0.107 between its bfloat16
#: and float32 runs (every other state within 0.03): max(2e-2, d), d the
#: larger (tests/test_torch_ssm.py's rule)
MESH_FAMILIES_LEAF_RTOL = {("xlstm-1.3b", "groups/s/c"): 0.12, ("xlstm-1.3b", "groups/s/n"): 0.11}


#: `[mesh-cache]`: the dry run's cache variants served under a mesh, each
#: at full width, a prefill then 4 decode steps fed the unsharded tokens
#: (no greedy ones: a seqkv step of 32 layers takes ~1.1 s over gloo):
#: phi4-mini-3.8b at 4 of its 32 layers with the int8 KV cache (its 8 KV
#: heads split over 'model'); smollm-360m at full depth, whose 5 KV heads
#: (and 15 query heads) no 'model' of 2 divides, with its cache split
#: along its sequence (`cache_sharding(seq_shard=True)`: 256 rows, 128 x
#: 2, from a prefill of 251 and 5 steps), alone and with the int8 cache
#: ('combo'). name -> (arch, config changes, prompt, forced and greedy
#: steps, sequence split)
MESH_CACHE = {
    "phi4-mini-3.8b/kvq8": dict(arch="phi4-mini-3.8b", cut=dict(n_layers=4, kv_quant=True),
                                prompt=MESH_SERVE_PROMPT, forced=4, free=0, seq_shard=False),
    "smollm-360m/seqkv": dict(arch="smollm-360m", cut={}, prompt=251, forced=4, free=0,
                              seq_shard=True),
    "smollm-360m/combo": dict(arch="smollm-360m", cut=dict(kv_quant=True), prompt=251,
                              forced=4, free=0, seq_shard=True),
}
MESH_CACHE_TIMEOUT_S = 600.0


def _mesh_cases(table: str) -> dict:
    """`[mesh-families]`'s models (table "families") or `[mesh-cache]`'s
    cases ("cache"): name -> (arch, config changes, prompt, forced and
    greedy steps, sequence split)."""
    if table == "cache":
        return MESH_CACHE
    return {arch: dict(arch=arch, cut=cut, prompt=MESH_SERVE_PROMPT, forced=MESH_SERVE_FORCED,
                       free=MESH_SERVE_FREE, seq_shard=False)
            for arch, cut in MESH_FAMILIES.items()}


def mesh_families_dir(table: str = "families") -> Path:
    return ROOT / "build" / f"mesh_{table}"


def _batch_dims(model, max_len: int) -> dict:
    """Each cache leaf's batch dim: the one that differs between the specs
    of a batch of 1 and of 2."""
    one, two = _flat(model.cache_desc(1, max_len)), _flat(model.cache_desc(2, max_len))
    return {k: next(i for i, (a, b) in enumerate(zip(one[k].shape, two[k].shape)) if a != b)
            for k in one if k != "pos"}


def phase_mesh_families(torch, np, dev, card, smoke: bool = False,
                        table: str = "families") -> dict:
    """`[mesh-families]` (and `[mesh-cache]`: table "cache", the
    `MESH_CACHE` cases, each cache's sequence dim asserted split where the
    case splits it, the int8 cache compared as values, codes x scale):
    each `MESH_FAMILIES` model served unsharded on
    the card by `launch.serve.run_static` (a prefill of 4 x 64 after the
    patches or frames, 16 greedy steps), its logits, tokens and cache kept
    on the host, the card freed after each; then ONE four-rank job
    (`launch/mhrun.py`, gloo) on a (2, 2) ('data', 'model') mesh serving
    the models in turn through `run_static(mesh=)` under `SERVE_RULES`,
    params drawn from the same generator and kept by box, the card freed
    between models: the same prefill, 8 decode steps fed the unsharded
    greedy tokens, then 8 greedy steps. For each model: the prefill's and
    the forced steps' logits within its `MESH_FAMILIES_RTOL` of max|logit|
    of the unsharded run's (the caches too, but for the leaves of
    `MESH_FAMILIES_LEAF_RTOL`), every param and cache leaf on the placements its
    rules give, the gathered caches within the same bound of the
    unsharded ones (K/V on the rows both runs wrote from the same tokens;
    the recurrent states, conv windows and the encoder memory on the batch
    rows whose tokens agree at every step), the tokens that differ with
    the unsharded top-2 margin, the decode-step ms (the maximum over
    ranks) beside the unsharded run's, the collectives of one decode step
    by kind and the peak memory of each rank. Every model is reported
    before a failed check fails the phase; a rank's error fails it too.
    No kernel of K1-K6 runs here."""
    import shutil

    from repro_torch.launch import mhrun, serve

    tag, cases = f"mesh-{table}", _mesh_cases(table)
    free_card(torch)
    wd = mesh_families_dir(table)
    shutil.rmtree(wd, ignore_errors=True)
    t0 = time.perf_counter()
    base_ms, n_params = {}, {}
    for name, case in cases.items():
        ad = wd / name
        ad.mkdir(parents=True)
        args = _mesh_serve_args(dev.type, case["arch"], smoke, case["prompt"],
                                case["forced"] + case["free"])
        cfg, model, params = _mesh_serve_build(torch, args, **case["cut"])
        n_params[name] = sum(a.numel() for a in _leaves(params))
        base = serve.run_static(args, cfg, model, params, keep=True)
        base_ms[name] = dict(prefill_ms=base["prefill_s"] * 1e3,
                             decode_ms_per_step=base["decode_s"] * 1e3 / (args.gen - 1))
        np.save(ad / "tokens.npy", base["tokens"])
        np.save(ad / "logits.npy", np.stack([t.numpy() for t in base["logits"]]))
        torch.save({k: v.cpu() for k, v in _cache_stacks(base["cache"]).items()}, ad / "cache.pt")
        del model, params, base
        free_card(torch)
    unsharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = mhrun.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-serve-worker"], MESH_SERVE_RANKS,
        scenario="mesh_families", backend="gloo",
        timeout_s=MESH_CACHE_TIMEOUT_S if table == "cache" else MESH_FAMILIES_TIMEOUT_S,
        workdir=str(wd / "mhrun"), extra_env={"OMP_NUM_THREADS": "2"},
        args=dict(smoke=smoke, device=dev.type, dir=str(wd), table=table),
    )
    job_s = time.perf_counter() - t0
    payloads = mhrun.require_success(results)
    out, failed = {}, []
    for name, case in cases.items():
        arch = case["arch"]
        got = [p["models"][name] for p in payloads]
        g0 = got[0]
        bound = MESH_FAMILIES_RTOL.get(arch, MESH_SERVE_RTOL)
        for g in got:
            if g["tokens"] != g0["tokens"]:
                failed.append(f"{name}: rank {g['rank']} holds other tokens")
            if g["param_misplaced"]:
                failed.append(f"{name}: rank {g['rank']}: params off their rules' placements: "
                              f"{g['param_misplaced'][:4]}")
            if g["cache_misplaced"]:
                failed.append(f"{name}: rank {g['rank']}: cache off cache_sharding's "
                              f"placements: {g['cache_misplaced']}")
            unsplit = [k for k, split in g["seq_split"].items() if not split]
            if case["seq_shard"] and (unsplit or not g["seq_split"]):
                failed.append(f"{name}: rank {g['rank']}: the sequence dim of "
                              f"{unsplit or 'no K/V leaf'} is not Shard")
        rel = g0["rel"]
        if len(rel) != 1 + case["forced"]:
            failed.append(f"{name}: {len(rel)} logits compared")
        failed += [f"{name} step {i}: sharded logits {d:.4g} of max|logit| off the unsharded "
                   f"run's (bound {bound})" for i, d in enumerate(rel) if d > bound]
        leaf_bound = {k: MESH_FAMILIES_LEAF_RTOL.get((arch, k), bound) for k in g0["cache_rel"]}
        failed += [f"{name} cache {k}: {d:.4g} of max|cache| off the unsharded cache "
                   f"(bound {leaf_bound[k]})" for k, d in g0["cache_rel"].items()
                   if d > leaf_bound[k]]
        want = np.load(wd / name / "tokens.npy")
        logits = np.load(wd / name / "logits.npy", mmap_mode="r")
        tok = np.asarray(g0["tokens"])
        differ = [dict(row=int(r), step=int(c), sharded=int(tok[r, c]), unsharded=int(want[r, c]),
                       unsharded_top2_margin=_margin(np, logits[c, r]))
                  for r, c in zip(*np.nonzero(tok != want))]
        out[name] = dict(
            layers=case["cut"], params=n_params[name], rel_by_step=rel,
            seq_split=g0["seq_split"], cache_specs=g0["cache_specs"],
            cache_rel=g0["cache_rel"], cache_bound=leaf_bound,
            state_rows_compared=g0["state_rows"],
            tokens_differ=differ, leaves=g0["leaves"],
            decode_ms_per_step=max(g["decode_ms"] for g in got),
            decode_ms_by_rank=[g["decode_ms"] for g in got],
            prefill_ms=max(g["prefill_ms"] for g in got), unsharded=base_ms[name],
            collectives_decode_step=g0["comm_decode"],
            staged_gathers_decode_step=g0["staged_decode"],
            peak_gib_by_rank=[g["peak_gib"] for g in got])
        log(tag, json.dumps(dict(case=name, **out[name], bound=bound, card=card)))
    log(tag, json.dumps(dict(
        mesh=payloads[0]["mesh"], backend=payloads[0]["backend"], ranks=len(payloads),
        unsharded_s=unsharded_s, job_s=job_s,
        steps={n: [c["forced"], c["free"]] for n, c in cases.items()}, card=card)))
    shutil.rmtree(wd, ignore_errors=True)
    check(not failed, f"[{tag}] " + "; ".join(failed))
    return dict(models=out, job_s=job_s, unsharded_s=unsharded_s)


def mesh_families_worker(spec: dict, rank: int) -> dict:
    """One rank of `[mesh-families]` or `[mesh-cache]` (`phase_mesh_families`
    says what it does): each case in turn, the card freed after each."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import batch_shardings
    from repro_torch.launch.mesh import describe_mesh, make_emulated_mesh
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import dist
    from repro_torch.runtime import sharding as rsh
    from repro_torch.runtime.steps import make_decode_step

    torch.set_num_threads(2)  # four ranks share the host's cores
    a = spec["args"]
    cuda = a["device"] == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_emulated_mesh(MESH_SERVE_MESH, device=a["device"])
    models = {}
    for name, case in _mesh_cases(a.get("table", "families")).items():
        wd = Path(a["dir"]) / name
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        args = _mesh_serve_args(a["device"], case["arch"], a["smoke"], case["prompt"],
                                case["forced"] + case["free"])
        cfg, model, params = _mesh_serve_build(torch, args, mesh, **case["cut"])
        desc = model.desc()
        flat = _flat(params)
        rules = _flat(rsh.tree_shardings(mnn.axes_tree(desc), rsh.SERVE_RULES, mesh,
                                         mnn.abstract_tree(desc)))
        param_misplaced = [k for k, v in flat.items()
                           if tuple(v.placements) != tuple(rules[k].placements)]
        want_tokens = np.load(wd / "tokens.npy")
        teacher = want_tokens[:, :case["forced"]]
        res = serve.run_static(args, cfg, model, params, mesh=mesh, teacher=teacher, keep=True,
                               seq_shard=case["seq_shard"])
        cache = res["cache"]
        patches = cfg.frontend_len if cfg.frontend == "vision" else 0
        max_len = patches + args.prompt_len + args.gen
        lay = _flat(rsh.cache_sharding(model.cache_desc(args.batch, max_len), mesh, args.batch,
                                       {cfg.n_kv_heads, cfg.n_heads}, seq_shard=case["seq_shard"]))
        cache_misplaced = [k for k, v in _flat(cache).items()
                           if tuple(v.placements) != tuple(lay[k].placements)]
        bdims = _batch_dims(model, max_len)
        rows_of = ("/k", "/v", "/k_scale", "/v_scale")  # (..., B, T, H[, D])
        seq_split = {k: any(p == Shard(bdims[k] + 1) for p in v.placements)
                     for k, v in _cache_stacks(cache).items() if k.endswith(rows_of)}
        whole = {k: dist.gather(v, dst=0) for k, v in _cache_stacks(cache).items()}
        # K/V rows written from the same tokens in both runs; the other
        # states on the batch rows whose tokens agree at every step
        rows = patches + args.prompt_len + case["forced"]
        same = np.all(res["tokens"] == want_tokens, axis=1)
        rel, cache_rel = [], {}
        if rank == 0:
            base = np.load(wd / "logits.npy", mmap_mode="r")
            for i in range(1 + case["forced"]):
                w = np.asarray(base[i])
                rel.append(float(np.abs(res["logits"][i].numpy() - w).max() / np.abs(w).max()))
            base_cache = torch.load(wd / "cache.pt")
            for k, v in whole.items():
                w, g = base_cache[k].to(torch.float32), v.to(torch.float32)
                bd = bdims[k]
                if f"{k}_scale" in whole:  # the int8 cache as values, codes x scale
                    w = w * base_cache[f"{k}_scale"].to(torch.float32)[..., None]
                    g = g * whole[f"{k}_scale"].to(torch.float32)[..., None]
                if k.endswith(rows_of):
                    w, g = w.narrow(bd + 1, 0, rows), g.narrow(bd + 1, 0, rows)
                elif k != "memory":  # the memory is written by the prefill alone
                    keep = torch.as_tensor(np.nonzero(same)[0])
                    if not len(keep):
                        continue
                    w, g = w.index_select(bd, keep), g.index_select(bd, keep)
                cache_rel[k] = float((g - w).abs().max() / max(float(w.abs().max()), 1e-30))
        # one more decode step on the final cache, not timed: its collectives
        decode = make_decode_step(model)
        with rsh.activate(mesh, rsh.SERVE_RULES):
            tok = dist.put_global(torch.as_tensor(want_tokens[:, -1:], dtype=torch.int32,
                                                  device=model.device),
                                  batch_shardings({"t": want_tokens}, mesh, args.batch)["t"])
            staged = []
            gather_local = rsh._gather_local

            def logged(local, mesh_, j, d, extent):
                staged.append(mesh_.mesh_dim_names[j])
                return gather_local(local, mesh_, j, d, extent)

            rsh._gather_local = logged
            try:
                with CommDebugMode() as comm:
                    decode(params, tok, cache)
            finally:
                rsh._gather_local = gather_local
        models[name] = dict(
            rank=rank, leaves=len(flat) + len(_flat(cache)), param_misplaced=param_misplaced,
            cache_misplaced=cache_misplaced, seq_split=seq_split,
            cache_specs={k: str(tuple(v.placements)) for k, v in _cache_stacks(cache).items()},
            tokens=res["tokens"].tolist(), rel=rel,
            cache_rel=cache_rel, state_rows=int(same.sum()),
            prefill_ms=res["prefill_s"] * 1e3, decode_ms=res["decode_s"] * 1e3 / (args.gen - 1),
            comm_decode={str(k): v for k, v in comm.get_comm_counts().items()},
            staged_decode={d: staged.count(d) for d in ("data", "model")},
            peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0)
        del model, params, cache, res, whole
        if cuda:
            free_card(torch)
    return dict(rank=rank, backend=dist.backend(), mesh=describe_mesh(mesh)["shape"],
                models=models)


def mesh_families_only(torch, np, dev) -> dict:
    """`[mesh-families]` alone."""
    return phase_mesh_families(torch, np, dev, card_line())


def mesh_cache_only(torch, np, dev) -> dict:
    """`[mesh-cache]` alone."""
    return phase_mesh_families(torch, np, dev, card_line(), table="cache")


# ---------------------------------------------------------------------------
# [dryrun]: the dry-run launcher on a fake process group, and its calibration
# ---------------------------------------------------------------------------

#: the production cells: each one `python -m repro_torch.launch.dryrun` at
#: full width and depth on fake tensors over a fake group of 256 ranks
#: ('single', (16, 16)) or 512 ('multi', (2, 16, 16)), with the 1- and
#: 2-unit extrapolation: (arch, shape, variant, mesh, the status it must
#: report). phi4-mini's 8 KV heads cannot take a 16-way 'model', so seqkv
#: splits its cache's sequence; a full-attention arch at long_500k is the
#: reference's skip.
DRYRUN_CELLS = [
    ("smollm-360m", "train_4k", "baseline", "single", "ok"),
    ("smollm-360m", "train_4k", "tp_weights", "single", "ok"),
    ("phi4-mini-3.8b", "decode_32k", "seqkv", "single", "ok"),
    ("phi4-mini-3.8b", "decode_32k", "kvq8", "single", "ok"),
    ("deepseek-v2-236b", "decode_32k", "baseline", "single", "ok"),
    ("zamba2-1.2b", "long_500k", "baseline", "single", "ok"),
    ("phi4-mini-3.8b", "long_500k", "baseline", "single", "skip"),
    ("smollm-360m", "train_4k", "baseline", "multi", "ok"),
]
#: cells traced at once (at nice 10, on the host's cores, beside the other
#: phases: the fake tensors allocate nothing on the card), each one's hard
#: limit, and how long `[dryrun]` waits for the cells still running (on
#: the H100 machine's host the slowest cell takes ~75 s, all 8 ~460 s in
#: the background)
DRYRUN_LANES, DRYRUN_TIMEOUT_S, DRYRUN_WAIT_S = 2, 300.0, 300.0
#: the calibration cell: counted on fake tensors over a one-rank (1, 1)
#: mesh at one layer unit, then run for real on the card (its cache is
#: 128 x 32768 x 5 x 64 bfloat16 K and V, 5.4 GB)
DRYRUN_CALIBRATION = ("smollm-360m", "decode_32k")
#: `MemTracker`'s peak of the counted step (its inputs and temporaries)
#: against the card's `max_memory_allocated` of the real one, less what
#: was allocated before it but its inputs (cuBLAS's workspace, taken by a
#: first step): the caching allocator rounds each block up to 512 bytes
DRYRUN_PEAK_RTOL = 0.05


def dryrun_dir() -> Path:
    return ROOT / "build" / "dryrun"


class DryrunCells:
    """`DRYRUN_CELLS` traced in the background, `DRYRUN_LANES` at a time,
    each a `python -m repro_torch.launch.dryrun` process (of the
    `repro_torch` under `src`) killed at `DRYRUN_TIMEOUT_S`; any process
    still running when this one exits is killed."""

    def __init__(self, src: Path):
        import atexit
        import queue
        import shutil
        import threading

        shutil.rmtree(dryrun_dir(), ignore_errors=True)
        dryrun_dir().mkdir(parents=True)
        self.src, self.results, self.procs, self.stopped = src, {}, [], False
        self.t0 = time.perf_counter()
        todo = queue.Queue()
        for cell in DRYRUN_CELLS:
            todo.put(cell)
        self.lanes = [threading.Thread(target=self._lane, args=(todo,), daemon=True)
                      for _ in range(DRYRUN_LANES)]
        atexit.register(self.kill)
        for t in self.lanes:
            t.start()

    def _lane(self, todo) -> None:
        import queue

        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(self.src.resolve())] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        while not self.stopped:
            try:
                cell = todo.get_nowait()
            except queue.Empty:
                return
            arch, shape, variant, mesh, _ = cell
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--variant", variant, "--mesh", mesh, "--out", str(dryrun_dir())]
            t = time.perf_counter()
            proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True,
                                    preexec_fn=lambda: os.nice(10))
            self.procs.append(proc)
            try:
                out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            self.results[cell] = dict(rc=proc.returncode, s=time.perf_counter() - t,
                                      tail=out[-1500:])

    def kill(self) -> None:
        self.stopped = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def join(self) -> dict:
        """The finished cells' results, after waiting `DRYRUN_WAIT_S` at
        most; the cells still running then are killed."""
        deadline = time.perf_counter() + DRYRUN_WAIT_S
        for t in self.lanes:
            t.join(max(deadline - time.perf_counter(), 0.0))
        self.kill()
        return dict(self.results)


def dryrun_calibration(torch, np, dev, card) -> dict:
    """`[dryrun]` (b): `DRYRUN_CALIBRATION` through `lower_cell(units=1)`
    on a one-rank (1, 1) mesh of the card (a one-rank gloo group in this
    process, left at the end): counted on fake tensors, then the returned
    step run for real on inputs drawn on the card from a generator seeded
    0 (`dryrun.calibrate`). Its `FlopCounterMode` count must equal the
    dry count, the real inputs' bytes `argument_bytes`, both exactly; the
    `MemTracker` peak must lie within `DRYRUN_PEAK_RTOL` of the card's.
    Prints the step's ms (CUDA events, median of 5) beside the roofline's
    memory and compute times."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    free_card(torch)
    store = torch.distributed.TCPStore("127.0.0.1", 0, 1, True)
    torch.distributed.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        counted, info = dryrun.lower_cell(*DRYRUN_CALIBRATION, make_local_mesh(), units=1)
        got = dryrun.calibrate(counted, info, torch.Generator(device=dev).manual_seed(0))
    finally:
        torch.distributed.destroy_process_group()
        free_card(torch)
    out = dict(cell=list(DRYRUN_CALIBRATION), units=1, mesh=[1, 1], **got,
               bytes_accessed_dry=counted.bytes_accessed, trace_s=counted.seconds,
               step_ms_median=statistics.median(got["step_ms"]),
               t_memory_ms=counted.bytes_accessed / dryrun.HBM_BW * 1e3,
               t_compute_ms=counted.flops / dryrun.PEAK_FLOPS * 1e3,
               collectives=counted.collective_counts, card=card)
    log("dryrun", json.dumps(out))
    check(out["flops_card"] == out["flops_dry"],
          f"the card's step counts {out['flops_card']} FLOPs, the dry run {out['flops_dry']}")
    check(out["argument_bytes_card"] == out["argument_bytes_dry"],
          f"the card's inputs hold {out['argument_bytes_card']} bytes, the dry run counts "
          f"{out['argument_bytes_dry']}")
    check(out["peak_rel"] <= DRYRUN_PEAK_RTOL,
          f"MemTracker's peak {out['peak_bytes_dry']} is {out['peak_rel']:.3g} off the card's "
          f"{out['peak_bytes_card']} (bound {DRYRUN_PEAK_RTOL})")
    return out


def phase_dryrun(torch, np, dev, card, cells: DryrunCells) -> dict:
    """`[dryrun]`: (b) the calibration (`dryrun_calibration`), then (a) the
    production cells traced in the background since `cells` started
    (`DRYRUN_CELLS`): each must exit 0 and report its status (ok, or the
    reference's SKIP(full-attn)); per cell the three roofline terms, the
    dominant one, the useful-FLOPs ratio, the argument MB per rank, the
    trace's seconds and the process's. No kernel of K1-K6 runs here."""
    calibration = dryrun_calibration(torch, np, dev, card)
    t = time.perf_counter()
    results = cells.join()
    failed, out = [], {}
    for cell in DRYRUN_CELLS:
        arch, shape, variant, mesh, want = cell
        res = results.get(cell)
        suffix = "" if variant == "baseline" else f"__{variant}"
        path = dryrun_dir() / f"{arch}__{shape}__{mesh}{suffix}.json"
        if res is None or res["rc"] != 0 or not path.exists():
            failed.append(f"{arch} x {shape} x {variant} x {mesh}: "
                          f"{'not run' if res is None else res['tail']}")
            continue
        rec = json.loads(path.read_text())
        rl, mem = rec.get("roofline", {}), rec.get("memory", {})
        line = dict(cell=f"{arch} x {shape} x {variant} x {mesh}", chips=rec["chips"],
                    status=rec["status"], reason=rec.get("reason", rec.get("error")),
                    t_compute_s=rl.get("t_compute_s"), t_memory_s=rl.get("t_memory_s"),
                    t_collective_s=rl.get("t_collective_s"), dominant=rl.get("dominant"),
                    useful_flops_ratio=rl.get("useful_flops_ratio"),
                    argument_mb=mem.get("argument_bytes", 0) / 1e6,
                    temp_mb=mem.get("temp_bytes", 0) / 1e6,
                    collectives=rec.get("collective_counts"),
                    trace_s=rec.get("compile_seconds"), process_s=res["s"])
        out[line["cell"]] = line
        log("dryrun", json.dumps(line))
        if rec["status"] != want or (want == "skip" and rec.get("reason") != "SKIP(full-attn)"):
            failed.append(f"{line['cell']}: {rec['status']} {line['reason']}, want {want}")
    log("dryrun", json.dumps(dict(cells=len(DRYRUN_CELLS), lanes=DRYRUN_LANES,
                                  background_s=time.perf_counter() - cells.t0,
                                  waited_s=time.perf_counter() - t, card=card)))
    check(not failed, "[dryrun] " + "; ".join(failed))
    return dict(calibration=calibration, cells=out)


def _src() -> Path:
    """The src/ directory `repro_torch` was imported from (--src)."""
    import repro_torch

    return Path(repro_torch.__file__).resolve().parent.parent


def dryrun_only(torch, np, dev) -> dict:
    """`[dryrun]` alone."""
    return phase_dryrun(torch, np, dev, card_line(), DryrunCells(_src()))


# ---------------------------------------------------------------------------
# [mesh-train]: the dense decoder trained under TRAIN_RULES, 4 ranks
# ---------------------------------------------------------------------------

#: smollm-360m at full width and 4 of its 32 layers on a (2, 2) ('data',
#: 'model') mesh of 4 ranks sharing the card over gloo: 2 compressed steps
#: of 8 x 256 tokens (an async save after step 2, then the final save of
#: the same step), a restore of step 2 under the mesh, then a resumed run
#: to step 3 (the depth cut pays for `[mesh-moe]` and `[mesh-families]`)
MESH_TRAIN_ARCH, MESH_TRAIN_MESH, MESH_TRAIN_RANKS = "smollm-360m", (2, 2), 4
MESH_TRAIN_LAYERS = 4
MESH_TRAIN_STEPS, MESH_TRAIN_RESUME = 2, 3
#: the launcher computes in bfloat16 (the config's dtype): max(2e-2, d) of
#: the loss, d the reference's own sharded-vs-unsharded distance at
#: bfloat16 (within 2e-2 on the reduced model, tests/test_torch_mesh_train.py)
MESH_TRAIN_RTOL = 2e-2
MESH_TRAIN_TIMEOUT_S = 900.0
#: full-width training that does not fit four ranks sharing one 80 GB card:
#: float32 params, gradients, Adam's m and v and the compressor's residuals
#: are 20 bytes a parameter before any activation (the 2-rank `cuda` tests
#: train deepseek-v2 at a reduced width on the card instead)
MESH_TRAIN_NOT_RUN = {
    "phi4-mini-3.8b": "~89 GB of float32 train state (params, m, v, residuals)",
    "llama4-scout-17b-a16e": "1 of 48 layers: 4.27 B parameters, 85.4 GB of float32 train "
                             "state; 2 layers: 6.47 B, 129.5 GB",
    "deepseek-v2-236b": "2 of 60 layers (the dense one and one MoE): 5.36 B parameters, "
                        "107.2 GB of float32 train state",
}


def mesh_train_dir() -> Path:
    return ROOT / "build" / "mesh_train"


def _mesh_train_argv(device: str, smoke: bool) -> list:
    return (["--arch", MESH_TRAIN_ARCH, "--device", device, "--n-layers", str(MESH_TRAIN_LAYERS),
             "--batch", "8", "--seq", "256",
             "--steps", str(MESH_TRAIN_STEPS), "--compress-grads", "--log-every", "1"]
            + (["--smoke"] if smoke else []))


def phase_mesh_train(torch, np, dev, card, smoke: bool = False) -> dict:
    """`[mesh-train]`: smollm-360m (full width, `MESH_TRAIN_LAYERS` layers)
    trained unsharded on the card by `launch.train.main` (its losses, step
    ms and peak kept), and the
    unsharded params' loss on the batch of step `MESH_TRAIN_STEPS`; then
    the card freed and four ranks (`launch/mhrun.py`, gloo) training it
    through `train.run(mesh=)` on a (2, 2) ('data', 'model') mesh under
    `TRAIN_RULES` with an async save and the final save, restoring that
    save under the mesh (bit for bit against the trained state), and
    resuming for one step (`mesh_train_worker`). Every loss within
    `MESH_TRAIN_RTOL` of the unsharded one; prints each rank's step ms
    beside the unsharded step's, one step's collectives by kind (DTensor's
    all-reduces, the host-staged all-gathers and reduce-scatters), the
    peak memory of each rank, the saves' and the restore's ms. No kernel
    of K1-K6 runs here."""
    import shutil

    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import mhrun, train

    free_card(torch)
    wd = mesh_train_dir()
    shutil.rmtree(wd, ignore_errors=True)
    wd.mkdir(parents=True)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = train.main(_mesh_train_argv(dev.type, smoke))
    base_peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    args = train.parse_args(_mesh_train_argv(dev.type, smoke))
    cfg, model = train.build(args)
    batch = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
                            MESH_TRAIN_STEPS)
    with torch.no_grad():
        after, _ = model.loss(base["params"], {k: torch.from_numpy(v).to(dev)
                                               for k, v in batch.items()})
    n_params = sum(a.numel() for a in _leaves(base["params"]))
    want = base["losses"] + [float(after)]
    del base["params"], base["opt"], model
    free_card(torch)
    t0 = time.perf_counter()
    results = mhrun.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-train-worker"], MESH_TRAIN_RANKS,
        scenario="mesh_train", backend="gloo", timeout_s=MESH_TRAIN_TIMEOUT_S,
        workdir=str(wd / "mhrun"), extra_env={"OMP_NUM_THREADS": "2"},
        args=dict(smoke=smoke, device=dev.type, dir=str(wd)),
    )
    job_s = time.perf_counter() - t0
    payloads = mhrun.require_success(results)
    p0 = payloads[0]
    got = p0["losses"] + p0["resumed"]
    check(len(got) == len(want), f"{len(got)} losses, want {len(want)}")
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    for p in payloads:
        check(p["losses"] + p["resumed"] == got, f"rank {p['rank']} holds other losses")
        check(not p["misplaced"], f"rank {p['rank']}: state off TRAIN_RULES' placements: "
              f"{p['misplaced'][:4]}")
        check(p["restored_equal"], f"rank {p['rank']}: the restore under the mesh differs from "
              f"the trained state: {p['restored_unequal'][:4]}")
        check(p["resumed_from"] == MESH_TRAIN_STEPS, f"rank {p['rank']} resumed from "
              f"{p['resumed_from']}")
    for i, d in enumerate(rel):
        check(d <= MESH_TRAIN_RTOL, f"step {i}: sharded loss {got[i]} {d:.4g} off the unsharded "
              f"{want[i]} (bound {MESH_TRAIN_RTOL})")
    log("mesh-train", json.dumps(dict(
        arch=MESH_TRAIN_ARCH, layers=MESH_TRAIN_LAYERS, params=n_params, dtype=cfg.dtype, mesh=p0["mesh"],
        backend=p0["backend"], ranks=len(payloads), rules="TRAIN_RULES", batch=args.batch,
        seq=args.seq, steps=MESH_TRAIN_STEPS, resumed_to=MESH_TRAIN_RESUME, losses=got,
        unsharded_losses=want, rel_by_step=rel, bound=MESH_TRAIN_RTOL,
        restored_from=p0["restored_from"], restored_bit_for_bit=True, job_s=job_s, card=card)))
    log("mesh-train", json.dumps(dict(
        step_ms_max_over_ranks=[max(p["step_ms"][i] for p in payloads)
                                for i in range(MESH_TRAIN_STEPS)],
        step_ms_by_rank=[p["step_ms"] for p in payloads],
        unsharded_step_ms=[t * 1e3 for t in base["step_s"]],
        resumed_step_ms=max(p["resumed_step_ms"] for p in payloads),
        collectives_a_step=p0["comm_step"], collectives_resumed_run=p0["comm_resumed_run"],
        save_gathers=p0["save_gathers"], first_run_s=max(p["first_run_s"] for p in payloads),
        resumed_run_s=max(p["resumed_run_s"] for p in payloads),
        restore_ms=max(p["restore_ms"] for p in payloads),
        peak_gib_by_rank=[p["peak_gib"] for p in payloads], unsharded_peak_gib=base_peak,
        card=card)))
    log("mesh-train", json.dumps(dict(not_run=MESH_TRAIN_NOT_RUN)))
    shutil.rmtree(wd, ignore_errors=True)
    return dict(rel=rel, step_ms=[max(p["step_ms"][i] for p in payloads)
                                  for i in range(MESH_TRAIN_STEPS)])


def mesh_train_worker(spec: dict, rank: int) -> dict:
    """One rank of `[mesh-train]` (`phase_mesh_train` says what it does)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core import pytree
    from repro_torch.launch import train
    from repro_torch.launch.mesh import describe_mesh, make_emulated_mesh
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import dist
    from repro_torch.runtime import sharding as rsh

    torch.set_num_threads(2)  # four ranks share the host's cores
    a = spec["args"]
    wd = Path(a["dir"])
    cuda = a["device"] == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    mesh = make_emulated_mesh(MESH_TRAIN_MESH, device=a["device"])
    ckpt = ["--ckpt-dir", str(wd / "ckpt"), "--ckpt-every", "2"]
    args = train.parse_args(_mesh_train_argv(a["device"], a["smoke"]) + ckpt)
    cfg, model = train.build(args)
    desc = model.desc()
    rules = _flat(rsh.tree_shardings(mnn.axes_tree(desc), rsh.TRAIN_RULES, mesh,
                                     mnn.abstract_tree(desc)))
    first = train.run(args, cfg, model, rsh.place_params(model, mesh, rsh.TRAIN_RULES), mesh=mesh)
    state = {"params": first["params"], "opt": first["opt"]["adam"]}
    trees = (("params", state["params"]), ("m", state["opt"]["m"]), ("v", state["opt"]["v"]))
    misplaced = [f"{part}/{k}" for part, tree in trees for k, v in _flat(tree).items()
                 if tuple(v.placements) != tuple(rules[k].placements)]
    out = dict(rank=rank, backend=dist.backend(), mesh=describe_mesh(mesh)["shape"],
               losses=first["losses"], step_ms=[t * 1e3 for t in first["step_s"]],
               first_run_s=first["seconds"], misplaced=misplaced)
    save_leaves = sum(dist.is_dtensor(v) for v in _flat(state).values())
    # the last save restored under the mesh (each rank reading its shards)
    # and held to the trained state bit for bit
    mgr = CheckpointManager(CheckpointConfig(str(wd / "ckpt")), device=model.device)
    t0 = time.perf_counter()
    restored_from, restored = mgr.restore_tree(state,
                                               shardings=pytree.tree_map(rsh.layout_of, state))
    out.update(restore_ms=(time.perf_counter() - t0) * 1e3, restored_from=restored_from)
    trained = _flat(state)
    out["restored_unequal"] = [k for k, v in _flat(restored).items()
                               if not torch.equal(dist.local(v), dist.local(trained[k]))]
    del first, state, trained, restored
    # the resumed run: its own restore, one step and the final save, whose
    # flat layout gathers each DTensor leaf once (an all-gather a leaf)
    args = train.parse_args(_mesh_train_argv(a["device"], a["smoke"]) + ckpt
                            + ["--steps", str(MESH_TRAIN_RESUME), "--resume"])
    params = rsh.place_params(model, mesh, rsh.TRAIN_RULES)
    with CommDebugMode() as comm:
        again = train.run(args, cfg, model, params, mesh=mesh)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    step_counts = dict(counts)
    step_counts["c10d.allgather_"] = step_counts.get("c10d.allgather_", 0) - save_leaves
    out["restored_equal"] = not out["restored_unequal"]
    return dict(out, resumed=again["losses"], resumed_from=MESH_TRAIN_RESUME - len(again["losses"]),
                resumed_step_ms=again["step_s"][0] * 1e3, resumed_run_s=again["seconds"],
                comm_resumed_run=counts, save_gathers=save_leaves, comm_step=step_counts,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0)


def mesh_train_only(torch, np, dev) -> dict:
    """`[mesh-train]` alone."""
    return phase_mesh_train(torch, np, dev, card_line())


def main() -> int:
    if any(w in sys.argv for w in ("--sharded-worker", "--mesh-serve-worker",
                                   "--mesh-train-worker")):
        # one rank of [sharded], [mesh-serve] or [mesh-train], started by launch/mhrun.py
        sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
        from repro_torch.launch import mhrun

        return mhrun.worker_main(sys.argv[-1], {"sharded": sharded_worker,
                                                "mesh_serve": mesh_serve_worker,
                                                "mesh_families": mesh_families_worker,
                                                "mesh_train": mesh_train_worker,
                                                "gloo_probe": gloo_probe_worker})
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bot-times", action="store_true",
                        help="only build the kernels and print K5/K6 times (bot_times) as JSON")
    parser.add_argument("--lorenzo-times", action="store_true",
                        help="only build the kernels and print K1/K2 times (lorenzo_times) as JSON")
    parser.add_argument("--zfp-peak", action="store_true",
                        help="only print the peak device memory of the ZFP device encode "
                        "on the main path's ZFP field (zfp_peak) as JSON")
    parser.add_argument("--kv-times", action="store_true",
                        help="only run the KV phase and print its evict/restore times (kv_times) "
                        "as JSON")
    parser.add_argument("--select-profile", action="store_true",
                        help="only time and profile select_many on the 17 paper-sized fields "
                        "(select_profile)")
    parser.add_argument("--serve", action="store_true",
                        help="only run the serving phases (serve_only)")
    parser.add_argument("--decode-profile", nargs="?", const=SERVE_ARCH[1], metavar="ARCH",
                        help="only trace full-width decode steps of ARCH (default "
                        f"{SERVE_ARCH[1]}; decode_profile) and print "
                        "where their time goes as JSON")
    parser.add_argument("--moe-mla", action="store_true",
                        help="only run the MoE and MLA serving phases (moe_mla_only)")
    parser.add_argument("--recurrent", action="store_true",
                        help="only run the zamba2-1.2b and xlstm-1.3b phases (recurrent_only)")
    parser.add_argument("--train", action="store_true",
                        help="only run the training phases (train_only)")
    parser.add_argument("--zoo", action="store_true",
                        help="only run the encoder-decoder's serving and the zoo's training "
                        "phases (zoo_only)")
    parser.add_argument("--sharded", action="store_true",
                        help="only run the four-rank shard-local phase (sharded_only)")
    parser.add_argument("--mesh-serve", action="store_true",
                        help="only run the four-rank serving phase under SERVE_RULES "
                        "(mesh_serve_only)")
    parser.add_argument("--mesh-train", action="store_true",
                        help="only run the four-rank training phase under TRAIN_RULES "
                        "(mesh_train_only)")
    parser.add_argument("--mesh-moe", action="store_true",
                        help="only run the four-rank MoE and MLA serving phase under SERVE_RULES "
                        "(mesh_moe_only)")
    parser.add_argument("--mesh-families", action="store_true",
                        help="only run the four-rank serving phase of the vision frontend, the "
                        "encoder-decoder, the hybrid and xLSTM under SERVE_RULES "
                        "(mesh_families_only)")
    parser.add_argument("--mesh-cache", action="store_true",
                        help="only run the four-rank serving phase of the int8 and the "
                        "sequence-split KV caches under SERVE_RULES (mesh_cache_only)")
    parser.add_argument("--dryrun", action="store_true",
                        help="only run the dry-run launcher's production cells and its "
                        "calibration on the card (dryrun_only)")
    parser.add_argument("--train-profile", action="store_true",
                        help="only trace full-width train steps (train_profile) and print "
                        "where their time goes as JSON")
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="directory to import repro_torch from (another checkout's src/, "
                        "to time two commits in one run)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this smoke runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import numpy as np

    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: "
        f"matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    libs = _build.build(["lorenzo"] if args.lorenzo_times else None, verbose=True)
    for name in libs:
        _build.load(name)
    log("build", f"{sorted(p.name for p in libs.values())} in {time.perf_counter() - t0:.2f} s")
    for wanted, times in ((args.bot_times, bot_times), (args.lorenzo_times, lorenzo_times),
                          (args.zfp_peak, zfp_peak), (args.select_profile, select_profile),
                          (args.kv_times, kv_times), (args.serve, serve_only),
                          (args.decode_profile, functools.partial(
                              decode_profile, arch=args.decode_profile)),
                          (args.moe_mla, moe_mla_only),
                          (args.recurrent, recurrent_only),
                          (args.train, train_only),
                          (args.zoo, zoo_only),
                          (args.sharded, sharded_only),
                          (args.mesh_serve, mesh_serve_only),
                          (args.mesh_train, mesh_train_only),
                          (args.mesh_moe, mesh_moe_only),
                          (args.mesh_families, mesh_families_only),
                          (args.mesh_cache, mesh_cache_only),
                          (args.dryrun, dryrun_only),
                          (args.train_profile, train_profile)):
        if wanted:
            print(json.dumps({"src": str(args.src), **times(torch, np, dev)}), flush=True)
            print(card, flush=True)
            return 0

    # the production cells of [dryrun] trace in the background meanwhile
    cells = DryrunCells(_src())
    # the production cells of [dryrun] trace in the background meanwhile
    cells = DryrunCells(_src())
    marks = [time.perf_counter()]

    def lap(phases: str) -> None:
        """The wall seconds of the phases just run, and of the run so far."""
        marks.append(time.perf_counter())
        log("time", json.dumps({"phases": phases, "s": marks[-1] - marks[-2],
                                "run_s": marks[-1] - t0}))

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MiB > L2
    parity = phase_parity(torch, np, dev, flush)
    phase_parity_dequantize(torch, np, dev, flush, parity)
    phase_parity_bot(torch, np, dev, flush, parity)
    del flush
    lap("parity")
    atm, hurricane = paper_fields(np)
    rows, launches = phase_main(torch, np, dev, atm, hurricane)
    phase_kernels_at_main(torch, dev, rows, parity)
    lap("fields, main")
    phase_select_many(torch, np, dev, atm, hurricane)
    for name, n in phase_pytree(torch, np, dev, atm, hurricane, rows, card).items():
        launches[name] += n
    phase_warm(torch, np, dev, atm, hurricane)
    lap("select_many, pytree, warm")
    for name, n in phase_ckpt(torch, np, dev, atm, hurricane, rows, card).items():
        launches[name] += n
    lap("ckpt")
    by_mode = phase_targets(torch, np, dev, atm, hurricane)
    target_launches = phase_target_roundtrips(torch, np, dev, atm, hurricane, by_mode)
    for name, n in phase_target_pytree(torch, np, dev, atm, hurricane).items():
        target_launches[name] += n
    for name, n in target_launches.items():
        check(n >= 1, f"{name} never launched from the target phase")
        launches[name] += n
    lap("targets")
    for name, n in phase_sharded(torch, np, dev, atm, hurricane, card).items():
        launches[name] += n
    lap("sharded")
    phase_mesh_serve(torch, np, dev, card)
    lap("mesh-serve")
    phase_mesh_train(torch, np, dev, card)
    lap("mesh-train")
    phase_mesh_moe(torch, np, dev, card)
    lap("mesh-moe")
    phase_mesh_families(torch, np, dev, card)
    lap("mesh-families")
    phase_mesh_families(torch, np, dev, card, table="cache")
    lap("mesh-cache")
    phase_dryrun(torch, np, dev, card, cells)
    lap("dryrun")
    del atm, hurricane, by_mode
    launches.update(phase_decode(torch, np, dev, rows))
    phase_cpu_vs_card(torch, np, dev)
    phase_targets_cpu_vs_card(torch, np, dev)
    lap("decode, cpu-vs-card")
    launches.update(phase_kv(torch, np, dev))
    lap("kv")
    phase_serve_static(torch, np, dev)
    k6_serve, served = phase_serve(torch, np, dev)
    launches["bot3d_fused"] += k6_serve
    phase_serve_raw(torch, np, dev, served)
    del served
    free_card(torch)
    lap("serve")
    launches["bot3d_fused"] += phase_serve_moe(torch, np, dev)
    free_card(torch)
    phase_serve_mla(torch, np, dev)
    free_card(torch)
    phase_moe_mla_cpu_vs_card(torch, np, dev)
    free_card(torch)
    lap("serve-moe, serve-mla")
    recurrent_only(torch, np, dev)
    free_card(torch)
    lap("recurrent")
    phase_train(torch, np, dev)
    phase_train_ckpt(torch, np, dev)
    phase_train_cpu_vs_card(torch, np, dev)
    free_card(torch)
    lap("train")
    zoo_only(torch, np, dev)
    lap("zoo")

    kernels = []
    for name, (replaces, source) in KERNELS.items():
        p = parity[name]
        check(launches[name] > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=p["max_abs_err"], ms=p["ms"],
            plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=p["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

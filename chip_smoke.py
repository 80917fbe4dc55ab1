#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from `src/repro_torch/csrc/`, then, failing
loudly (non-zero exit) at the first phase that goes wrong:

1. prints the card's name and power limit, the torch/CUDA versions and
   the TF32 switches;
2. times the kernel build;
3. parity: each kernel against its plain torch version on the card, exact,
   at the main path's shapes and at ragged ones, with its median time, the
   plain version's time and the bound from bytes moved;
4. the main path: CESM-ATM-like 1800x3600 fields and the first
   Hurricane-like 100x500x500 fields that Algorithm 1 gives to SZ and to
   ZFP (`benchmarks/common.py`) through `compress(...,
   Policy.fixed_accuracy(eb_rel=1e-4), device_encode=True)` and
   `decompress`, asserting that the SZ fields ran K1 (2-D) and K2 (3-D),
   that a ZFP field is among them, that no field's device encode was
   declined and that every decoded value is within eb_abs;
5. CPU against card at reduced sizes: decisions within the golden-suite
   tolerances and container bytes equal for the same `Selection`;
6. one JSON line with every kernel's launches, error, times and bound.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
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
K1_SHAPES = [(1800, 3600), (300, 517), (8, 128), (4, 40), (1, 5)]
K2_SHAPES = [(100, 500, 500), (7, 64, 64), (4, 4, 129)]
REPLACES = {
    "lorenzo2d_encode": "src/repro/kernels/lorenzo.py:54",
    "lorenzo3d_encode": "src/repro/kernels/lorenzo.py:143",
}
#: float32 operations per value: a division and a rounding, then the
#: 2^nd - 1 additions of the n-D Lorenzo difference
OPS_PER_VALUE = {"lorenzo2d_encode": 2 + 3, "lorenzo3d_encode": 2 + 7}


def bound(name: str, numel: int) -> tuple[float, str]:
    """The least time (ms) the card could take for one call, and what sets
    it: each f32 input read once and each int32 code written once over the
    HBM rate, against the operations over the float32 peak."""
    by_bytes = numel * (4 + 4) / HBM_BYTES_PER_S * 1e3
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


def time_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median device time of `fn` over `reps` launches, each timed with CUDA
    events after overwriting a buffer larger than L2 (cold cache)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def phase_parity(torch, np, dev, flush):
    from repro_torch.kernels import lorenzo, ref

    results = {}
    for name, shapes in (("lorenzo2d_encode", K1_SHAPES), ("lorenzo3d_encode", K2_SHAPES)):
        kernel = getattr(lorenzo, name)
        worst = 0
        for i, shape in enumerate(shapes):
            x, eb = tie_field(np, shape, 10 + i)
            xt = torch.from_numpy(x).to(dev)
            got = kernel(xt, eb)
            want = ref.lorenzo_encode_ref(xt, eb)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"{name} differs from its plain version at {shape}: {err}")
            worst = max(worst, err)
        x, eb = tie_field(np, shapes[0], 99)
        xt = torch.from_numpy(x).to(dev)
        ms = time_ms(torch, lambda: kernel(xt, eb), flush)
        plain_ms = time_ms(torch, lambda: ref.lorenzo_encode_ref(xt, eb), flush)
        bound_ms, bound_by = bound(name, xt.numel())
        results[name] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        log("parity", f"{name}: exact at {shapes}; {list(shapes[0])}: {ms} ms "
            f"(plain {plain_ms} ms, bound {bound_ms} ms by {bound_by})")
    return results


def phase_main(torch, np, dev):
    from benchmarks.common import atm_suite, hurricane_suite, psnr
    from repro_torch.core import Policy, compress, compression_ratio, decompress, select
    from repro_torch.core import device_encode as de
    from repro_torch.kernels import lorenzo

    t0 = time.perf_counter()
    fields = dict(atm_suite(4, size=(1800, 3600)))
    hurricane = hurricane_suite(13, size=(100, 500, 500))
    log("fields", f"generated {len(fields) + len(hurricane)} in "
        f"{time.perf_counter() - t0:.1f} s")
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
    del hurricane
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this smoke runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
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
    _build.build(verbose=True)
    _build.load()
    log("build", f"{_build.library_path().name} in {time.perf_counter() - t0:.2f} s")

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MiB > L2
    parity = phase_parity(torch, np, dev, flush)
    del flush
    rows, launches = phase_main(torch, np, dev)
    phase_kernels_at_main(torch, dev, rows, parity)
    phase_cpu_vs_card(torch, np, dev)

    kernels = []
    for name, p in parity.items():
        kernels.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/lorenzo.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=p["max_abs_err"], ms=p["ms"], plain_ms=p["plain_ms"],
            bound_ms=p["bound_ms"], bound_by=p["bound_by"], library_ms=None,
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quality-target controller: fixed-PSNR, fixed-ratio and the metric modes
(DESIGN.md §7), in torch.

Port of `repro.core.controller`, its warm path included (a
`DecisionCache` replays solved fields and can seed the secant of drifted
ones from their previous bound). The selection
engine answers "which codec is cheapest at this error bound"; callers
usually hold a quality target instead ("60 dB", "8x", "SSIM 0.97"). The
controller solves for the per-field bound that meets the target on the
estimated (or sample-measured) rate-distortion curves, with no trial
compressions, and hands the `Selection` to the ordinary encoders:

* ``fixed_psnr`` — the closed-form inversion of Eq. (10) seeds SZ's bin
  size, and a few secant steps against the measured quantization error of
  the sampled blocks absorb what the uniform-noise model misses; ZFP's
  bound walks its estimated-PSNR staircase the same way. The codec with the
  smaller estimated rate within the PSNR band wins.
* ``fixed_ratio`` — both codecs are driven to the byte budget from a
  high-rate-model seed with clamped secant steps, and the codec with the
  higher estimated PSNR at the budget wins.
* ``fixed_ssim`` / ``fixed_correlation`` / ``fixed_ks`` — each metric
  target becomes a per-field equivalent-PSNR target (`core/quality.py`),
  which the fixed_psnr machinery solves.
* ``fixed_accuracy`` — delegated to `select_many`.

As in the reference, the secant, the seeds and the eligibility windows are
float64 numpy on the host; only the sweeps run in torch on the fields'
device. A sweep evaluates the packed block batch of `select_many` once per
candidate bound (the reference vmaps the candidates; each candidate's
values are the same). The fixed_psnr and metric rounds run the light sweep,
which counts no coder bits.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _device
from . import codecs as _codecs
from . import estimator as est
from . import quality as qual
from .policy import TARGET_FIELD, Policy, policy_from_kwargs
from .selector import (
    MAX_BATCH_FIELDS,
    Selection,
    _degenerate_selection,
    _fold_ndim,
    _max_batch_blocks,
    _numel,
    _pack_blocks,
    cache_key,
    check_names,
    select_many,
)

#: the codecs' working dtype is float32, so ratio targets are defined
#: against 32 bits/value (matching `compression_ratio`)
RAW_BITS = 32.0

#: fixed_psnr: ZFP is eligible only when its estimated PSNR lands within
#: this many dB above the target (its bit-plane staircase otherwise
#: overshoots by up to ~6 dB a plane); SZ always competes
PSNR_TOL_DB = 0.5
#: a probe meets a PSNR target when it clears it minus this slack
PSNR_SLACK_DB = 0.25

#: fixed_ratio: a codec is eligible when its estimated rate is within this
#: relative window of the budget
RATIO_TOL = 0.10
#: a rate probe meets the budget up to this relative overage
RATE_SLACK = 0.02

#: the SZ estimate's flat +0.5 bits/value Huffman cushion is a selection
#: worst case, not what the byte coder pays; rate targets use an empirical
#: overhead curve instead (`_sz_coder_rate`)
SZ_HUFF_FLOOR = 0.08
SZ_HUFF_PEAK_SLOPE = 0.85

#: high-rate-model slopes that seed and clamp the secant steps: one octave
#: of bound costs ~1 bit/value, ~6.02 dB
DB_PER_OCTAVE = 20.0 * math.log10(2.0)
#: secant-slope clamps, [steepest, shallowest]
PSNR_SLOPE_CLAMP = (-30.0, -1.0)
RATE_SLOPE_CLAMP = (-4.0, -0.25)

#: refinement evals after the seed eval, by mode; every mode ends in one
#: full pricing eval
DEFAULT_ROUNDS = {
    "fixed_psnr": 3,
    "fixed_ratio": 3,
    "fixed_ssim": 3,
    "fixed_correlation": 3,
    "fixed_ks": 3,
}

#: the metric modes' host work, accumulated: the one copy of each member's
#: halo blocks to the host (bytes, wall ms) and the float64 statistics and
#: metric inversion on them (wall ms)
HOST_WORK = {"copy_bytes": 0, "copy_ms": 0.0, "stats_ms": 0.0}


@dataclass
class TargetSolution:
    """One field's solved target: the `Selection` to encode with, plus the
    estimates the solve ended on (what the controller believes it hit)."""

    selection: Selection
    mode: str
    target: float        # dB (fixed_psnr), ratio (fixed_ratio), eb (fixed_accuracy),
                         # metric value (fixed_ssim / fixed_correlation / fixed_ks)
    est_psnr: float      # estimated/measured PSNR of the chosen codec
    est_bitrate: float   # estimated bits/value of the chosen codec
    on_target: bool      # False when the solve could only get best-effort close
    #: predicted metric value of the chosen codec (metric modes only; None
    #: elsewhere, so entries without it deserialize unchanged)
    est_metric: float | None = None

    @property
    def est_ratio(self) -> float:
        return RAW_BITS / max(self.est_bitrate, 1e-6)


def _sz_coder_rate(br_est: np.ndarray) -> np.ndarray:
    """Map the SZ estimate (entropy + flat +0.5 cushion) to the rate the
    byte coder pays: entropy + an overhead that decays to `SZ_HUFF_FLOOR`
    for rich residual PDFs and grows toward the 1-bit/symbol Huffman floor
    as the PDF peaks. Monotone in `br_est`."""
    ent = np.maximum(np.asarray(br_est, np.float64) - est.SZ_BITRATE_OFFSET, 0.0)
    return ent + np.maximum(1.0 - SZ_HUFF_PEAK_SLOPE * ent, SZ_HUFF_FLOOR)


# ---------------------------------------------------------------------------
# The sweep: the batched estimators, once per candidate bound
# ---------------------------------------------------------------------------


def _block_energy(err: torch.Tensor) -> torch.Tensor:
    """Per-block sum of squares of float32 (n, 4, ..) blocks in the order
    and roundings of the reference's compiled reduction on the CPU: a 1-D
    block accumulates its four squares in turn with FMAs; a 2-D block (and
    each 4x4 plane of a 3-D block, in turn) accumulates each row's squares
    into its own lane with FMAs, the running total riding in lane 0, and
    sums the lanes as (l0 + l2) + (l1 + l3)."""
    n = err.shape[0]
    e = err.double()
    if e.ndim == 2:
        s = torch.zeros_like(e[:, 0])
        for j in range(4):
            s = est._round32(torch.addcmul(s, e[:, j], e[:, j]))
        return s.float()
    planes = e.reshape(n, -1, 4, 4)
    s = torch.zeros(n, dtype=torch.float32, device=err.device)
    for p in range(planes.shape[1]):
        lanes = torch.zeros(n, 4, dtype=torch.float64, device=err.device)
        lanes[:, 0] = s
        for j in range(4):
            col = planes[:, p, :, j]
            lanes = est._round32(torch.addcmul(lanes, col, col))
        lanes = lanes.float()
        s = (lanes[:, 0] + lanes[:, 2]) + (lanes[:, 1] + lanes[:, 3])
    return s


def _sz_measured_psnr(nohalo, seg, bounds, delta_f, vr_f) -> torch.Tensor:
    """PSNR of the actual quantization error `x - delta*round(x/delta)` on
    the sampled blocks: what the SZ codec achieves, including the
    sub-uniform error of fields with constant runs, which the Eq. (11)
    model misses by up to ~3 dB. Every step rounds as the reference's
    compiled sweep does (the secant amplifies an ulp into a different
    probe): the error in one rounding (a fused multiply-subtract), the
    block energies in `_block_energy`'s order, the field sums blocked as
    `jnp.cumsum`, XLA's log."""
    nd = nohalo.ndim - 1
    d = delta_f[seg].reshape((-1,) + (1,) * nd)
    q = torch.round(nohalo / d)
    err = (nohalo.double() - d.double() * q.double()).float()
    vr64 = torch.clamp_min(vr_f, 1e-30)
    err2_blk = _block_energy(err) / torch.square(vr64[seg])
    err2_f = est.field_sums(err2_blk, bounds)
    n_f = (bounds[1:] - bounds[:-1]).to(torch.float32) * float(4**nd)
    mse_over_vr2 = err2_f / torch.clamp_min(n_f, 1.0)
    return est._neg10_log10(mse_over_vr2)


def _eval_one(halo, seg, bounds, eb_f, delta_f, vr_f, size_f, transform: str, kind: str):
    """One candidate: ZFP at eb_f and SZ at bin size delta_f on the same
    blocks. 'light' gives (psnr_zfp, psnr_sz_measured); 'rate' gives
    (br_sz, br_zfp), ZFP's from the one-pass `block_bits` coder model;
    'full' gives (br_sz, psnr_sz, br_zfp, psnr_zfp, psnr_sz_measured)."""
    nd = halo.ndim - 1
    nohalo = halo[(slice(None),) + (slice(1, None),) * nd]
    if kind == "rate":
        e_zfp = est.estimate_zfp_many(nohalo, seg, bounds, eb_f, vr_f, transform,
                                      mode="model", psnr=False)
        e_sz = est.estimate_sz_many(halo, seg, bounds, delta_f, vr_f, size_f)
        return e_sz.bitrate, e_zfp.bitrate
    zfp_mode = "psnr" if kind == "light" else "exact"
    e_zfp = est.estimate_zfp_many(nohalo, seg, bounds, eb_f, vr_f, transform, mode=zfp_mode)
    ps_meas = _sz_measured_psnr(nohalo, seg, bounds, delta_f, vr_f)
    if kind == "light":
        return e_zfp.psnr, ps_meas
    e_sz = est.estimate_sz_many(halo, seg, bounds, delta_f, vr_f, size_f)
    return e_sz.bitrate, e_sz.psnr, e_zfp.bitrate, e_zfp.psnr, ps_meas


@dataclass
class _Member:
    idx: int               # position in the caller's field list
    blocks: torch.Tensor   # halo blocks on the device, (n_blocks, 5, ..)
    vr: float
    size: int


class _Sweep:
    """One packed batch (`selector._pack_blocks`, as `select_many` packs it)
    exposing `full` / `rate` / `light` candidate sweeps. Inputs are
    (n_cand, n_real_fields) per-field bounds (eb for ZFP, bin size delta
    for SZ); outputs are (n_cand, n_real_fields) float32 arrays."""

    def __init__(self, members: list[_Member], transform: str):
        self.transform = transform
        halo, seg, bounds, self.n_fields = _pack_blocks([m.blocks for m in members])
        self.n_real_fields = len(members)
        vr_p = np.ones(self.n_fields, np.float32)
        vr_p[: self.n_real_fields] = [m.vr for m in members]
        size_p = np.ones(self.n_fields, np.float32)
        size_p[: self.n_real_fields] = [m.size for m in members]
        dev = halo.device
        self._args = (
            halo, seg, bounds, torch.from_numpy(vr_p).to(dev), torch.from_numpy(size_p).to(dev)
        )

    def _run(self, eb_c, delta_c, kind: str):
        n_cand = eb_c.shape[0]
        ebp = np.ones((n_cand, self.n_fields), np.float32)
        ebp[:, : self.n_real_fields] = np.maximum(eb_c, 1e-38)
        dp = np.ones((n_cand, self.n_fields), np.float32)
        dp[:, : self.n_real_fields] = np.maximum(delta_c, 1e-38)
        halo, seg, bounds, vr, size = self._args
        ebt = torch.from_numpy(ebp).to(halo.device)
        dt = torch.from_numpy(dp).to(halo.device)
        per_cand = [
            torch.stack(_eval_one(halo, seg, bounds, ebt[c], dt[c], vr, size,
                                  self.transform, kind))
            for c in range(n_cand)
        ]
        out = torch.stack(per_cand, dim=1).cpu().numpy()  # (outputs, n_cand, F)
        return tuple(o[:, : self.n_real_fields] for o in out)

    def full(self, eb_c, delta_c):
        """(br_sz, psnr_sz_model, br_zfp, psnr_zfp, psnr_sz_measured)."""
        return self._run(eb_c, delta_c, "full")

    def rate(self, eb_c, delta_c):
        """(br_sz, br_zfp) with the one-pass block_bits ZFP coder model:
        probe-grade rates for the fixed_ratio refinement rounds."""
        return self._run(eb_c, delta_c, "rate")

    def light(self, eb_c, delta_c):
        """(psnr_zfp, psnr_sz_measured) only; no coder bits, no entropy."""
        return self._run(eb_c, delta_c, "light")


# ---------------------------------------------------------------------------
# Vectorized secant root-finding on a nonincreasing sampled curve
# ---------------------------------------------------------------------------


class _Secant:
    """Per-field secant iteration for `g(x) = target` where g is
    nonincreasing in x (= log2 bound) and only eval-able in batches.

    Tracks the best feasible probe (g clears the target: `g >= target` for
    PSNR, `g <= target` for rate, pass `ge=False`) closest to the target,
    plus a bracket for safeguarding; steps are clamped to the model slope
    range so a flat staircase section cannot fling the iterate."""

    def __init__(self, x0, g0, target, slope0, slope_clamp, ge: bool, x_lo, x_hi):
        F = len(x0)
        self.t, self.ge = np.asarray(target, np.float64), ge
        self.slope0, self.clamp = slope0, slope_clamp
        self.x_lo, self.x_hi = x_lo, x_hi
        self.xp = np.full(F, np.nan)
        self.gp = np.full(F, np.nan)
        self.xc, self.gc = np.asarray(x0, np.float64), np.asarray(g0, np.float64)
        # bracket: blo = largest x still clearing, bhi = smallest x missing
        self.blo = np.full(F, -np.inf)
        self.bhi = np.full(F, np.inf)
        self.x_best = np.full(F, np.nan)
        self.g_best = np.full(F, np.nan)
        self._absorb(self.xc, self.gc)

    def _clears(self, g):
        if self.ge:
            return g >= self.t - PSNR_SLACK_DB
        return g <= self.t * (1.0 + RATE_SLACK)

    def _absorb(self, x, g):
        ok = self._clears(g)
        # bracket sides follow g's direction, not feasibility
        above = ok if self.ge else ~ok
        self.blo = np.where(above, np.maximum(self.blo, x), self.blo)
        self.bhi = np.where(~above, np.minimum(self.bhi, x), self.bhi)
        # feasible-best: the clearing probe closest to the target
        gap = np.abs(g - self.t)
        better = ok & (np.isnan(self.g_best) | (gap < np.abs(self.g_best - self.t)))
        self.x_best = np.where(better, x, self.x_best)
        self.g_best = np.where(better, g, self.g_best)

    def propose(self):
        dx = self.xc - self.xp
        dg = self.gc - self.gp
        slope = np.where(np.abs(dx) > 1e-9, dg / np.maximum(np.abs(dx), 1e-9) * np.sign(dx), self.slope0)
        slope = np.clip(np.nan_to_num(slope, nan=self.slope0), *self.clamp)
        xn = self.xc + (self.t - self.gc) / slope
        # safeguard: project into the bracket when the secant leaves it
        have = np.isfinite(self.blo) & np.isfinite(self.bhi)
        mid = 0.5 * (self.blo + self.bhi)
        xn = np.where(have & ((xn <= self.blo) | (xn >= self.bhi)), mid, xn)
        return np.clip(xn, self.x_lo, self.x_hi)

    def step(self, xn, gn):
        self.xp, self.gp = self.xc, self.gc
        self.xc, self.gc = np.asarray(xn, np.float64), np.asarray(gn, np.float64)
        self._absorb(self.xc, self.gc)

    @property
    def found(self):
        return ~np.isnan(self.x_best)


# ---------------------------------------------------------------------------
# Mode solvers (vectorized across the fields of one batch)
# ---------------------------------------------------------------------------


#: refinement probes run on every k-th gathered block (the secant only
#: needs the curve's trend; the final pricing eval uses the full sample)
REFINE_STRIDE = 2


def _warm_seeds(warm, x0_s, x0_z, x_lo, x_hi):
    """Overlay cached warm-start seeds (log2 bounds, NaN = cold) onto the
    model seeds, clipped to the solver's x-range. With `warm=None` or
    all-NaN this returns the model seeds unchanged."""
    if warm is None:
        return x0_s, x0_z
    warm_s, warm_z = warm
    x0_s = np.where(np.isfinite(warm_s), np.clip(warm_s, x_lo, x_hi), x0_s)
    x0_z = np.where(np.isfinite(warm_z), np.clip(warm_z, x_lo, x_hi), x0_z)
    return x0_s, x0_z


def _solve_fixed_psnr(
    sweep: _Sweep, refine: _Sweep, vr: np.ndarray, target, rounds: int,
    r_sp: float, allowed: tuple[str, ...] = _codecs.DEFAULT_CODECS,
    warm=None,
) -> list[tuple[Selection, float, float, bool]]:
    """Per field: (Selection, est_psnr, est_bitrate, on_target).

    Seed: SZ bin size from the closed-form inversion of Eq. (10), ZFP bound
    at delta*/2, or the per-field `warm` seeds. Refine: `rounds` light-sweep
    secant steps drive both codecs' observed curves (measured quantization
    error for SZ, estimated truncation PSNR for ZFP) onto the target; one
    final full eval prices the two solutions for the min-rate choice.
    `target` is a scalar dB value or a per-field (F,) array (the metric
    modes' equivalent-PSNR targets).
    """
    tq = (
        np.round(np.asarray(target, np.float64) / est.PSNR_MATCH_QUANTUM)
        * est.PSNR_MATCH_QUANTUM
    )
    # the reference runs this seed outside jit, op by op
    delta_star = est.sz_delta_for_psnr(
        torch.as_tensor(np.asarray(target), dtype=torch.float32),
        torch.as_tensor(np.asarray(vr, np.float32)),
        eager=True,
    ).numpy()
    lvr = np.log2(np.maximum(vr, 1e-30)).astype(np.float64)
    ld0 = np.log2(np.maximum(delta_star, 1e-38)).astype(np.float64)
    x0_s, x0_z = _warm_seeds(warm, ld0, ld0 - 1.0, lvr - 30.0, lvr + 1.0)
    pz0, ps0 = refine.light(np.exp2(x0_z)[None].astype(np.float32),
                            np.exp2(x0_s)[None].astype(np.float32))
    s_sz = _Secant(x0_s, ps0[0], tq, -DB_PER_OCTAVE, PSNR_SLOPE_CLAMP,
                   ge=True, x_lo=lvr - 30.0, x_hi=lvr + 1.0)
    s_z = _Secant(x0_z, pz0[0], tq, -DB_PER_OCTAVE, PSNR_SLOPE_CLAMP,
                  ge=True, x_lo=lvr - 30.0, x_hi=lvr + 1.0)
    for _ in range(rounds):
        xs, xz = s_sz.propose(), s_z.propose()
        pz, ps = refine.light(np.exp2(xz)[None].astype(np.float32),
                              np.exp2(xs)[None].astype(np.float32))
        s_z.step(xz, pz[0])
        s_sz.step(xs, ps[0])
    # final bounds: feasible-best, falling back to the seed
    x_s = np.where(s_sz.found, s_sz.x_best, x0_s)
    x_z = np.where(s_z.found, s_z.x_best, x0_z)
    br_sz_raw, _, br_zfp, ps_zfp, ps_meas = sweep.full(
        np.exp2(x_z)[None].astype(np.float32), np.exp2(x_s)[None].astype(np.float32)
    )
    br_s = _sz_coder_rate(br_sz_raw[0])
    br_z, ps_z, ps_s = br_zfp[0], ps_zfp[0], ps_meas[0]
    zfp_ok = s_z.found & (ps_z <= tq + PSNR_TOL_DB) & (ps_z >= tq - PSNR_SLACK_DB)
    out = []
    F = len(vr)
    tq_f = np.broadcast_to(np.asarray(tq, np.float64), (F,))
    for f in range(F):
        tqf = float(tq_f[f])
        eb_s = float(np.exp2(x_s[f])) / 2.0
        cands = []
        if "sz" in allowed:
            cands.append(("sz", float(br_s[f]), float(ps_s[f]), eb_s))
        if zfp_ok[f] and "zfp" in allowed:
            cands.append(("zfp", float(br_z[f]), float(ps_z[f]), float(np.exp2(x_z[f]))))
        if not cands:
            # the allowlist left only ZFP and its staircase missed the band:
            # best effort on its solved bound (flagged off-target below)
            cands = [("zfp", float(br_z[f]), float(ps_z[f]), float(np.exp2(x_z[f])))]
        codec, br, ps, eb = min(cands, key=lambda c: c[1])
        if br >= RAW_BITS:
            # incompressible at this quality: raw is exact, PSNR = inf
            codec, br, ps = "raw", RAW_BITS, math.inf
        on_target = codec == "raw" or abs(ps - tqf) <= 2.0 * PSNR_TOL_DB
        sel = Selection(
            codec, eb, eb_s, float(br_s[f]), float(br_z[f]),
            ps if codec != "raw" else tqf, float(vr[f]), r_sp,
        )
        out.append((sel, ps, br, on_target))
    return out


def _solve_fixed_ratio(
    sweep: _Sweep, refine: _Sweep, vr: np.ndarray, target: float, rounds: int,
    r_sp: float, allowed: tuple[str, ...] = _codecs.DEFAULT_CODECS,
    warm=None,
) -> list[tuple[Selection, float, float, bool]]:
    """Per field: (Selection, est_psnr, est_bitrate, on_target).

    Both codecs are driven to `rate <= RAW_BITS/target` from a mid-curve
    seed via the ~1 bit/octave model plus clamped secant steps on
    rate-grade probes, then priced on the full sample with up to two
    corrective steps; the higher-PSNR codec inside the window wins.
    """
    br_t = RAW_BITS / float(target)
    lvr = np.log2(np.maximum(vr, 1e-30)).astype(np.float64)
    x0 = lvr - 8.0
    x0_s, x0_z = _warm_seeds(warm, x0, x0, lvr - 26.0, lvr)
    br_s0, br_z0 = refine.rate(
        np.exp2(x0_z)[None].astype(np.float32),
        np.exp2(x0_s)[None].astype(np.float32),
    )
    s_sz = _Secant(x0_s, _sz_coder_rate(br_s0[0]), br_t, -1.0, RATE_SLOPE_CLAMP,
                   ge=False, x_lo=lvr - 26.0, x_hi=lvr)
    s_z = _Secant(x0_z, br_z0[0], br_t, -1.0, RATE_SLOPE_CLAMP,
                  ge=False, x_lo=lvr - 26.0, x_hi=lvr)
    for _ in range(rounds):
        xs, xz = s_sz.propose(), s_z.propose()
        br_s, br_z = refine.rate(np.exp2(xz)[None].astype(np.float32),
                                 np.exp2(xs)[None].astype(np.float32))
        s_sz.step(xs, _sz_coder_rate(br_s[0]))
        s_z.step(xz, br_z[0])
    # final bounds: feasible-best; an unreachable budget rails at the
    # loosest bound evaluated (fmax: with rounds=0 xp is NaN)
    x_s = np.where(s_sz.found, s_sz.x_best, np.fmax(s_sz.xc, s_sz.xp))
    x_z = np.where(s_z.found, s_z.x_best, np.fmax(s_z.xc, s_z.xp))

    def _price(xs, xz):
        br_sz_raw, _, br_zfp, ps_zfp, ps_meas = sweep.full(
            np.exp2(xz)[None].astype(np.float32), np.exp2(xs)[None].astype(np.float32)
        )
        return _sz_coder_rate(br_sz_raw[0]), br_zfp[0], ps_zfp[0], ps_meas[0]

    br_s, br_z, ps_z, ps_s = _price(x_s, x_z)
    # polish: up to two corrective steps against the full-sample price for
    # fields outside the rate window (the first on the ~1 bit/octave model
    # slope, the second on the slope the first one measured)
    lo_w, hi_w = br_t / (1.0 + RATIO_TOL), br_t * (1.0 + RATE_SLACK)
    prev = None
    for _ in range(2):
        need_s = (br_s > hi_w) | (br_s < lo_w)
        need_z = (br_z > hi_w) | (br_z < lo_w)
        if not (need_s.any() or need_z.any()):
            break
        slope_s = np.full_like(br_s, -1.0)
        slope_z = np.full_like(br_z, -1.0)
        if prev is not None:
            px_s, pbr_s, px_z, pbr_z = prev
            ds, dz = x_s - px_s, x_z - px_z
            slope_s = np.where(np.abs(ds) > 1e-9, (br_s - pbr_s) / np.where(np.abs(ds) > 1e-9, ds, 1.0), -1.0)
            slope_z = np.where(np.abs(dz) > 1e-9, (br_z - pbr_z) / np.where(np.abs(dz) > 1e-9, dz, 1.0), -1.0)
            slope_s = np.clip(slope_s, -4.0, -0.1)
            slope_z = np.clip(slope_z, -4.0, -0.1)
        prev = (x_s.copy(), br_s.copy(), x_z.copy(), br_z.copy())
        x_s = np.clip(np.where(need_s, x_s + (br_t - br_s) / slope_s, x_s), lvr - 26.0, lvr)
        x_z = np.clip(np.where(need_z, x_z + (br_t - br_z) / slope_z, x_z), lvr - 26.0, lvr)
        br_s, br_z, ps_z, ps_s = _price(x_s, x_z)
    out = []
    for f in range(len(vr)):
        cands = []
        for name, br, ps, bound in (
            ("sz", float(br_s[f]), float(ps_s[f]), float(np.exp2(x_s[f])) / 2.0),
            ("zfp", float(br_z[f]), float(ps_z[f]), float(np.exp2(x_z[f]))),
        ):
            if name not in allowed:
                continue
            in_window = (br <= br_t * (1.0 + RATE_SLACK)) and (
                br >= br_t / (1.0 + RATIO_TOL)
            )
            cands.append((name, br, ps, bound, in_window))
        eligible = [c for c in cands if c[4]]
        if eligible:
            codec, br, ps, bound, _ = max(eligible, key=lambda c: c[2])
            on_target = True
        else:
            # best effort: closest estimated rate to the budget
            codec, br, ps, bound, _ = min(
                cands, key=lambda c: abs(math.log(max(c[1], 1e-6) / br_t))
            )
            on_target = False
        if br >= RAW_BITS:
            codec, br, ps = "raw", RAW_BITS, math.inf
            on_target = target <= 1.0 + 1e-9
        eb_s = float(np.exp2(x_s[f])) / 2.0
        sel = Selection(
            codec, bound if codec == "zfp" else eb_s, eb_s,
            float(br_s[f]), float(br_z[f]),
            ps if codec != "raw" else 0.0, float(vr[f]), r_sp,
        )
        out.append((sel, ps, br, on_target))
    return out


def _solve_fixed_metric(
    sweep: _Sweep, refine: _Sweep, batch: list[_Member], nd: int,
    vr: np.ndarray, mode: str, target: float, rounds: int, r_sp: float,
    allowed: tuple[str, ...] = _codecs.DEFAULT_CODECS, warm=None,
) -> list[tuple[Selection, float, float, bool, float]]:
    """Per field: (Selection, est_psnr, est_bitrate, on_target, est_metric)
    for fixed_ssim / fixed_correlation / fixed_ks: the metric statistics
    from the same halo blocks (on the host), the metric target inverted
    into a per-field equivalent-PSNR target, the fixed-PSNR solve on those
    targets, and the achieved metric read back off the solved PSNR."""
    metric = qual.MODE_METRIC[mode]
    t0 = time.perf_counter()
    host = [m.blocks.cpu().numpy() for m in batch]  # one copy a member
    t1 = time.perf_counter()
    stats = [qual.stats_from_blocks(b, nd, m.vr) for b, m in zip(host, batch)]
    psnr_t = np.asarray(
        [qual.equivalent_psnr(metric, target, s) for s in stats], np.float64
    )
    HOST_WORK["copy_bytes"] += sum(h.nbytes for h in host)
    HOST_WORK["copy_ms"] += (t1 - t0) * 1e3
    HOST_WORK["stats_ms"] += (time.perf_counter() - t1) * 1e3
    del host
    solved = _solve_fixed_psnr(
        sweep, refine, vr, psnr_t, rounds, r_sp, allowed, warm=warm
    )
    tol = qual.TOLERANCE[metric]
    out = []
    for f, (sel, ps, br, _on) in enumerate(solved):
        if sel.codec == "raw":
            m_a = qual.LOSSLESS_VALUE[metric]
            on = True
        else:
            m_a = qual.metric_from_psnr(metric, ps, stats[f])
            # SSIM/correlation are floors, KS a ceiling; within-tolerance
            # misses still count as on target
            on = qual.metric_gap(metric, m_a, float(target)) <= tol
        out.append((sel, ps, br, on, float(m_a)))
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def solve_many(
    fields,
    policy: Policy | str,
    *,
    target_psnr: float | None = None,
    target_ratio: float | None = None,
    eb_abs: float | None = None,
    eb_rel: float | None = None,
    r_sp: float | None = None,
    transform: str = "zfp",
    rounds: int | None = None,
    cache=None,
    names=None,
    device=None,
) -> list[TargetSolution]:
    """Solve the quality target for many fields with batched sweeps on
    `device` (default the GPU).

    `policy` is the quality contract (`core/policy.py`):

    * `Policy.fixed_psnr(db)`   — target dB, relative to each field's
                                  value range;
    * `Policy.fixed_ratio(x)`   — x vs 32-bit raw;
    * `Policy.fixed_ssim(s)` / `Policy.fixed_correlation(rho)` /
      `Policy.fixed_ks(d)`      — metric targets, inverted to per-field
                                  equivalent-PSNR targets via
                                  `core/quality.py` (solutions carry the
                                  predicted metric in `est_metric`);
    * `Policy.fixed_accuracy(...)` — delegates to `select_many`, so all the
                                  modes share one entry point.

    The policy's `codecs` allowlist restricts which codecs compete; its
    `r_sp` sets the estimator sampling rate. A mode string plus the old
    target/eb/r_sp keywords is the deprecated spelling of the same policy.

    Fields that cannot carry a target (too small, constant, NaN-poisoned)
    fall back to raw as in `select_many` (`on_target=False` for
    fixed_ratio, since raw pins the ratio to 1). Fields whose sample would
    exceed a batch's block cap are strided down to it, so every field stays
    in the batched sweep. Returns one `TargetSolution` per field, in order.

    `cache` (a `DecisionCache`) with `names` takes the warm path:
    fingerprint-validated fields replay the previous `TargetSolution`
    without entering the sweep; with ``cache.warm_start`` an invalidated
    entry seeds the secant from its previously solved bound.
    """
    if isinstance(policy, str):
        policy = policy_from_kwargs(
            "solve_many", mode=policy, eb_abs=eb_abs, eb_rel=eb_rel,
            target_psnr=target_psnr, target_ratio=target_ratio, r_sp=r_sp,
        )
    elif not isinstance(policy, Policy):
        raise TypeError(f"expected a Policy (or legacy mode str), got {policy!r}")
    elif any(v is not None for v in (target_psnr, target_ratio, eb_abs, eb_rel, r_sp)):
        raise ValueError("pass either policy= or the legacy target kwargs, not both")
    dev = _device.resolve(device)
    fields = list(fields)
    mode = policy.mode
    if mode == "raw":
        raise ValueError("solve_many has nothing to solve for Policy.raw()")
    if mode == "fixed_accuracy":
        sels = select_many(
            fields, policy=policy, transform=transform, cache=cache, names=names, device=dev
        )
        # raw stores are lossless at exactly 32 b/v, whatever the estimates
        return [
            TargetSolution(
                s, mode, s.eb_abs,
                math.inf if s.codec == "raw" else s.psnr_target,
                RAW_BITS if s.codec == "raw" else min(s.br_sz, s.br_zfp),
                True,
            )
            for s in sels
        ]
    attr = TARGET_FIELD.get(mode)
    if attr is None:
        raise ValueError(
            f"solve_many cannot solve mode {mode!r}; supported target "
            f"modes: {', '.join(TARGET_FIELD)}"
        )
    target = float(getattr(policy, attr))
    n_rounds = DEFAULT_ROUNDS[mode] if rounds is None else rounds
    results: list[TargetSolution | None] = [None] * len(fields)
    groups = _build_solve_members(
        fields, range(len(fields)), results, mode, target, policy.r_sp, dev
    )
    if cache is None:
        _solve_groups(
            groups, results, mode, target, n_rounds, policy.r_sp, transform, policy.codecs
        )
        return results  # type: ignore[return-value]
    _solve_many_cached(
        fields, names, results, groups, cache, policy, mode, target, n_rounds, transform
    )
    return results  # type: ignore[return-value]


def _solve_many_cached(
    fields,
    names,
    results: list[TargetSolution | None],
    groups: dict[int, list[_Member]],
    cache,
    policy: Policy,
    mode: str,
    target: float,
    n_rounds: int,
    transform: str,
) -> None:
    """Warm half of `solve_many`'s target modes, as `select_many`'s: replay
    the validated `TargetSolution`s and sweep only the misses. A miss whose
    entry merely drifted (key match, fingerprint mismatch) seeds the secant
    from its previously solved bound when the cache has `warm_start`."""
    from . import predictor as _pred

    names = check_names(names, fields)
    miss_groups: dict[int, list[_Member]] = {}
    warm: dict[int, tuple[float, float]] = {}
    to_store: list[tuple[int, str, tuple, str, dict]] = []
    for nd, members in groups.items():
        tuples = [(m.idx, m.blocks, 0.0, m.vr, m.size) for m in members]
        for m, (_stats, fp) in zip(members, _pred.stats_for_members(nd, tuples, policy.r_sp)):
            i = m.idx
            shape, dtype = cache_key(fields[i])
            entry = cache.lookup(names[i], shape, dtype, policy, transform, fp)
            if entry is not None and entry.solution is not None:
                results[i] = entry.to_solution()
                continue
            miss_groups.setdefault(nd, []).append(m)
            to_store.append((i, names[i], shape, dtype, fp))
            if cache.warm_start:
                prev = cache.stale(names[i], shape, dtype, policy, transform)
                if prev is not None and prev.solution is not None:
                    sel = prev.to_selection()
                    if sel.codec != "raw" and sel.eb_sz > 0:
                        x_s = math.log2(2.0 * sel.eb_sz)
                        x_z = (
                            math.log2(sel.eb_abs)
                            if sel.codec == "zfp" and sel.eb_abs > 0
                            else x_s - 1.0
                        )
                        warm[i] = (x_s, x_z)
    if miss_groups:
        _solve_groups(
            miss_groups, results, mode, target, n_rounds, policy.r_sp, transform,
            policy.codecs, warm=warm or None,
        )
    for i, name, shape, dtype, fp in to_store:
        sol = results[i]
        cache.store(name, shape, dtype, policy, transform, fp, sol.selection, solution=sol)


def _build_solve_members(
    fields,
    indices,
    results: list[TargetSolution | None],
    mode: str,
    target: float,
    r_sp: float,
    device: torch.device,
) -> dict[int, list[_Member]]:
    """Gather side of `solve_many`: fold, the degenerate raw fallback
    (written straight into `results`) and the monster-field stride-down;
    returns the batchable members by rank, each holding its sampled halo
    blocks on `device`. Each field is moved to the device one at a time."""
    groups: dict[int, list[_Member]] = {}
    for i, x in zip(indices, fields):
        view = _fold_ndim(_device.as_f32(x, device))
        vr = float(view.max() - view.min()) if view.numel() else 0.0
        sel0 = _degenerate_selection(view, vr, None, None, r_sp)
        if sel0 is not None:
            # raw is lossless, so every quality floor is met; only a rate
            # budget is missed (raw pins the ratio to 1)
            on = mode != "fixed_ratio"
            results[i] = TargetSolution(
                sel0, mode, target, math.inf, RAW_BITS, on,
                est_metric=qual.lossless_metric(mode),
            )
            continue
        starts = est.block_starts(tuple(view.shape), r_sp)
        cap = _max_batch_blocks(view.ndim)
        if len(starts) > cap:
            # monster field: stride the sample grid down to the batch cap
            # (a lower effective r_sp) so it still rides the batched sweep
            starts = starts[:: -(-len(starts) // cap)]
        groups.setdefault(view.ndim, []).append(
            _Member(i, est.gather_blocks(view, starts, halo=True), vr, _numel(view))
        )
        del view
    return groups


def _solve_groups(
    groups: dict[int, list[_Member]],
    results: list[TargetSolution | None],
    mode: str,
    target: float,
    n_rounds: int,
    r_sp: float,
    transform: str,
    codecs: tuple[str, ...] = _codecs.DEFAULT_CODECS,
    warm: dict[int, tuple[float, float]] | None = None,
) -> None:
    """Drive the per-batch target solvers over gathered `_Member`s, cut
    into batches in order within the block and field caps.

    `warm` maps a member index to (log2 SZ bin, log2 ZFP bound) secant
    seeds; unmapped members keep the cold model seeds."""
    for nd, members in groups.items():
        cap = _max_batch_blocks(nd)
        lo = 0
        while lo < len(members):
            hi, blocks = lo, 0
            while hi < len(members) and (
                hi == lo
                or (
                    blocks + len(members[hi].blocks) <= cap
                    and hi - lo < MAX_BATCH_FIELDS
                )
            ):
                blocks += len(members[hi].blocks)
                hi += 1
            batch = members[lo:hi]
            sweep = _Sweep(batch, transform)
            # refinement probes run on a strided sub-sample of the blocks
            # in hand; the final pricing eval uses the full sample
            refine = _Sweep(
                [_Member(m.idx, m.blocks[::REFINE_STRIDE], m.vr, m.size) for m in batch],
                transform,
            )
            vr_arr = np.asarray([m.vr for m in batch], np.float32)
            warm_batch = None
            if warm:
                warm_s = np.full(len(batch), np.nan)
                warm_z = np.full(len(batch), np.nan)
                for f, m in enumerate(batch):
                    if m.idx in warm:
                        warm_s[f], warm_z[f] = warm[m.idx]
                if np.isfinite(warm_s).any() or np.isfinite(warm_z).any():
                    warm_batch = (warm_s, warm_z)
            if mode in qual.MODE_METRIC:
                solved_m = _solve_fixed_metric(
                    sweep, refine, batch, nd, vr_arr, mode, target, n_rounds,
                    r_sp, codecs, warm=warm_batch,
                )
                for m, (sel, ps, br, on, met) in zip(batch, solved_m):
                    results[m.idx] = TargetSolution(
                        sel, mode, target, ps, br, on, est_metric=met
                    )
            else:
                solver = _solve_fixed_psnr if mode == "fixed_psnr" else _solve_fixed_ratio
                solved = solver(
                    sweep, refine, vr_arr, target, n_rounds, r_sp, codecs,
                    warm=warm_batch,
                )
                for m, (sel, ps, br, on) in zip(batch, solved):
                    results[m.idx] = TargetSolution(sel, mode, target, ps, br, on)
            lo = hi


def solve(x, policy: Policy | str, **kw) -> TargetSolution:
    """Single-field convenience wrapper over `solve_many`."""
    return solve_many([x], policy, **kw)[0]


def estimate_curves(
    x,
    bounds,
    r_sp: float = est.DEFAULT_SAMPLING_RATE,
    transform: str = "zfp",
    *,
    device=None,
) -> dict[str, np.ndarray]:
    """Both estimated rate-distortion curves of one field at an array of
    bounds, on `device` (default the GPU). `bounds[c]` is ZFP's error bound
    and SZ's bin size delta for candidate c. Returns arrays of
    len(bounds): ``br_sz``, ``psnr_sz``, ``br_zfp``, ``psnr_zfp`` and
    ``psnr_sz_measured`` (the sampled quantization-error PSNR the
    fixed_psnr refinement targets)."""
    dev = _device.resolve(device)
    view = _fold_ndim(_device.as_f32(x, dev))
    vr = float(view.max() - view.min()) if view.numel() else 0.0
    if _degenerate_selection(view, vr, None, None, r_sp) is not None:
        raise ValueError("degenerate field has no estimator curve")
    starts = est.block_starts(tuple(view.shape), r_sp)
    member = _Member(0, est.gather_blocks(view, starts, halo=True), vr, _numel(view))
    sweep = _Sweep([member], transform)
    b = np.asarray(bounds, np.float32).reshape(-1, 1)
    br_sz, psnr_sz, br_zfp, psnr_zfp, psnr_meas = sweep.full(b, b)
    return dict(
        br_sz=br_sz[:, 0], psnr_sz=psnr_sz[:, 0],
        br_zfp=br_zfp[:, 0], psnr_zfp=psnr_zfp[:, 0],
        psnr_sz_measured=psnr_meas[:, 0],
    )

"""Statistical ratio/PSNR prediction and stats fingerprints, in torch.

Port of `repro.core.predictor` (the black-box ratio prediction of Underwood
et al. 2023, arXiv 2305.08801, fitted to Algorithm 1):

* `stats_for_members` computes per-field moments (value range, sample
  min/max, the absolute, second and fourth moments of the Lorenzo
  residual, a value-variance spectral-slope proxy, and a host-side
  residual IQR) over exactly the packed halo-block batch `select_many`
  builds (the same power-of-two buckets and `estimator.field_sums`), on
  the members' device, and the content fingerprint of each member;
* `predict_curves` turns the moments into predicted bit-rate/PSNR curves
  for both codecs, `predict_selection` replays Algorithm 1 on them, and
  `confidence` says how far to trust them; `select_many_predicted` routes
  the fields below `CONFIDENCE_THRESHOLD` to the sampled estimator;
* `fingerprint_of` digests the sampled halo blocks and (vr, size, r_sp),
  the complete input of the batched Stage-I decision, into the key
  `core/decision_cache.py` validates on. The digest equals the
  reference's for the same blocks, so a cache written by either package
  hits in the other.

The host models are numpy, as in the reference. The moments, and the
order statistics of the residual IQR, run on the members' device; the
sampled blocks cross to the host once a batch, for the digests.
"""

from __future__ import annotations

import hashlib
import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _device
from . import codecs as _codecs
from . import estimator as est
from . import selector as _sel

#: predictions below this confidence route to the sampled estimator
CONFIDENCE_THRESHOLD = 0.5
#: fields with fewer sampled residuals than this never predict (the
#: moment estimates are too noisy to beat one cheap sampled batch)
MIN_CONFIDENT_SIZE = 4096
#: ZFP's measured truncation error sits well below the bound: PSNR lands
#: 23-34 dB above -20 log10(eb/vr); the center of that band, calibrated by
#: the reference against `estimate_zfp(mode='exact')`
ZFP_PSNR_OFFSET = 28.0
#: residual kurtosis above the Gaussian/Laplacian band (3..6) decays
#: confidence with this scale: heavy tails break the entropy model
KURTOSIS_SCALE = 10.0
#: fingerprint format tag (the reference's); any change to the digest's
#: preimage must change it
_FP_TAG = b"repro-dc1"


@dataclass
class FieldStats:
    """Cheap per-field sufficient statistics (moments normalized by vr)."""

    vr: float          # value range (max - min of the folded f32 view)
    size: int          # folded element count
    n_blocks: int      # sampled blocks backing the moments
    smin: float        # sampled min / max
    smax: float
    ra1: float         # mean |residual| / vr
    rv2: float         # mean residual^2 / vr^2
    rk4: float         # mean residual^4 / vr^4
    vv2: float         # value variance / vr^2 (rv2/vv2 is the
                       # high-frequency energy fraction)
    iqr: float         # residual interquartile range / vr (host-side)
    nd: int
    r_sp: float

    @property
    def kurtosis(self) -> float:
        return self.rk4 / max(self.rv2 * self.rv2, 1e-38)


# ---------------------------------------------------------------------------
# Packed moments, over the batch layout of selector._select_batch
# ---------------------------------------------------------------------------


def _moments(halo, seg, bounds, vr_f, n_fields: int):
    """Per-field moment sums (n_fields, 5), sampled min/max, and the
    residual blocks over a packed halo-block batch, on its device. The
    residual is the nd-fold backward difference of the halo block (the
    first-order Lorenzo stencil Stage I samples), normalized per field by
    vr so the float32 prefix sums stay comparable across co-batched
    fields."""
    nd = halo.ndim - 1
    n = halo.shape[0]
    nohalo = halo[(slice(None),) + (slice(1, None),) * nd]
    d = halo
    for ax in range(1, nd + 1):
        d = torch.diff(d, dim=ax)
    inv_vr = (1.0 / torch.clamp_min(vr_f, 1e-30))[seg.long()][:, None]
    dn = d.reshape(n, -1) * inv_vr
    vn = nohalo.reshape(n, -1) * inv_vr
    d2 = dn * dn
    cols = torch.stack(
        [dn.abs().sum(1), d2.sum(1), (d2 * d2).sum(1), vn.sum(1), (vn * vn).sum(1)], dim=1
    )
    sums = est.field_sums(cols, bounds)
    flat = nohalo.reshape(n, -1)
    idx = seg.long()
    fmin = torch.full((n_fields,), math.inf, dtype=torch.float32, device=halo.device)
    fmax = torch.full((n_fields,), -math.inf, dtype=torch.float32, device=halo.device)
    fmin = fmin.scatter_reduce(0, idx, flat.amin(1), "amin")
    fmax = fmax.scatter_reduce(0, idx, flat.amax(1), "amax")
    return sums, fmin, fmax, d


#: the residual IQR's percentiles, in numpy's order
_IQR_Q = (75.0, 25.0)


def _percentile_ranks(n: int):
    """numpy's linear-method percentile plan for `_IQR_Q` over n values:
    the ranks below and above each virtual index (intp) and the weight
    between them (float64), as `np.percentile` computes them (Hyndman &
    Fan's method 7)."""
    q = np.true_divide(np.asanyarray(_IQR_Q), 100)
    virtual = n * q + (1 + q * (1 - 1 - 1)) - 1
    prev = np.floor(virtual)
    nxt = prev + 1
    above = virtual >= n - 1
    prev[above] = nxt[above] = -1
    below = virtual < 0
    prev[below] = nxt[below] = 0
    return prev.astype(np.intp) % n, nxt.astype(np.intp) % n, virtual - prev


def _iqr(prev_vals: np.ndarray, next_vals: np.ndarray, gamma: np.ndarray) -> float:
    """q75 - q25 from the order statistics `np.percentile` reads, with its
    interpolation step for step (numpy's `_lerp`): the float32 neighbours,
    a float64 weight, and the upper form for weights from 1/2."""
    diff = next_vals - prev_vals
    out = np.asanyarray(np.add(prev_vals, diff * gamma))
    np.subtract(next_vals, diff * (1 - gamma), out=out, where=gamma >= 0.5)
    return float(out[0] - out[1])


def fingerprint_of(halo: np.ndarray, vr: float, size: int, r_sp: float) -> str:
    """Content digest over the complete input of the batched Stage-I
    decision for one field: its sampled halo blocks (a host float32 array)
    and the (vr, size, r_sp) scalars the estimators take. Equal digests
    mean equal decisions. blake2b-128 over the tag, the blocks' shape as
    int64, the scalars as float64 and the blocks' float32 bytes, as the
    reference digests them."""
    h = hashlib.blake2b(digest_size=16)
    h.update(_FP_TAG)
    h.update(np.asarray(halo.shape, np.int64).tobytes())
    h.update(np.asarray([vr, float(size), r_sp], np.float64).tobytes())
    h.update(np.ascontiguousarray(halo, dtype=np.float32))
    return h.hexdigest()


def stats_for_members(
    nd: int, members: list[_sel.Member], r_sp: float
) -> list[tuple[FieldStats, dict]]:
    """(FieldStats, fingerprint record) per member, in member order.

    `members` are `selector` members (result index, halo blocks on the
    device, eb, vr, size); they are cut into batches by the same block and
    field caps as `selector._run_select_batches`."""
    out: list[tuple[FieldStats, dict]] = []
    cap = _sel._max_batch_blocks(nd)
    lo = 0
    while lo < len(members):
        hi, blocks = lo, 0
        while hi < len(members) and (
            hi == lo
            or (blocks + len(members[hi][1]) <= cap and hi - lo < _sel.MAX_BATCH_FIELDS)
        ):
            blocks += len(members[hi][1])
            hi += 1
        out.extend(_stats_batch(nd, members[lo:hi], r_sp))
        lo = hi
    return out


def _stats_batch(nd: int, members: list[_sel.Member], r_sp: float):
    halo, seg, bounds, n_fields = _sel._pack_blocks([m[1] for m in members])
    vr_f = torch.tensor(
        [m[3] for m in members] + [1.0] * (n_fields - len(members)),
        dtype=torch.float32, device=halo.device,
    )
    sums, fmin, fmax, d = _moments(halo, seg, bounds, vr_f, n_fields)
    counts = [len(m[1]) for m in members]
    # the residual IQR, as the reference's np.percentile over each member's
    # residuals / vr: its four order statistics come from a sort on the
    # device (x / vr is monotone in x, so ranks carry over), the
    # interpolation runs on the host (a member has at least one block)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    plans = [_percentile_ranks(c * 4**nd) for c in counts]
    picked = _device.to_numpy(torch.stack([
        torch.sort(d[offsets[f] : offsets[f + 1]].reshape(-1)).values[
            torch.as_tensor(np.concatenate(plans[f][:2]), device=d.device)]
        for f in range(len(members))
    ]))
    # one device-to-host copy a batch: the digests read the sampled blocks
    host = halo[: offsets[-1]].cpu().numpy()
    sums, fmin, fmax = (_device.to_numpy(t) for t in (sums, fmin, fmax))
    with ThreadPoolExecutor(max_workers=min(8, len(members))) as pool:
        # blake2b releases the GIL on large buffers
        digests = list(pool.map(
            lambda f: fingerprint_of(
                host[offsets[f] : offsets[f + 1]], members[f][3], int(members[f][4]), r_sp
            ),
            range(len(members)),
        ))
    out = []
    for f, (_, _, _eb, vr, size) in enumerate(members):
        nres = float(counts[f] * 4**nd)
        ra1, rv2, rk4, sv1, sv2 = (float(s) / nres for s in sums[f])
        vv2 = max(sv2 - sv1 * sv1, 0.0)
        vals = picked[f] / max(vr, 1e-30)  # float32, as numpy divides
        iqr = _iqr(vals[:2], vals[2:], plans[f][2])
        stats = FieldStats(
            vr=vr, size=int(size), n_blocks=counts[f],
            smin=float(fmin[f]), smax=float(fmax[f]),
            ra1=ra1, rv2=rv2, rk4=rk4, vv2=vv2, iqr=iqr,
            nd=nd, r_sp=r_sp,
        )
        fp = dict(
            kind="blocks", digest=digests[f], vr=vr, size=int(size), n=counts[f],
            smin=stats.smin, smax=stats.smax, ra1=ra1, rv2=rv2, rk4=rk4,
        )
        out.append((stats, fp))
    return out


# ---------------------------------------------------------------------------
# Predicted rate/PSNR curves and Algorithm 1 on the model (host, numpy)
# ---------------------------------------------------------------------------


#: quadrature resolution of the SZ rate model's occupancy integrals
_QUAD_K = 512
#: per-value overhead of the exact ZFP coder over the pure bit-plane count,
#: calibrated by the reference against `estimate_zfp(mode='exact')`
ZFP_RATE_OVERHEAD = 5.4


def _sz_bitrate_model(stats: FieldStats, eb_sz: np.ndarray) -> np.ndarray:
    """Expected sampled-estimator SZ rate at half-bin `eb_sz` under a
    Gaussian residual model (std sqrt(rv2)*vr, bin size 2*eb_sz): the
    entropy of the quantized Gaussian (capped at log2 of the sample size)
    with the Miller-Madow term, the Chao1 Huffman-table cost from
    Poissonized bin occupancy integrated in residual-quantile space, and
    the 64-bit escapes beyond +-half bins; forced monotone non-increasing
    in eb_sz."""
    sigma = math.sqrt(max(stats.rv2, 1e-38)) * max(stats.vr, 1e-30)
    n_samp = float(max(stats.n_blocks, 1) * 4**stats.nd)
    size = float(max(stats.size, 1))
    half = (est.PDF_BINS - 1) // 2
    eb_arr = np.asarray(eb_sz, np.float64)
    delta = 2.0 * np.maximum(np.atleast_1d(eb_arr), 1e-300)
    q = delta / sigma                      # bin width in residual-sigma units
    t_max = np.minimum(8.0, half * q)      # integrate to 8 sigma or the clip
    grid = (np.arange(_QUAD_K, dtype=np.float64) + 0.5) / _QUAD_K
    t = grid[None, :] * t_max[:, None]     # (n_eb, K) midpoints
    dt = (t_max / _QUAD_K)[:, None]
    phi = np.exp(-0.5 * t * t) / math.sqrt(2.0 * math.pi)
    lam = n_samp * q[:, None] * phi        # expected sample count per bin
    nbins = 2.0 * dt / q[:, None]          # bins per quadrature cell (+-t)
    n_obs = np.sum(nbins * -np.expm1(-lam), axis=1)
    f1 = np.sum(nbins * lam * np.exp(-lam), axis=1)
    f2 = np.sum(nbins * 0.5 * lam * lam * np.exp(-lam), axis=1)
    chao1 = n_obs + f1 * np.maximum(f1 - 1.0, 0.0) / (2.0 * (f2 + 1.0))
    table = est.TABLE_BITS_PER_SYMBOL * np.minimum(chao1, est.PDF_BINS) / size
    with np.errstate(divide="ignore"):
        ent = np.sum(
            2.0 * dt * phi * -np.log2(np.maximum(q[:, None] * phi, 1e-300)),
            axis=1,
        )
    ent = np.minimum(np.maximum(ent, 0.0), math.log2(max(n_samp, 2.0)))
    ent = ent + (n_obs - 1.0) / (2.0 * n_samp * est.LN2)   # Miller-Madow
    ofrac = np.array(
        [math.erfc(min(v, 30.0) / math.sqrt(2.0)) for v in half * q]
    )
    rate = ent + est.SZ_BITRATE_OFFSET + 64.0 * ofrac + table
    order = np.argsort(delta)
    mono = np.minimum.accumulate(rate[order])
    rate = np.empty_like(rate)
    rate[order] = mono
    return rate.reshape(eb_arr.shape) if eb_arr.shape else rate[0]


def _zfp_bitrate_model(stats: FieldStats, eb: np.ndarray) -> np.ndarray:
    """ZFP rate at bound `eb` from a significant-bit-plane count: the AC
    coefficients at the residual scale, one DC at the value scale, the
    per-block overhead, and the calibrated `ZFP_RATE_OVERHEAD`; capped at
    the 32 bits/value raw fallback. Monotone non-increasing in eb."""
    bsz = 4**stats.nd
    sigma = math.sqrt(max(stats.rv2, 1e-38)) * max(stats.vr, 1e-30)
    eb = np.maximum(np.asarray(eb, np.float64), 1e-300)
    ac = np.maximum(np.log2(2.0 * sigma / eb), 0.0)
    dc = np.maximum(np.log2(0.5 * max(stats.vr, 1e-30) / eb), 0.0)
    rate = ((bsz - 1) * ac + dc) / bsz + 8.0 / bsz + 0.25
    return np.minimum(rate + ZFP_RATE_OVERHEAD, 32.0)


def _zfp_psnr_model(stats: FieldStats, eb: np.ndarray) -> np.ndarray:
    eb_rel = np.maximum(np.asarray(eb, np.float64), 1e-300) / max(stats.vr, 1e-30)
    return -20.0 * np.log10(eb_rel) + ZFP_PSNR_OFFSET


def predict_curves(stats: FieldStats, ebs) -> dict:
    """Predicted (bit-rate, PSNR) curves of both codecs at absolute bounds
    `ebs`, from the moments alone. SZ's PSNR is Eq. (11); rates are
    models."""
    ebs = np.asarray(ebs, np.float64)
    return dict(
        eb=ebs,
        br_sz=_sz_bitrate_model(stats, ebs),
        br_zfp=_zfp_bitrate_model(stats, ebs),
        psnr_sz=np.asarray(
            -20.0 * np.log10(np.maximum(ebs / max(stats.vr, 1e-30), 1e-300))
            + 10.0 * math.log10(3.0)
        ),
        psnr_zfp=_zfp_psnr_model(stats, ebs),
    )


def confidence(stats: FieldStats) -> float:
    """How much to trust the moment model for this field, in [0, 1]: zero
    for a degenerate value range or residual variance (constant fields) and
    non-finite moments; otherwise the product of a sample-size factor, a
    kurtosis factor (heavy tails) and a shape factor (the |.|-to-std ratio
    against the Gaussian sqrt(2/pi))."""
    if not (stats.vr > 0.0 and math.isfinite(stats.vr)):
        return 0.0
    if not (stats.rv2 > 0.0 and math.isfinite(stats.rv2)):
        return 0.0
    if not math.isfinite(stats.rk4):
        return 0.0
    c_size = min(1.0, stats.size / float(MIN_CONFIDENT_SIZE))
    c_tail = 1.0 / (1.0 + max(0.0, stats.kurtosis - 6.0) / KURTOSIS_SCALE)
    shape = stats.ra1 / (math.sqrt(stats.rv2) * math.sqrt(2.0 / math.pi))
    c_shape = 1.0 / (1.0 + 2.0 * abs(math.log(max(shape, 1e-12))))
    return c_size * c_tail * c_shape


def predict_selection(
    stats: FieldStats,
    eb_abs: float,
    codecs: tuple[str, ...] = _codecs.DEFAULT_CODECS,
) -> _sel.Selection:
    """Algorithm 1 on the predicted curves: ZFP's PSNR at the bound, the
    iso-PSNR SZ half-bin (the sampled path's snap and clip), then the
    smaller predicted rate."""
    eb = float(eb_abs)
    psnr_z = float(_zfp_psnr_model(stats, eb))
    psnr_q = round(psnr_z / est.PSNR_MATCH_QUANTUM) * est.PSNR_MATCH_QUANTUM
    delta = max(stats.vr, 1e-30) * math.sqrt(12.0) * 10.0 ** (-psnr_q / 20.0)
    eb_sz = min(max(delta / 2.0, eb * 1e-6), eb)
    br_sz = float(_sz_bitrate_model(stats, eb_sz))
    br_zfp = float(_zfp_bitrate_model(stats, eb))
    codec = _sel._pick_codec(br_sz, br_zfp, codecs)
    return _sel.Selection(codec, eb, eb_sz, br_sz, br_zfp, psnr_z, stats.vr, stats.r_sp)


def select_many_predicted(
    fields,
    eb_abs: float | None = None,
    eb_rel: float | None = None,
    r_sp: float | None = None,
    transform: str = "zfp",
    codecs: tuple[str, ...] | None = None,
    *,
    policy=None,
    confidence_threshold: float = CONFIDENCE_THRESHOLD,
    device=None,
) -> tuple[list[_sel.Selection], list[str]]:
    """`select_many` with the predictor in front, on `device` (default the
    GPU): confident fields take the moment-model decision, the rest the
    sampled estimator, degenerate fields the raw fallback. Returns
    (selections, routes), routes[i] in {'predicted', 'sampled',
    'degenerate'}. Opt-in: predicted decisions follow the model, so this
    is not the path behind `select_many` or `compress_pytree`."""
    if policy is not None:
        if policy.mode != "fixed_accuracy":
            raise ValueError(
                f"select_many_predicted takes a fixed_accuracy policy, got {policy.mode!r}"
            )
        if any(v is not None for v in (eb_abs, eb_rel, r_sp, codecs)):
            raise ValueError("pass either policy= or eb_abs/eb_rel/r_sp/codecs, not both")
        eb_abs, eb_rel = policy.eb_abs, policy.eb_rel
        r_sp, codecs = policy.r_sp, policy.codecs
    r_sp = est.DEFAULT_SAMPLING_RATE if r_sp is None else r_sp
    codecs = _codecs.DEFAULT_CODECS if codecs is None else codecs
    dev = _device.resolve(device)
    fields = list(fields)
    results: list[_sel.Selection | None] = [None] * len(fields)
    groups = _sel._build_select_members(
        fields, range(len(fields)), results, eb_abs, eb_rel, r_sp, transform, codecs, dev
    )
    routes = ["degenerate" if r is not None else "" for r in results]
    fallback: dict[int, list] = {}
    for nd, members in groups.items():
        for m, (s, _fp) in zip(members, stats_for_members(nd, members, r_sp)):
            i = m[0]
            if confidence(s) >= confidence_threshold:
                results[i] = predict_selection(s, m[2], codecs)
                routes[i] = "predicted"
            else:
                fallback.setdefault(nd, []).append(m)
                routes[i] = "sampled"
    if fallback:
        _sel._run_select_batches(fallback, results, r_sp, transform, codecs)
    return results, routes  # type: ignore[return-value]


__all__ = [
    "CONFIDENCE_THRESHOLD",
    "FieldStats",
    "confidence",
    "fingerprint_of",
    "predict_curves",
    "predict_selection",
    "select_many_predicted",
    "stats_for_members",
]

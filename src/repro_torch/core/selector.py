"""Algorithm 1 — automatic online selection between SZ and ZFP (paper §5.3),
for one field and batched over many, in torch.

Port of `repro.core.selector`. Per field:

  1. sample blocks (rate r_sp);
  2. estimate ZFP's (BR, PSNR) at the user's error bound;
  3. invert Eq. (10) for the SZ bin size delta matching ZFP's PSNR;
  4. estimate SZ's BR at that delta;
  5. pick the codec with the smaller estimated bit-rate.

As in the reference, Algorithm 1 line 11's "error bound 2*delta" is read
as eb_sz = delta/2, clamped to eb_abs so the user's bound always holds.
`select_many` runs Steps 1-3 for many fields at once over packed batches
of their sampled blocks. Step 4 of Fig. 2 (`encode_with_selection`) runs
the chosen codec through the registry; with ``device_encode=True`` the
codec finishes Stage III on the device. With a `DecisionCache`,
`select_many` takes the warm path: fields whose sampled blocks
fingerprint as before replay the previous decision (`core/predictor.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _device
from . import codecs as _codecs
from . import estimator as est
from . import policy as _policy

#: a codec *name*; byte encode/decode dispatches through the registry
Codec = str


def _pick_codec(br_sz: float, br_zfp: float, allowed: tuple[str, ...]) -> Codec:
    """Step 5 under a codec allowlist: min estimated rate among the allowed
    lossy candidates (ties go to ZFP), `raw` when the best still reaches 32
    bits/value or nothing lossy is allowed."""
    sz_ok, zfp_ok = "sz" in allowed, "zfp" in allowed
    if sz_ok and zfp_ok:
        codec, best = ("sz", br_sz) if br_sz < br_zfp else ("zfp", br_zfp)
    elif sz_ok:
        codec, best = "sz", br_sz
    elif zfp_ok:
        codec, best = "zfp", br_zfp
    else:
        return "raw"
    return "raw" if best >= 32.0 else codec


@dataclass
class Selection:
    codec: Codec
    eb_abs: float            # user bound (guaranteed pointwise)
    eb_sz: float             # SZ bound after the iso-PSNR match
    br_sz: float
    br_zfp: float
    psnr_target: float       # ZFP's estimated PSNR (the match point)
    vr: float
    r_sp: float


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


def _fold_ndim(x):
    """Fields are 1-3D: fold leading axes of higher-rank arrays, and merge
    leading axes shorter than the 4-wide block. Works on numpy arrays and
    tensors alike, so the decision and the encoded view always agree."""
    if x.ndim > 3:
        x = x.reshape((-1,) + tuple(x.shape[-2:]))
    while x.ndim > 1 and x.shape[0] < 4 and _numel(x):
        x = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
    return x


def _degenerate_selection(x, vr: float, eb_abs, eb_rel, r_sp: float) -> Selection | None:
    """The raw fallback: too-small fields, constant fields, and
    NaN/inf-poisoned fields (vr non-finite) store verbatim."""
    size = _numel(x)
    if x.ndim == 0 or (size and min(x.shape) < 4) or size < 64:
        eb = eb_abs if eb_abs is not None else (eb_rel or 1e-3) * max(vr, 1e-30)
        return Selection("raw", float(eb), float(eb), 32.0, 32.0, 0.0, vr, r_sp)
    if vr <= 0 or not np.isfinite(vr):
        eb = eb_abs if eb_abs is not None else 1e-30
        return Selection("raw", float(eb), float(eb), 32.0, 32.0, 0.0, vr, r_sp)
    return None


def _estimates(x: torch.Tensor, starts: np.ndarray, eb_abs: torch.Tensor,
               vr: torch.Tensor, transform: str):
    """Steps 1-3 of Fig. 2 on one field (the reference's jitted program,
    run eagerly): (br_sz, br_zfp, psnr_zfp, eb_sz) as float32 tensors."""
    e_zfp = est.estimate_zfp(x, eb_abs, starts, vr, transform)
    delta = est.sz_delta_for_psnr(e_zfp.psnr, vr)
    # clamp: near-lossless ZFP PSNR estimates would drive the SZ bin size
    # to 0; the floor keeps Algorithm 1 sane
    eb_sz = torch.minimum(torch.maximum(delta / 2.0, eb_abs * 1e-6), eb_abs)
    e_sz = est.estimate_sz(x, 2.0 * eb_sz, starts, vr)
    return e_sz.bitrate, e_zfp.bitrate, e_zfp.psnr, eb_sz


def select(
    x,
    eb_abs: float | None = None,
    eb_rel: float | None = None,
    r_sp: float = est.DEFAULT_SAMPLING_RATE,
    transform: str = "zfp",
    codecs: tuple[str, ...] = _codecs.DEFAULT_CODECS,
    *,
    device=None,
) -> Selection:
    """Run Steps 1-3 of Fig. 2 on `device` and return the decision and its
    estimates. `x` is a numpy array or a tensor, evaluated in float32."""
    dev = _device.resolve(device)
    x = _fold_ndim(_device.as_f32(x, dev))
    vr = float(x.max() - x.min()) if x.numel() else 0.0
    sel0 = _degenerate_selection(x, vr, eb_abs, eb_rel, r_sp)
    if sel0 is not None:
        return sel0
    if eb_abs is None:
        if eb_rel is None:
            raise ValueError("select needs eb_abs or eb_rel")
        eb_abs = eb_rel * vr
    starts = est.block_starts(tuple(x.shape), r_sp)
    f32 = dict(dtype=torch.float32, device=dev)
    out = _estimates(
        x, starts, torch.tensor(eb_abs, **f32), torch.tensor(vr, **f32), transform
    )
    br_sz, br_zfp, psnr_zfp, eb_sz = (float(v) for v in torch.stack(out).cpu())
    codec = _pick_codec(br_sz, br_zfp, codecs)
    return Selection(codec, float(eb_abs), eb_sz, br_sz, br_zfp, psnr_zfp, vr, r_sp)


# ---------------------------------------------------------------------------
# Batched multi-field selection (the engine behind compress_pytree)
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


#: per-batch field cap. Two constraints, the second binding: the batched SZ
#: estimator's int32 sort key seg * (n_pdf + 1) + bin must stay below 2^31
#: after power-of-two field padding, and the per-run |p log2 p| terms ride
#: a float32 prefix sum whose running total grows ~17 bits a field, so the
#: cap keeps the late fields' window error around 1e-3 bits/value.
MAX_BATCH_FIELDS = 1024


def _max_batch_blocks(nd: int) -> int:
    """Per-batch block cap: bounds batch memory and keeps the int32 coder-bit
    prefix sums of `estimator.field_sums` exact (a block's worst case is
    under 4^nd * 128 bits, so cap * 4^nd * 128 < 2^31). A single field
    bigger than the cap takes the per-field `select`."""
    return min(1 << 20, (1 << 31) // (4**nd * 128))


#: a batchable field: (result index, halo blocks on the device, eb, vr, size)
Member = tuple[int, torch.Tensor, float, float, int]


def select_many(
    fields,
    eb_abs: float | None = None,
    eb_rel: float | None = None,
    r_sp: float | None = None,
    transform: str = "zfp",
    codecs: tuple[str, ...] | None = None,
    *,
    policy=None,
    cache=None,
    names=None,
    device=None,
) -> list[Selection]:
    """Algorithm 1 on many fields, batched: one estimator pass per
    dimensionality and batch instead of one per field.

    Each field is cast to float32 and moved to `device` (default the GPU)
    one at a time, and only its sampled halo blocks (r_sp of its values)
    are kept, so peak memory is one field plus ~r_sp of all of them. The
    samples are packed into padded (blocks, 5, ..) batches per
    dimensionality (at most `MAX_BATCH_FIELDS` fields and
    `_max_batch_blocks(nd)` blocks each), and Steps 1-3 run with per-field
    segment reductions. Returns one `Selection` per field; a decision equals
    the per-field `select`'s up to the float32 reduction order, and the
    reference's `select_many` for the same batch composition.

    `policy` (a fixed_accuracy `Policy`) is the object form of the
    eb/r_sp/codecs arguments.

    `cache` (a `DecisionCache`) with `names` (one stable name per field)
    takes the warm path: each batchable field's sampled blocks are
    fingerprinted (`core/predictor.py`), validated entries replay the
    previous decision (what the cold path would recompute, since the
    fingerprint digests the decision's whole input), and only the misses
    run the estimator. Degenerate fields never consult the cache.
    """
    if policy is not None:
        if policy.mode != "fixed_accuracy":
            raise ValueError(
                f"select_many takes a fixed_accuracy policy, got {policy.mode!r} "
                "(solve the target modes with repro_torch.core.solve_many: "
                "fixed_psnr, fixed_ratio, fixed_ssim, fixed_correlation, fixed_ks)"
            )
        if any(v is not None for v in (eb_abs, eb_rel, r_sp, codecs)):
            raise ValueError("pass either policy= or eb_abs/eb_rel/r_sp/codecs, not both")
        eb_abs, eb_rel = policy.eb_abs, policy.eb_rel
        r_sp, codecs = policy.r_sp, policy.codecs
    r_sp = est.DEFAULT_SAMPLING_RATE if r_sp is None else r_sp
    codecs = _codecs.DEFAULT_CODECS if codecs is None else codecs
    dev = _device.resolve(device)
    fields = list(fields)
    results: list[Selection | None] = [None] * len(fields)
    groups = _build_select_members(
        fields, range(len(fields)), results, eb_abs, eb_rel, r_sp, transform, codecs, dev
    )
    if cache is None:
        _run_select_batches(groups, results, r_sp, transform, codecs)
        return results  # type: ignore[return-value]
    if policy is None:
        policy = _policy.Policy.fixed_accuracy(
            eb_rel=eb_rel, eb_abs=eb_abs, r_sp=r_sp, codecs=codecs
        )
    _select_many_cached(fields, names, results, groups, cache, policy, r_sp, transform, codecs)
    return results  # type: ignore[return-value]


def cache_key(x) -> tuple[tuple[int, ...], str]:
    """A field's (shape, dtype name) as the decision cache keys it: the
    numpy dtype name ("float32", "bfloat16"), as the reference records it,
    for arrays and tensors alike."""
    return tuple(int(s) for s in np.shape(x)), _device.dtype_name(x)


def check_names(names, fields) -> list:
    """The warm path's field names, one per field."""
    if names is None:
        raise ValueError("a cache needs names= (one stable name per field)")
    names = list(names)
    if len(names) != len(fields):
        raise ValueError(f"names/fields length mismatch: {len(names)} vs {len(fields)}")
    return names


def _select_many_cached(
    fields,
    names,
    results: list[Selection | None],
    groups: dict[int, list[Member]],
    cache,
    policy,
    r_sp: float,
    transform: str,
    codecs: tuple[str, ...],
) -> None:
    """Warm half of `select_many`: fingerprint each batchable member, replay
    the validated entries, batch only the misses through the estimator, and
    store their fresh decisions.

    The misses are batched with each other, not with the hits, so a miss's
    decision equals a cold `select_many` over the miss subset (the float32
    prefix-sum windows depend on the batch at the ulp level); hits replay
    the stored decision as it was batched then."""
    from . import predictor as _pred

    names = check_names(names, fields)
    miss_groups: dict[int, list[Member]] = {}
    to_store: list[tuple[int, str, tuple, str, dict]] = []
    for nd, members in groups.items():
        for m, (_stats, fp) in zip(members, _pred.stats_for_members(nd, members, r_sp)):
            i = m[0]
            shape, dtype = cache_key(fields[i])
            entry = cache.lookup(names[i], shape, dtype, policy, transform, fp)
            if entry is not None:
                results[i] = entry.to_selection()
            else:
                miss_groups.setdefault(nd, []).append(m)
                to_store.append((i, names[i], shape, dtype, fp))
    if miss_groups:
        _run_select_batches(miss_groups, results, r_sp, transform, codecs)
    for i, name, shape, dtype, fp in to_store:
        cache.store(name, shape, dtype, policy, transform, fp, results[i])


def _build_select_members(
    fields,
    indices,
    results: list[Selection | None],
    eb_abs: float | None,
    eb_rel: float | None,
    r_sp: float,
    transform: str,
    codecs: tuple[str, ...],
    device: torch.device,
) -> dict[int, list[Member]]:
    """Gather side of `select_many`: fold, value range, the degenerate raw
    fallback, and the per-field `select` for a field bigger than one batch
    (written straight into `results`); returns the batchable members by
    rank, each holding only its sampled halo blocks on `device` (the
    no-halo blocks are the halo blocks minus the leading row per axis)."""
    groups: dict[int, list[Member]] = {}
    for i, x in zip(indices, fields):
        view = _fold_ndim(_device.as_f32(x, device))
        vr = float(view.max() - view.min()) if view.numel() else 0.0
        sel0 = _degenerate_selection(view, vr, eb_abs, eb_rel, r_sp)
        if sel0 is not None:
            results[i] = sel0
            continue
        if eb_abs is None:
            if eb_rel is None:
                raise ValueError("select_many needs eb_abs or eb_rel")
            eb = eb_rel * vr
        else:
            eb = eb_abs
        starts = est.block_starts(tuple(view.shape), r_sp)
        if len(starts) > _max_batch_blocks(view.ndim):
            # bigger alone than a whole batch: the per-field path has no
            # int32 accumulation to protect
            results[i] = select(
                view, eb_abs=float(eb), r_sp=r_sp, transform=transform,
                codecs=codecs, device=device,
            )
            continue
        groups.setdefault(view.ndim, []).append(
            (i, est.gather_blocks(view, starts, halo=True), float(eb), vr, _numel(view))
        )
        del view
    return groups


def _run_select_batches(
    groups: dict[int, list[Member]],
    results: list[Selection | None],
    r_sp: float,
    transform: str,
    codecs: tuple[str, ...],
) -> None:
    """Cut each rank's members into batches in order, within the block cap
    and the field cap (a batch always takes at least one member)."""
    for nd, members in groups.items():
        cap = _max_batch_blocks(nd)
        lo = 0
        while lo < len(members):
            hi, blocks = lo, 0
            while hi < len(members) and (
                hi == lo
                or (blocks + len(members[hi][1]) <= cap and hi - lo < MAX_BATCH_FIELDS)
            ):
                blocks += len(members[hi][1])
                hi += 1
            _select_batch(nd, members[lo:hi], results, r_sp, transform, codecs)
            lo = hi


def _batched_estimates(halo, seg, bounds, eb_f, vr_f, size_f, transform: str):
    """Steps 1-3 of Fig. 2 over a packed multi-field batch (the reference's
    jitted program, run eagerly): per-field (br_sz, br_zfp, psnr, eb_sz)."""
    nd = halo.ndim - 1
    # one gather serves both estimators: the no-halo blocks are the halo
    # blocks without their leading row on each axis
    nohalo = halo[(slice(None),) + (slice(1, None),) * nd]
    e_zfp = est.estimate_zfp_many(nohalo, seg, bounds, eb_f, vr_f, transform)
    delta = est.sz_delta_for_psnr(e_zfp.psnr, vr_f)
    eb_sz = torch.minimum(torch.maximum(delta / 2.0, eb_f * 1e-6), eb_f)
    e_sz = est.estimate_sz_many(halo, seg, bounds, 2.0 * eb_sz, vr_f, size_f)
    return e_sz.bitrate, e_zfp.bitrate, e_zfp.psnr, eb_sz


def _pack_blocks(blocks: list[torch.Tensor]):
    """Pack fields' halo blocks into one batch as the reference pads it, in
    power-of-two buckets: blocks padded with zeros, fields to a power of two
    above their count, the padding blocks in the last (dummy) field slot.
    Blocks of field f live at [bounds[f], bounds[f+1]); empty padded slots
    collapse. Returns (halo, seg, bounds, n_fields) on the blocks' device."""
    dev = blocks[0].device
    counts = [len(b) for b in blocks]
    n_real_blocks, n_real_fields = sum(counts), len(blocks)
    n_blocks = _next_pow2(n_real_blocks)
    n_fields = _next_pow2(n_real_fields + 1)
    pad = n_blocks - n_real_blocks
    halo = torch.cat(
        blocks + [torch.zeros((pad,) + tuple(blocks[0].shape[1:]), dtype=torch.float32, device=dev)]
    )
    seg = torch.repeat_interleave(
        torch.arange(n_real_fields + 1, dtype=torch.int32), torch.tensor(counts + [pad])
    )
    seg[n_real_blocks:] = n_fields - 1
    bounds = np.zeros(n_fields + 1, np.int32)
    bounds[1 : n_real_fields + 1] = np.cumsum(counts)
    bounds[n_real_fields + 1 :] = n_real_blocks
    bounds[n_fields] = n_blocks
    return halo, seg.to(dev), torch.from_numpy(bounds).to(dev), n_fields


def _select_batch(
    nd: int,
    members: list[Member],
    results: list[Selection | None],
    r_sp: float,
    transform: str,
    codecs: tuple[str, ...],
) -> None:
    halo, seg, bounds, n_fields = _pack_blocks([m[1] for m in members])

    def padf(v, fill):
        return torch.tensor(v + [fill] * (n_fields - len(members)), dtype=torch.float32,
                            device=halo.device)

    out = _batched_estimates(
        halo, seg, bounds,
        padf([m[2] for m in members], 1.0), padf([m[3] for m in members], 1.0),
        padf([float(m[4]) for m in members], 1.0), transform,
    )
    br_sz, br_zfp, psnr, eb_sz = torch.stack(out).cpu().numpy()
    for f, (i, _, eb, vr, _) in enumerate(members):
        bs, bz = float(br_sz[f]), float(br_zfp[f])
        results[i] = Selection(
            _pick_codec(bs, bz, codecs), float(eb), float(eb_sz[f]), bs, bz,
            float(psnr[f]), vr, r_sp,
        )


# ---------------------------------------------------------------------------
# Step 4 — construct the selected compressor and run it
# ---------------------------------------------------------------------------


@dataclass
class CompressedField:
    codec: Codec             # the selection bit s_i
    data: bytes
    shape: tuple[int, ...]
    dtype: str
    selection: Selection | None = None

    @property
    def nbytes(self) -> int:
        return len(self.data)


def _encode_view(
    view: torch.Tensor,
    sel: Selection,
    shape: tuple[int, ...],
    dtype: str,
    device_encode: bool,
) -> CompressedField:
    """Step 4 on a folded float32 view that already lies on its device."""
    if view.ndim == 0:
        view = view.reshape(1)
    codec = _codecs.get(sel.codec)
    data = None
    if device_encode and getattr(codec, "device_encode", False):
        data = codec.encode_device(view, sel)
    if data is None:
        data = codec.encode(_device.to_numpy(view), sel)
    # safety net: never ship a stream larger than raw
    if len(data) >= 4 * view.numel() and sel.codec != "raw":
        sel = Selection("raw", sel.eb_abs, sel.eb_sz, 32.0, 32.0, sel.psnr_target,
                        sel.vr, sel.r_sp)
        data = _device.to_numpy(view).tobytes()
    return CompressedField(sel.codec, data, shape, dtype, sel)


def encode_with_selection(
    x, sel: Selection, *, device_encode: bool = False, device=None
) -> CompressedField:
    """Step 4: run the already-selected compressor on `x`.

    `device_encode=True` tries the codec's device Stage III first
    (capability `device_encode`): the packed stream comes back from the
    device in one transfer and decodes through the same registry decoder.
    A device encoder returns None under the reference's fallback rules
    (each counted in `device_encode.DECLINES`), and the host coder runs.
    """
    dev = _device.resolve(device)
    shape, dtype = tuple(x.shape), _device.dtype_name(x)
    # the host coders read a host view: move the field only to device-encode
    where = dev if device_encode else torch.device("cpu")
    view = _fold_ndim(_device.as_f32(x, where))
    return _encode_view(view, sel, shape, dtype, device_encode)


def select_and_compress(
    x,
    eb_abs: float | None = None,
    eb_rel: float | None = None,
    r_sp: float = est.DEFAULT_SAMPLING_RATE,
    *,
    device=None,
) -> CompressedField:
    """Algorithm 1 and Step 4 on one field, on `device` (default the GPU)."""
    sel = select(x, eb_abs=eb_abs, eb_rel=eb_rel, r_sp=r_sp, device=device)
    return encode_with_selection(x, sel, device=device)


def decompress(cf: CompressedField, *, device=None) -> torch.Tensor:
    """Invert any `CompressedField` to a tensor on `device`, in the recorded
    dtype. Streams decode on the host; selection-less raw fields hold the
    exact original-dtype bytes and restore bit for bit."""
    dev = _device.resolve(device)
    if cf.codec == "raw" and cf.selection is None:
        return _device.from_raw_bytes(cf.data, cf.dtype, cf.shape).to(dev)
    arr = _codecs.get(cf.codec).decode(cf.data).reshape(cf.shape).astype(cf.dtype)
    return torch.from_numpy(arr).to(dev)


def compression_ratio(cf: CompressedField) -> float:
    n = int(np.prod(cf.shape)) if cf.shape else 1
    return (n * 4) / max(len(cf.data), 1)

"""Algorithm 1 — automatic online selection between SZ and ZFP (paper §5.3),
for one field, in torch.

Port of the single-field part of `repro.core.selector`. Per field:

  1. sample blocks (rate r_sp);
  2. estimate ZFP's (BR, PSNR) at the user's error bound;
  3. invert Eq. (10) for the SZ bin size delta matching ZFP's PSNR;
  4. estimate SZ's BR at that delta;
  5. pick the codec with the smaller estimated bit-rate.

As in the reference, Algorithm 1 line 11's "error bound 2*delta" is read
as eb_sz = delta/2, clamped to eb_abs so the user's bound always holds.
Step 4 of Fig. 2 (`encode_with_selection`) runs the chosen codec through
the registry; with ``device_encode=True`` the codec finishes Stage III on
the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _device
from . import codecs as _codecs
from . import estimator as est

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


def decompress(cf: CompressedField, *, device=None) -> torch.Tensor:
    """Invert any `CompressedField` to a tensor on `device`, in the recorded
    dtype. Streams decode on the host; selection-less raw fields hold the
    exact original-dtype bytes and restore bit for bit."""
    dev = _device.resolve(device)
    if cf.codec == "raw" and cf.selection is None:
        arr = _codecs.writeable_frombuffer(cf.data, cf.dtype).reshape(cf.shape)
    else:
        arr = _codecs.get(cf.codec).decode(cf.data).reshape(cf.shape).astype(cf.dtype)
    return torch.from_numpy(arr).to(dev)


def compression_ratio(cf: CompressedField) -> float:
    n = int(np.prod(cf.shape)) if cf.shape else 1
    return (n * 4) / max(len(cf.data), 1)

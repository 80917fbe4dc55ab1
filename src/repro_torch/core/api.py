"""Public compression API for one field.

Port of `repro.core.api.compress`: one field compressed under a quality
`Policy` (`core/policy.py`), on the GPU unless ``device="cpu"``.

* ``Policy.fixed_accuracy(eb_rel=...)`` / ``(eb_abs=...)`` — the paper's
  bound-centric contract: Algorithm 1 picks the cheaper codec at that
  pointwise bound.
* ``Policy.raw()`` — store verbatim (exact bytes, original dtype).
* The target modes (fixed_psnr, fixed_ratio, fixed_ssim,
  fixed_correlation, fixed_ks) need the quality-target controller, which
  the port does not carry yet; `compress` raises `NotImplementedError`.
"""

from __future__ import annotations

from .. import device as _device
from .policy import Policy
from .selector import (
    CompressedField,
    _encode_view,
    _fold_ndim,
    compression_ratio,
    decompress,
    encode_with_selection,
    select,
)


def compress(
    x,
    policy: Policy | None = None,
    *,
    device_encode: bool = False,
    device=None,
) -> CompressedField:
    """Compress one field under a quality policy; returns a `CompressedField`.

    Args:
      x: the field, a numpy array or a tensor of any shape, evaluated in
        float32 (the original dtype is recorded and restored by
        `decompress`). Ranks above 3 are folded to 3-D.
      policy: the quality contract; default `Policy.fixed_accuracy()`
        (eb_rel 1e-4). Fixed-accuracy bounds hold pointwise on every value
        of the reconstruction.
      device_encode: finish Stage III on the device where the selected
        codec supports it; the decision is unchanged, and a field the
        device encoder declines takes the host coder.
      device: where selection and the device encode run; default the GPU.

    Raw fallback: fields that are too small (< 64 values or a dim < 4),
    constant, or NaN/inf-poisoned store verbatim with codec ``raw``; so
    does any field whose estimated rate reaches 32 bits/value, and any
    stream that fails to beat raw.
    """
    dev = _device.resolve(device)
    pol = Policy.fixed_accuracy() if policy is None else policy
    if not isinstance(pol, Policy):
        raise TypeError(f"compress: expected a Policy, got {type(pol).__name__}")
    shape, dtype = tuple(x.shape), _device.dtype_name(x)
    if pol.mode == "raw":
        return CompressedField("raw", _device.to_numpy(x).tobytes(), shape, dtype)
    if pol.mode != "fixed_accuracy":
        raise NotImplementedError(
            f"compress under {pol.mode!r} needs the quality-target controller "
            "(core/controller.py), not yet ported: ROADMAP.md queue A, item 7"
        )
    view = _fold_ndim(_device.as_f32(x, dev))
    sel = select(
        view, eb_abs=pol.eb_abs, eb_rel=pol.eb_rel, r_sp=pol.r_sp,
        codecs=pol.codecs, device=dev,
    )
    return _encode_view(view, sel, shape, dtype, device_encode)


__all__ = [
    "CompressedField",
    "Policy",
    "compress",
    "compression_ratio",
    "decompress",
    "encode_with_selection",
]

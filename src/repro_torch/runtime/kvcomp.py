"""KV-cache / activation compression helpers (DESIGN.md §9), in torch.

Port of `repro.runtime.kvcomp`:

* `quantize_kv` / `dequantize_kv` — per-(token, head) linear quantization
  to int8.
* `bot_compress_kv` — the ZFP-style fused BOT + truncate surrogate (the
  CUDA kernels K5/K6, `kernels/bot4.py`) for KV pages: returns the
  reconstruction and the exact bits per block. The page's quality contract
  is a `Policy`: `Policy.fixed_accuracy(...)` for a bound, or
  `Policy.fixed_ratio(x)` for a byte budget — an octave grid of candidate
  bounds is scored by the sampled ZFP estimator in `model` mode, all
  candidates in one batched call, and the tightest bound whose estimated
  rate meets the budget is used; one kernel pass then runs at that bound.
  The legacy `eb_rel=` / `target_ratio=` kwargs shim onto the equivalent
  Policy with a `DeprecationWarning`.
* `compress_page` / `decompress_page` — the page-granular evict/restore
  entry points of the serving tier: a `CompressedPage` carries exact bytes
  under `Policy.raw()` (round trips are bit-identical), real ZFJX bytes
  when the device encoder packs the page (`device_encode=True`), or the
  BOT reconstruction plus exact bit accounting. Fixed-ratio bounds are
  bookkept through a `DecisionCache`: a re-evicted frozen page's content
  digest matches and its solved bound replays without re-scoring the grid.

Pages are tensors of the arena dtype (float32, or bfloat16 as a serving
arena holds them); the work runs on `device` (default the GPU, see
`repro_torch.device`) and evicted payloads live on the host.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings

import numpy as np
import torch

from .. import device as _device
from ..core import device_encode as _de
from ..core import estimator as est
from ..core.policy import Policy
from ..core.selector import Selection
from ..core.zfp import zfp_decompress
from ..kernels import ops

#: candidate bounds for the ratio-budget path: VR * 2^-j. The octave
#: spacing matches the ZFP bit-plane staircase (rate moves ~1 bit/value per
#: octave), so a finer grid would not land meaningfully closer; 2^-20 ..
#: 2^-1 spans lossless-ish to 1-plane quality.
_RATIO_GRID_OCTAVES = range(20, 0, -1)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., Dh) -> (int8 codes, f32 scales broadcastable on the last dim)."""
    amax = torch.amax(x.abs(), dim=-1, keepdim=True).to(torch.float32)
    scale = amax / 127.0 + 1e-12
    q = _device.to_int_saturating(torch.round(x.to(torch.float32) / scale), torch.int8)
    return q, scale


def dequantize_kv(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _budget_eb(page: torch.Tensor, vr: torch.Tensor, target_ratio: float) -> torch.Tensor:
    """Smallest candidate bound whose estimated ZFP rate meets the byte
    budget, as a float32 0-dim tensor on the page's device. Estimated on
    r_sp-sampled blocks with the same closed-form `block_bits` accounting
    the fused kernel reports (`estimate_zfp_many(mode='model')`). The
    candidates ride the batched estimator as one field each — the sampled
    blocks repeated along a candidate axis — so the whole grid is one call.
    Falls back to the loosest candidate when even that misses the budget
    (the caller's bits still report the truth)."""
    dev = page.device
    starts = est.block_starts(tuple(page.shape), est.DEFAULT_SAMPLING_RATE)
    blocks = est.gather_blocks(page, starts, halo=False)
    n_c, n_s = len(_RATIO_GRID_OCTAVES), blocks.shape[0]
    octaves = torch.tensor([2.0**-j for j in _RATIO_GRID_OCTAVES], dtype=torch.float32,
                           device=dev)
    ebs = vr * octaves
    cand = blocks.expand((n_c,) + tuple(blocks.shape)).reshape((n_c * n_s,) + blocks.shape[1:])
    seg = torch.arange(n_c, device=dev).repeat_interleave(n_s)
    bounds = torch.arange(n_c + 1, device=dev) * n_s
    rates = est.estimate_zfp_many(
        cand, seg, bounds, ebs, vr.expand(n_c), mode="model", psnr=False
    ).bitrate  # nonincreasing along the grid
    ok = rates <= torch.tensor(32.0 / target_ratio, dtype=torch.float32, device=dev)
    idx = torch.argmax(ok.to(torch.int32))  # first (tightest) candidate meeting the budget
    return torch.where(ok.any(), ebs[idx], ebs[-1])


#: the historical page default: a 1e-2 value-range-relative bound
DEFAULT_KV_POLICY = Policy.fixed_accuracy(eb_rel=1e-2)


def _value_range(page32: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.amax(page32) - torch.amin(page32), 1e-12)


def bot_compress_kv(
    page: torch.Tensor,
    policy: Policy | None = None,
    *,
    eb_rel: float | None = None,
    target_ratio: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ZFP-path compression of a 2-D or 3-D KV page on its own device:
    (tokens, heads*dh) flat pages ride K5, (pages, page_tokens, heads*dh)
    stacks ride K6, which exploits the correlation of adjacent pages
    instead of flattening it away.

    `policy` is the page's quality contract: `Policy.fixed_accuracy(
    eb_rel=...)` — a hard `eb_rel * value_range` bound (default eb_rel
    1e-2) or an absolute `eb_abs` — or `Policy.fixed_ratio(x)`, which
    solves the bound from the page's byte budget (see the module
    docstring). The legacy `eb_rel=` / `target_ratio=` kwargs shim onto
    the equivalent Policy with a `DeprecationWarning`.

    Returns (reconstruction in the page dtype, bits per block); callers
    compare sum(bits) against 8 * page bytes to pick a page format.
    """
    if isinstance(policy, (int, float)):  # old positional `eb_rel`
        if eb_rel is not None:
            raise ValueError("bot_compress_kv: eb_rel given twice")
        policy, eb_rel = None, float(policy)
    if policy is None:
        if eb_rel is not None or target_ratio is not None:
            if target_ratio is not None:
                policy = Policy.fixed_ratio(target_ratio)
            else:
                policy = Policy.fixed_accuracy(eb_rel=eb_rel)
            warnings.warn(
                "bot_compress_kv(eb_rel=/target_ratio=) is deprecated; pass "
                f"policy=Policy.{policy.mode}(...) (repro_torch.core.policy)",
                DeprecationWarning,
                stacklevel=2,
            )
        else:
            policy = DEFAULT_KV_POLICY
    elif eb_rel is not None or target_ratio is not None:
        raise ValueError("pass either policy= or the legacy kwargs, not both")
    page32 = page.to(torch.float32).contiguous()
    eb = _policy_eb(page32, _value_range(page32), policy)
    recon, bits = ops.bot_fused(page32, eb)
    return recon.to(page.dtype), bits


def _policy_eb(page32: torch.Tensor, vr: torch.Tensor, policy: Policy) -> torch.Tensor:
    """The page's error bound under `policy`, a float32 0-dim tensor on the
    page's device (shared by `bot_compress_kv` and `compress_page`)."""
    if policy.mode == "fixed_ratio":
        return _budget_eb(page32, vr, policy.target_ratio)
    if policy.mode == "fixed_accuracy":
        f32 = dict(dtype=torch.float32, device=page32.device)
        if policy.eb_abs is not None:
            return torch.tensor(policy.eb_abs, **f32)
        return torch.tensor(policy.eb_rel, **f32) * vr
    raise ValueError(
        f"KV page compression supports fixed_accuracy/fixed_ratio policies, "
        f"got {policy.mode!r} (fixed_psnr needs the host-side controller)"
    )


# ---------------------------------------------------------------------------
# Page-granular evict/restore entry points (serving tier, DESIGN.md §9)
# ---------------------------------------------------------------------------

#: transform key the serving tier's DecisionCache entries are stored under
PAGE_TRANSFORM = "kv_page"
_PAGE_FP_TAG = b"repro.kvpage.v1:"


@dataclasses.dataclass
class CompressedPage:
    """One evicted KV page (or cross-layer page stack) at rest, on the host.

    ``codec == 'raw'``: `payload` holds the exact page bytes — restore is
    bit-identical by construction. ``codec == 'zfp'``: the device encoder
    packed the page and `payload` holds ZFJX container bytes — `nbytes ==
    len(payload)` is the literal resident footprint. ``codec == 'bot'``:
    `payload` holds the fused-kernel reconstruction in the page dtype (a
    CPU tensor); `nbytes` is the exact ``ceil(sum(bits)/8)`` the kernel
    reports — what the bit-packed store holds on the 'zfp' path.
    """

    codec: str                     # "raw" | "zfp" | "bot"
    payload: bytes | torch.Tensor
    shape: tuple[int, ...]
    dtype: str
    nbytes: int                    # honest resident-byte accounting
    eb: float = 0.0                # solved bound (0.0 for raw)
    clean: bool = False            # content still bit-equal to the arena copy


def _page_bytes(page: torch.Tensor) -> bytes:
    """The page's exact bytes, C order (a bfloat16 page's are its int16
    bits, which equal a numpy bfloat16 array's bytes)."""
    return page.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()


def _page_fingerprint(page: torch.Tensor, vr: float, policy: Policy) -> dict:
    """Content digest over the full preimage of the page decision: the page
    bytes plus (vr, shape) and the policy already in the cache key. Pages
    freeze once decode moves past them, so the digest of a re-evicted
    frozen page matches and the solved bound replays. The preimage is the
    reference's, so a digest means the same page on both sides."""
    h = hashlib.blake2b(digest_size=16)
    h.update(_PAGE_FP_TAG)
    h.update(np.asarray(tuple(page.shape), np.int64).tobytes())
    h.update(np.asarray([vr, policy.target_ratio or 0.0], np.float64).tobytes())
    h.update(_page_bytes(page))
    return {"kind": PAGE_TRANSFORM, "digest": h.hexdigest()}


def compress_page(
    page: torch.Tensor,
    policy: Policy,
    *,
    cache=None,
    name: str | None = None,
    device_encode: bool = False,
    device=None,
) -> CompressedPage:
    """Compress one KV page (2-D) or cross-layer page stack (3-D, riding
    K6) for eviction from the serving arena, on `device` (default the GPU).

    `Policy.raw()` stores the exact bytes. Lossy policies solve the bound
    with `_policy_eb` (the path `bot_compress_kv` takes) and store the
    reconstruction plus exact bit accounting.

    `cache` is an optional `DecisionCache` (with `name`): the solved bound
    is stored under ``(name, shape, dtype, policy, 'kv_page')`` guarded by
    a content digest, so re-evicting an unchanged page replays the bound
    without re-scoring the fixed-ratio candidate grid.

    `device_encode` routes lossy pages through the device ZFP encoder
    (`core/device_encode.py`): the payload is ZFJX container bytes instead
    of a reconstruction. Pages the device encoder declines, or whose
    stream fails to beat raw, take the 'bot' path unchanged.
    """
    dev = _device.resolve(device)
    t = page.detach().to(dev)
    shape, dtype = tuple(t.shape), _device.dtype_name(t)
    size = t.numel()
    raw_nbytes = size * t.element_size()
    if policy.mode == "raw":
        return CompressedPage(
            codec="raw", payload=_page_bytes(t), shape=shape, dtype=dtype,
            nbytes=raw_nbytes, clean=True,
        )
    page32 = t.to(torch.float32).contiguous()
    vr = _value_range(page32)
    eb = None
    fp = None
    if cache is not None:
        if name is None:
            raise ValueError("compress_page: cache= needs name=")
        fp = _page_fingerprint(t, float(vr), policy)
        hit = cache.lookup(name, shape, dtype, policy, PAGE_TRANSFORM, fp)
        if hit is not None:
            eb = torch.tensor(hit.selection["eb_abs"], dtype=torch.float32, device=dev)
    if eb is None:
        eb = _policy_eb(page32, vr, policy)

    def remember(br_zfp: float) -> None:
        if cache is not None and cache.events.get(name) != "hit":
            cache.store(
                name, shape, dtype, policy, PAGE_TRANSFORM, fp,
                Selection(codec="zfp", eb_abs=float(eb), eb_sz=0.0, br_sz=0.0,
                          br_zfp=br_zfp, psnr_target=0.0, vr=float(vr),
                          r_sp=policy.r_sp),
            )

    if device_encode:
        payload = _de.zfp_encode_device(page32, float(eb))
        if payload is not None and len(payload) < raw_nbytes:
            remember(8.0 * len(payload) / max(size, 1))
            return CompressedPage(
                codec="zfp", payload=payload, shape=shape, dtype=dtype,
                nbytes=len(payload), eb=float(eb), clean=False,
            )
    recon, bits = ops.bot_fused(page32, eb)
    # the bits are integers; a float64 sum is exact at any page size
    total_bits = float(bits.sum(dtype=torch.float64))
    remember(total_bits / max(size, 1))
    return CompressedPage(
        codec="bot", payload=recon.to(t.dtype).cpu(), shape=shape, dtype=dtype,
        nbytes=-(-int(total_bits) // 8), eb=float(eb), clean=False,
    )


def decompress_page(cp: CompressedPage, *, device=None) -> torch.Tensor:
    """Restore an evicted page into arena form: a tensor of the page dtype
    on `device` (default the GPU). Raw pages restore their exact bytes;
    'zfp' pages decode their ZFJX stream with the host decoder; 'bot' pages
    return the bounded-error reconstruction the kernel produced at evict
    time."""
    dev = _device.resolve(device)
    dtype = getattr(torch, cp.dtype)
    if cp.codec == "raw":
        out = torch.frombuffer(bytearray(cp.payload), dtype=dtype).reshape(cp.shape)
    elif cp.codec == "zfp":
        rec = zfp_decompress(bytes(cp.payload)).reshape(cp.shape)
        out = torch.from_numpy(rec).to(dtype)
    elif cp.codec == "bot":
        out = cp.payload
    else:
        raise ValueError(f"unknown page codec {cp.codec!r}")
    return out.to(dev)

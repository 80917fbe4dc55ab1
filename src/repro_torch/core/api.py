"""Public compression API: fields and pytrees.

Port of `repro.core.api` (`compress`, `compress_pytree`,
`decompress_pytree`), on the GPU unless ``device="cpu"``. Quality travels
as a `Policy` (`core/policy.py`):

* ``Policy.fixed_accuracy(eb_rel=...)`` / ``(eb_abs=...)`` — the paper's
  bound-centric contract: Algorithm 1 picks the cheaper codec at that
  pointwise bound.
* ``Policy.fixed_psnr(db)`` — the quality-target controller (DESIGN.md
  §7, `core/controller.py`) solves for the per-field bound that lands on
  the target dB.
* ``Policy.fixed_ratio(x)`` — the controller solves for the bound whose
  estimated rate meets the byte budget (x vs 32-bit raw).
* ``Policy.fixed_ssim(s)`` / ``Policy.fixed_correlation(rho)`` /
  ``Policy.fixed_ks(d)`` — the quality-metric targets (DESIGN.md §7.4): the
  controller inverts the per-field metric curve (`core/quality.py`) to an
  equivalent-PSNR target and solves that; SSIM and correlation are floors,
  KS a ceiling.
* ``Policy.raw()`` — store verbatim (exact bytes, original dtype).

`compress_pytree` also takes a `PolicySet` of per-leaf-name rules. Leaves
are grouped by resolved policy, each group's decisions come from one
batched `select_many` or `solve_many`, and the byte encoders then run on a
thread pool.
The legacy keyword spelling (`mode=`, `eb_rel=`, ...) and a bare mode
string or float bound in the policy slot map onto the equivalent `Policy`
with a `DeprecationWarning`.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .. import device as _device
from . import controller as _controller
from . import pytree as _pytree
from .policy import Policy, PolicySet, as_policy_set, group_by_policy, policy_from_kwargs
from .selector import (
    CompressedField,
    Selection,
    _encode_view,
    _fold_ndim,
    compression_ratio,
    decompress,
    encode_with_selection,
    select,
    select_and_compress,
    select_many,
)

#: bytes per value of a recorded dtype name (bfloat16 without `ml_dtypes`)
_dtype_itemsize = _device.itemsize


@dataclass
class CompressedTree:
    fields: dict[str, CompressedField]
    treedef: Any

    @property
    def selection_bits(self) -> dict[str, str]:
        return {k: v.codec for k, v in self.fields.items()}

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.fields.values())

    @property
    def raw_nbytes(self) -> int:
        # the recorded dtype's itemsize, not a flat 4 bytes a value: mixed
        # trees carry f64/bf16/int raw leaves
        return sum(
            int(np.prod(v.shape)) * _dtype_itemsize(v.dtype) for v in self.fields.values()
        )

    @property
    def ratio(self) -> float:
        return self.raw_nbytes / max(self.nbytes, 1)


_leaf_name = _pytree.leaf_name


def _default_workers() -> int:
    return max(1, min(8, (os.cpu_count() or 2) - 1))


def _coerce_policy(
    where: str,
    policy,
    mode: str | None,
    eb_rel: float | None,
    eb_abs: float | None,
    target_psnr: float | None,
    target_ratio: float | None,
    r_sp: float | None,
    *,
    allow_set: bool = False,
    stacklevel: int = 4,
):
    """Resolve the (policy, legacy kwargs) pair every entry point takes: a
    Policy (or PolicySet where `allow_set`) passes through; legacy kwargs,
    a bare mode string or a bare float bound in the `policy` slot map onto
    an equivalent Policy with a `DeprecationWarning`; nothing at all means
    fixed_accuracy at eb_rel 1e-4."""
    legacy = dict(
        mode=mode, eb_rel=eb_rel, eb_abs=eb_abs,
        target_psnr=target_psnr, target_ratio=target_ratio, r_sp=r_sp,
    )
    has_legacy = any(v is not None for v in legacy.values())
    if isinstance(policy, Policy) or (allow_set and isinstance(policy, PolicySet)):
        if has_legacy:
            raise ValueError(
                f"{where}: pass either policy= or the legacy quality kwargs, not both"
            )
        return policy
    if isinstance(policy, str):  # old positional `mode`
        if legacy["mode"] is not None:
            raise ValueError(f"{where}: mode given twice")
        legacy["mode"] = policy
    elif isinstance(policy, (int, float)):  # old positional `eb_rel`
        if legacy["eb_rel"] is not None:
            raise ValueError(f"{where}: eb_rel given twice")
        legacy["eb_rel"] = float(policy)
    elif policy is not None:
        raise TypeError(
            f"{where}: expected Policy{' | PolicySet' if allow_set else ''}, "
            f"got {type(policy).__name__}"
        )
    elif not has_legacy:
        return Policy.fixed_accuracy()
    return policy_from_kwargs(where, **legacy, default_eb_rel=1e-4, stacklevel=stacklevel)


def _policy_selections(
    fields: list, pol: Policy, device, cache=None, names=None
) -> list[Selection]:
    """One policy group's decisions: fixed_accuracy runs Algorithm 1
    batched (`select_many`); the target modes run the controller
    (`solve_many`) and unwrap its `TargetSolution`s. `cache`/`names` take
    either solver's warm path."""
    if pol.mode == "fixed_accuracy":
        return select_many(fields, policy=pol, cache=cache, names=names, device=device)
    sols = _controller.solve_many(fields, pol, cache=cache, names=names, device=device)
    return [s.selection for s in sols]


def compress(
    x,
    policy: Policy | str | float | None = None,
    *,
    device_encode: bool = False,
    device=None,
    mode: str | None = None,
    eb_rel: float | None = None,
    eb_abs: float | None = None,
    target_psnr: float | None = None,
    target_ratio: float | None = None,
    r_sp: float | None = None,
) -> CompressedField:
    """Compress one field under a quality policy; returns a `CompressedField`.

    Args:
      x: the field, a numpy array or a tensor of any shape, evaluated in
        float32 (the original dtype is recorded and restored by
        `decompress`). Ranks above 3 are folded to 3-D.
      policy: the quality contract (`core/policy.py`):
        `Policy.fixed_accuracy(eb_rel=...)` (default, at eb_rel 1e-4) |
        `Policy.fixed_psnr(db)` | `Policy.fixed_ratio(x)` |
        `Policy.fixed_ssim(s)` | `Policy.fixed_correlation(rho)` |
        `Policy.fixed_ks(d)` | `Policy.raw()`. Fixed-accuracy bounds hold
        pointwise on every value of the reconstruction (`eb_rel` scales by
        the field's value range); fixed_psnr lands on the target dB (not
        merely above it); fixed_ratio meets the estimated byte budget
        within ~10%, with the chosen bound in `.selection.eb_abs`; the
        metric modes land on the metric target within
        `quality.TOLERANCE`, SSIM and correlation as floors and KS as a
        ceiling. The policy's `codecs` allowlist restricts which codecs
        compete; `r_sp` is the estimator's block sampling rate.
      device_encode: finish Stage III on the device where the selected
        codec supports it; the decision is unchanged, and a field the
        device encoder declines takes the host coder.
      device: where selection (or the target solve) and the device
        encode run; default the GPU.
      mode / eb_rel / eb_abs / target_psnr / target_ratio / r_sp:
        deprecated keyword spelling of the same contract, mapped onto a
        `Policy` with a `DeprecationWarning`.

    Raw fallback: fields that are too small (< 64 values or a dim < 4),
    constant, or NaN/inf-poisoned store verbatim with codec ``raw``; so
    does any field whose estimated rate reaches 32 bits/value at the
    requested quality, and any stream that fails to beat raw.
    """
    pol = _coerce_policy(
        "compress", policy, mode, eb_rel, eb_abs, target_psnr, target_ratio, r_sp
    )
    dev = _device.resolve(device)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    shape, dtype = tuple(x.shape), _device.dtype_name(x)
    if pol.mode == "raw":
        return CompressedField("raw", _device.raw_bytes(x), shape, dtype)
    view = _fold_ndim(_device.as_f32(x, dev))
    if pol.mode == "fixed_accuracy":
        sel = select(
            view, eb_abs=pol.eb_abs, eb_rel=pol.eb_rel, r_sp=pol.r_sp,
            codecs=pol.codecs, device=dev,
        )
    else:
        sel = _controller.solve(view, pol, device=dev).selection
    return _encode_view(view, sel, shape, dtype, device_encode)


def _is_float(leaf) -> bool:
    """The reference's `np.issubdtype(dtype, np.floating)`: float16/32/64,
    not bfloat16 (an `ml_dtypes` type there, not a numpy floating type)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype in (torch.float16, torch.float32, torch.float64)
    return np.issubdtype(leaf.dtype, np.floating)


def _named_leaves_with_policies(
    leaves: list,
    pset: PolicySet,
    predicate: Callable[[str, Any], bool] | None,
) -> tuple[list[tuple[str, Any]], dict[int, Policy]]:
    """Name every leaf, resolve its policy, and keep only the float leaves
    with a non-raw policy (that the deprecated `predicate`, when given,
    accepts) in the returned index -> Policy map. Tensors stay tensors;
    anything else becomes a numpy array (a Python float a 0-d float64)."""
    named: list[tuple[str, Any]] = []
    pol_of: dict[int, Policy] = {}
    for path, leaf in leaves:
        name = _leaf_name(path)
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        named.append((name, leaf))
        if predicate is not None and not predicate(name, leaf):
            continue
        if not _is_float(leaf):
            continue
        pol = pset.resolve(name)
        if pol.mode == "raw":
            continue
        pol_of[len(named) - 1] = pol
    return named, pol_of


def compress_pytree(
    tree: Any,
    policy: Policy | PolicySet | float | str | None = None,
    *,
    workers: int | None = None,
    sharded: bool | None = None,
    cache=None,
    device_encode: bool = False,
    device=None,
    eb_rel: float | None = None,
    eb_abs: float | None = None,
    r_sp: float | None = None,
    predicate: Callable[[str, Any], bool] | None = None,
    mode: str | None = None,
    target_psnr: float | None = None,
    target_ratio: float | None = None,
) -> CompressedTree:
    """Compress every float leaf of `tree` under per-leaf quality policies.

    Args:
      tree: nested dicts, lists, tuples and namedtuples (``None`` is an
        empty node) of numpy arrays, tensors and Python scalars; leaves are
        named by their path and visited in the reference's order
        (`core/pytree.py`).
      policy: a `Policy` for every float leaf, or a `PolicySet` resolving
        one per leaf name (first matching rule, then the default); default
        `Policy.fixed_accuracy()` (eb_rel 1e-4). Leaves whose policy is
        `Policy.raw()`, and every leaf that is not float16/32/64 (bfloat16,
        integers, bools), ride raw: exact bytes, original dtype.
      workers: thread-pool width for the byte encoders (0 encodes serially;
        default min(8, cpus - 1)). Decisions are batched regardless: each
        policy group's sampled blocks go through `select_many`
        (fixed_accuracy) or `solve_many` (the target modes).
      sharded: the shard-local engine is not ported yet; True raises.
      cache: a `DecisionCache` carrying per-leaf decisions across repeated
        saves of the same tree: leaves whose sampled blocks fingerprint as
        before replay the previous decision (what the cold path would
        recompute) and skip the estimator; drifted or new leaves re-decide
        and refresh their entry. The caller owns the cache and reuses it.
      device_encode: finish Stage III on the device for codecs that can;
        decisions are unchanged, and a declined field takes the host coder.
      device: where selection and the device encode run; default the GPU.
      eb_rel / eb_abs / r_sp / mode / target_psnr / target_ratio /
        predicate: the deprecated spelling, mapped onto a `Policy`
        (predicate rejections onto raw leaves) with a `DeprecationWarning`.

    Returns a `CompressedTree`: per-leaf `CompressedField`s (the {C_i}
    streams) plus `.selection_bits` (the {s_i}).
    """
    pol = _coerce_policy(
        "compress_pytree", policy, mode, eb_rel, eb_abs, target_psnr,
        target_ratio, r_sp, allow_set=True,
    )
    pset = as_policy_set(pol)
    if predicate is not None:
        warnings.warn(
            "compress_pytree(predicate=...) is deprecated; use PolicySet "
            "rules mapping rejected names to Policy.raw()",
            DeprecationWarning,
            stacklevel=2,
        )
    if sharded:
        raise NotImplementedError(
            "compress_pytree(sharded=True) needs the shard-local engine "
            "(core/sharded.py), not yet ported: ROADMAP.md queue A, item 14"
        )
    dev = _device.resolve(device)
    leaves, treedef = _pytree.flatten_with_path(tree)
    named, pol_of = _named_leaves_with_policies(leaves, pset, predicate)
    sel_of: dict[int, Selection] = {}
    for p, idxs in group_by_policy(pol_of).items():
        sels = _policy_selections(
            [named[i][1] for i in idxs], p, dev, cache=cache,
            names=[named[i][0] for i in idxs] if cache is not None else None,
        )
        sel_of.update(zip(idxs, sels))

    def encode(i: int) -> CompressedField:
        _, leaf = named[i]
        if i not in sel_of:
            return CompressedField(
                "raw", _device.raw_bytes(leaf), tuple(leaf.shape), _device.dtype_name(leaf)
            )
        # the original leaf goes in: the encoder works in float32 but
        # records the true dtype, so decompress restores it
        return encode_with_selection(leaf, sel_of[i], device_encode=device_encode, device=dev)

    n_workers = _default_workers() if workers is None else workers
    if n_workers > 1 and len(named) > 1:
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            encoded = list(ex.map(encode, range(len(named))))
    else:
        encoded = [encode(i) for i in range(len(named))]
    fields = {named[i][0]: cf for i, cf in enumerate(encoded)}
    return CompressedTree(fields=fields, treedef=treedef)


def decompress_pytree(ct: CompressedTree, *, device=None) -> Any:
    """Invert `compress_pytree`: every lossy leaf reconstructs within its
    bound, every raw leaf bit for bit. Leaves come back as tensors on
    `device` (default the GPU), in their recorded dtype and shape."""
    dev = _device.resolve(device)
    leaves = [decompress(cf, device=dev) for cf in ct.fields.values()]
    return _pytree.unflatten(ct.treedef, leaves)


__all__ = [
    "CompressedField",
    "CompressedTree",
    "Policy",
    "PolicySet",
    "compress",
    "compress_pytree",
    "compression_ratio",
    "decompress",
    "decompress_pytree",
    "encode_with_selection",
    "select_and_compress",
    "select_many",
]

"""Pytrees: the port's leaf walk, `compress_pytree`, `decompress_pytree` and
the policy surface they use, against the live reference on the CPU.

* Leaves are named and ordered as `jax.tree_util` names and orders them.
* On the mixed tree of tests/test_pytree_roundtrip.py, plus a namedtuple,
  a list, ``None``, a float16 leaf and a bfloat16 tensor, the port gives the
  reference's leaves in the reference's order, with the same codec, dtype
  and bytes, leaf for leaf; streams decode across the packages both ways;
  `.ratio` and `.nbytes` are equal; a serial compress gives the threaded
  bytes.
* Under ``device_encode=True`` the SZ leaves give the reference's bytes; the
  ZFP leaves are held to the host coder over the device's own codes, since
  the reference's device ZFP encoder emits corrupt streams on some of
  these leaves (ROADMAP.md queue C).
* The deprecated spellings warn and raise as the reference's do; the
  arguments not ported yet raise `NotImplementedError` naming their queue
  item.
"""

import warnings
from collections import OrderedDict, namedtuple

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import api as r_api
from repro.core import policy as r_policy
from repro_torch.core import Policy, PolicySet
from repro_torch.core import api as p_api
from repro_torch.core.decision_cache import DecisionCache
from repro_torch.core import device_encode as p_de
from repro_torch.core import policy as p_policy
from repro_torch.core import pytree as p_tree
from repro_torch.core import selector as p_sel
from repro_torch.core import zfp as p_zfp
from test_pytree_roundtrip import _mixed_tree

EB_REL = 1e-4
NT = namedtuple("NT", "b a")


def _trees(seed=0):
    """(port tree, reference tree): the same values, the bfloat16 leaf a
    tensor in the port's and an `ml_dtypes` array of the same bits in the
    reference's."""
    base = _mixed_tree(seed)
    rng = np.random.default_rng(seed + 100)
    bf = torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32)).to(torch.bfloat16)
    extra = {
        "nt": NT(b=np.cumsum(rng.standard_normal((40, 40)), 1).astype(np.float32),
                 a=np.cumsum(rng.standard_normal((64, 64)), 0).astype(np.float16)),
        "lst": [np.cumsum(rng.standard_normal((8, 32, 32)), 0).astype(np.float32), None, 2.5],
    }
    ours = dict(base, bf=bf, **extra)
    theirs = dict(base, bf=bf.view(torch.int16).numpy().view(ml_dtypes.bfloat16), **extra)
    return ours, theirs


def test_flatten_matches_jax_order_and_names():
    x, y = np.ones((2, 2)), np.zeros(3)
    tree = {"z": 1.0, "a": [x, (y, None)], "m": NT(b=x, a=y),
            "o": OrderedDict([("q", x), ("b", y)]), "3": [], "n": None, "k": {10: y, 2: x}}
    ours, treedef = p_tree.flatten_with_path(tree)
    theirs, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert [p_tree.leaf_name(p) for p, _ in ours] == [r_api._leaf_name(p) for p, _ in theirs]
    assert [p_tree.leaf_name(p) for p, _ in ours] == [
        "a/0", "a/1/0", "k/2", "k/10", "m/.b", "m/.a", "o/q", "o/b", "z"]
    assert all(a is b for (_, a), (_, b) in zip(ours, theirs))
    back = p_tree.unflatten(treedef, [leaf for _, leaf in ours])
    assert type(back["m"]) is NT and type(back["o"]) is OrderedDict
    assert list(back["o"]) == ["q", "b"] and back["n"] is None and back["3"] == []
    assert back["a"][1][1] is None and back["z"] == 1.0
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)


def _assert_same_tree(got, want, leaves=None):
    """Leaf for leaf: names in order, codec, dtype, shape and bytes. With
    `leaves` (device-encoded trees), ZFP leaves are held to the host coder
    over the device's own codes instead of the reference's bytes."""
    assert list(got.fields) == list(want.fields)
    assert got.selection_bits == want.selection_bits
    for name, w in want.fields.items():
        g = got.fields[name]
        assert (g.codec, g.dtype, tuple(g.shape)) == (w.codec, w.dtype, tuple(w.shape)), name
        view = None
        if leaves is not None and g.codec == "zfp":
            view = p_sel._fold_ndim(torch.from_numpy(np.asarray(leaves[name], np.float32)))
        if view is not None and p_de.zfp_encode_device(view, g.selection.eb_abs) is not None:
            eb = g.selection.eb_abs
            q, e = p_de.zfp_device_codes(view, eb, device="cpu")
            shape = tuple(view.shape)
            padded = tuple(s + (-s) % 4 for s in shape)
            assert g.data == p_zfp.zfp_encode_quantized(q, e, shape, padded, eb), name
            assert len(g.data) == len(w.data), name
        else:  # a declined field takes the host coder in both packages
            assert g.data == w.data, name
    assert got.nbytes == want.nbytes
    assert got.raw_nbytes == want.raw_nbytes
    assert got.ratio == want.ratio


def _bits(x) -> np.ndarray:
    """The bytes of a tensor or an array (bfloat16 of either kind too)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("device_encode", [False, True])
def test_compress_pytree_equals_reference_leaf_for_leaf(device_encode):
    ours, theirs = _trees()
    want = r_api.compress_pytree(theirs, R.Policy.fixed_accuracy(eb_rel=EB_REL),
                                 device_encode=device_encode)
    got = p_api.compress_pytree(ours, Policy.fixed_accuracy(eb_rel=EB_REL),
                                device_encode=device_encode, device="cpu")
    leaves = {p_tree.leaf_name(p): v for p, v in p_tree.flatten_with_path(ours)[0]}
    _assert_same_tree(got, want, leaves if device_encode else None)
    assert {"sz", "zfp", "raw"} <= set(got.selection_bits.values())
    assert got.fields["bf"].codec == "raw" and got.fields["bf"].selection is None
    assert got.fields["nt/.a"].dtype == "float16" and got.fields["nt/.a"].codec != "raw"
    assert got.fields["lst/2"].dtype == "float64" and got.fields["lst/2"].selection is not None
    # a serial compress gives the threaded bytes
    serial = p_api.compress_pytree(ours, Policy.fixed_accuracy(eb_rel=EB_REL),
                                   device_encode=device_encode, device="cpu", workers=0)
    assert {k: v.data for k, v in serial.fields.items()} == {
        k: v.data for k, v in got.fields.items()}
    # streams decode across the packages both ways, to the same bits
    for name in got.fields:
        g, w = got.fields[name], want.fields[name]
        as_ref = R.CompressedField(g.codec, g.data, g.shape, g.dtype, g.selection)
        np.testing.assert_array_equal(_bits(R.decompress(as_ref)),
                                      _bits(p_sel.decompress(g, device="cpu")), err_msg=name)
        as_port = p_sel.CompressedField(w.codec, w.data, w.shape, w.dtype, w.selection)
        np.testing.assert_array_equal(_bits(p_sel.decompress(as_port, device="cpu")),
                                      _bits(R.decompress(w)), err_msg=name)
    _check_roundtrip(ours, p_api.decompress_pytree(got, device="cpu"))


def _check_roundtrip(tree, out):
    """Shapes and dtypes restored, raw leaves bit for bit, lossy leaves within
    eb_rel * vr of their float32 view."""
    flat_in, _ = p_tree.flatten_with_path(tree)
    flat_out, _ = p_tree.flatten_with_path(out)
    for (path, x), (_, y) in zip(flat_in, flat_out):
        name = p_tree.leaf_name(path)
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu", name
        xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        assert tuple(y.shape) == tuple(xt.shape) and y.dtype == xt.dtype, name
        if not (xt.dtype.is_floating_point and xt.dtype != torch.bfloat16) or xt.ndim == 0:
            if xt.ndim == 0 and xt.dtype.is_floating_point:
                assert float(y) == float(np.float32(float(xt))), name
            else:
                np.testing.assert_array_equal(_bits(y), _bits(xt), err_msg=name)
            continue
        x32 = xt.to(torch.float32)
        eb = EB_REL * float(x32.max() - x32.min())
        err = float((y.to(torch.float64) - xt.to(torch.float64)).abs().max())
        tol = eb + float(np.spacing(np.float32(x32.abs().max())))
        if xt.dtype == torch.float16:
            tol += float(np.spacing(np.float16(x32.abs().max())))
        assert err <= tol, name
        y[(0,) * y.ndim] = 0  # writeable


def test_decompress_pytree_restores_tree():
    ours, _ = _trees(3)
    ct = p_api.compress_pytree(ours, Policy.fixed_accuracy(eb_rel=EB_REL), device="cpu")
    out = p_api.decompress_pytree(ct, device="cpu")
    assert type(out["nt"]) is NT and out["lst"][1] is None
    _check_roundtrip(ours, out)


def test_policy_set_raw_rules_match_reference():
    ours, theirs = _trees(9)
    rules = [("w", "raw"), ("nested/*", "raw"), ("re:^nt/", "coarse")]

    def pset(mod):
        pol = {"raw": mod.Policy.raw(), "coarse": mod.Policy.fixed_accuracy(eb_rel=1e-2)}
        return mod.PolicySet(default=mod.Policy.fixed_accuracy(eb_rel=1e-3),
                             rules=[(p, pol[k]) for p, k in rules])

    want = r_api.compress_pytree(theirs, pset(R))
    got = p_api.compress_pytree(ours, pset(p_policy), device="cpu")
    _assert_same_tree(got, want)
    for name in ("w", "nested/emb"):
        assert got.fields[name].codec == "raw" and got.fields[name].selection is None
    out = p_api.decompress_pytree(got, device="cpu")
    np.testing.assert_array_equal(out["w"].numpy(), ours["w"])
    np.testing.assert_array_equal(out["nested"]["emb"].numpy(), ours["nested"]["emb"])


def test_group_by_policy_and_lossy_names_match_reference():
    a, b = p_policy.Policy.fixed_accuracy(eb_rel=1e-3), p_policy.Policy.raw()
    ra, rb = r_policy.Policy.fixed_accuracy(eb_rel=1e-3), r_policy.Policy.raw()
    got = p_policy.group_by_policy({4: a, 1: b, 0: a, 7: b})
    want = r_policy.group_by_policy({4: ra, 1: rb, 0: ra, 7: rb})
    assert [list(v) for v in got.values()] == [list(v) for v in want.values()]
    assert [k.spec() for k in got] == [k.spec() for k in want]
    from repro.core import codecs as r_codecs
    from repro_torch.core import codecs as p_codecs

    assert p_codecs.lossy_names() == r_codecs.lossy_names()


def _field(shape=(48, 64), seed=1):
    return np.cumsum(np.random.default_rng(seed).standard_normal(shape), 0).astype(np.float32)


LEGACY = [
    ({"eb_rel": 1e-3}, None),
    ({"eb_abs": 0.05}, None),
    ({"mode": "fixed_accuracy", "eb_rel": 2e-3, "r_sp": 0.1}, None),
    ({}, 1e-3),                       # a bare float bound
    ({"eb_abs": 0.02}, "fixed_accuracy"),  # a bare mode string
]


@pytest.mark.parametrize("kwargs,positional", LEGACY)
def test_deprecated_spellings_warn_and_match_reference(kwargs, positional):
    x = _field()
    args = () if positional is None else (positional,)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        want = R.compress(x, *args, **kwargs)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = p_api.compress(x, *args, **kwargs, device="cpu")
    assert (got.codec, got.data) == (want.codec, want.data)
    tree = {"a": x, "b": _field((40, 40), 2)}
    with pytest.warns(DeprecationWarning):
        want = r_api.compress_pytree(tree, *args, **kwargs)
    with pytest.warns(DeprecationWarning):
        got = p_api.compress_pytree(tree, *args, **kwargs, device="cpu")
    assert {k: v.data for k, v in got.fields.items()} == {k: v.data for k, v in want.fields.items()}


def test_deprecated_predicate_warns_and_matches_reference():
    tree = {"a": _field(), "b": _field((40, 40), 2)}
    keep = lambda name, leaf: name != "b"  # noqa: E731
    with pytest.warns(DeprecationWarning, match="predicate"):
        want = r_api.compress_pytree(tree, R.Policy.fixed_accuracy(eb_rel=1e-3), predicate=keep)
    with pytest.warns(DeprecationWarning, match="predicate"):
        got = p_api.compress_pytree(tree, Policy.fixed_accuracy(eb_rel=1e-3), predicate=keep,
                                    device="cpu")
    assert got.fields["b"].codec == want.fields["b"].codec == "raw"
    assert {k: v.data for k, v in got.fields.items()} == {k: v.data for k, v in want.fields.items()}


ERRORS = [
    ((Policy.fixed_accuracy(),), {"eb_rel": 1e-3}, ValueError, "not both"),
    (("fixed_accuracy",), {"mode": "fixed_accuracy"}, ValueError, "mode given twice"),
    ((1e-3,), {"eb_rel": 1e-3}, ValueError, "eb_rel given twice"),
    ((), {"mode": "fixed_psnr"}, ValueError, "needs target_psnr"),
    ((), {"mode": "fixed_ratio"}, ValueError, "needs target_ratio"),
    ((), {"mode": "fixed_ssim"}, ValueError, "no legacy-kwarg spelling"),
    ((), {"mode": "bogus"}, ValueError, "unknown quality mode"),
    ((object(),), {}, TypeError, "expected Policy"),
]


@pytest.mark.parametrize("args,kwargs,exc,match", ERRORS)
def test_deprecated_spelling_errors_match_reference(args, kwargs, exc, match):
    x = _field()
    r_args = tuple(R.Policy.fixed_accuracy() if isinstance(a, Policy) else a for a in args)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(exc, match=match) as want:
            R.compress(x, *r_args, **kwargs)
        with pytest.raises(exc, match=match) as got:
            p_api.compress(x, *args, **kwargs, device="cpu")
    assert str(got.value).replace("repro_torch.", "repro.") == str(want.value)


def test_policy_set_rejected_by_compress():
    pset = PolicySet(default=Policy.fixed_accuracy())
    with pytest.raises(TypeError, match="expected Policy"):
        p_api.compress(_field(), pset, device="cpu")


@pytest.mark.parametrize("call,item", [
    (lambda t: p_api.compress_pytree(t, Policy.fixed_psnr(60.0), device="cpu"), "item 7"),
    (lambda t: p_api.compress_pytree(t, Policy.fixed_ratio(8.0), device="cpu"), "item 7"),
    (lambda t: p_api.compress(t["a"], Policy.fixed_ssim(0.99), device="cpu"), "item 7"),
    (lambda t: p_api.compress_pytree(t, cache=DecisionCache(), device="cpu"), "item 8"),
    (lambda t: p_api.compress_pytree(t, sharded=True, device="cpu"), "item 14"),
])
def test_not_yet_ported_arguments_raise(call, item):
    """The target modes (item 7), the warm path (item 8) and the
    shard-local engine (item 14a; plain tensors take its gather path) are
    ported and compress."""
    if item in ("item 7", "item 8", "item 14"):
        out = call({"a": _field()})
        cf = out.fields["a"] if isinstance(out, p_api.CompressedTree) else out
        assert cf.codec in ("sz", "zfp") and cf.selection is not None
        return
    with pytest.raises(NotImplementedError, match=item):
        call({"a": _field()})


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: p_api.compress_pytree({"a": _field()}),
                 lambda: p_sel.select_many([_field()], eb_rel=1e-3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

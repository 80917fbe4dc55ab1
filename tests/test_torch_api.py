"""The port's `compress` entry point, its device rules and its isolation.

* `compress(..., device_encode=True, device="cpu")` driven by a reference
  decision carried over with `interop` gives the reference's bytes, and the
  decoded field honours eb_abs pointwise.
* With no CUDA device the entry points raise unless ``device="cpu"``.
* No module of `repro_torch` (nor `chip_smoke.py`) imports JAX or the
  reference package, and importing the API leaves JAX unloaded.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import policy as r_policy
from repro_torch.core import api, codecs, device_encode, interop, policy, selector
from repro_torch.kernels import lorenzo, ops

ROOT = Path(__file__).resolve().parent.parent
EB_REL = 1e-3


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)


def _carried(x, monkeypatch, pol):
    """Pin the port's decision to the reference's, carried over by value."""
    ref_sel = R.select(x, eb_rel=pol.eb_rel, eb_abs=pol.eb_abs, codecs=pol.codecs)
    sel = interop.selection_from_reference(dataclasses.asdict(ref_sel))
    monkeypatch.setattr(api, "select", lambda *a, **k: sel)
    return sel


CASES = [
    ((64, 96), ("sz", "zfp", "raw")),
    ((64, 96), ("zfp", "raw")),
    ((12, 20, 24), ("sz", "zfp", "raw")),
    ((12, 20, 24), ("zfp", "raw")),
    ((4096,), ("sz", "zfp", "raw")),
    ((2, 3, 16, 16), ("sz", "zfp", "raw")),
]


@pytest.mark.parametrize("shape,allowed", CASES)
@pytest.mark.parametrize("device_encode", [True, False])
def test_compress_bytes_equal_reference_for_the_same_decision(
    monkeypatch, shape, allowed, device_encode
):
    x = _field(shape, 1)
    pol = R.Policy.fixed_accuracy(eb_rel=EB_REL, codecs=allowed)
    sel = _carried(x, monkeypatch, pol)
    ours = api.compress(x, interop.policy_from_spec(pol.spec()),
                        device_encode=device_encode, device="cpu")
    theirs = R.compress(x, pol, device_encode=device_encode)
    assert ours.codec == theirs.codec == sel.codec
    assert ours.data == theirs.data
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert selector.compression_ratio(ours) == R.compression_ratio(theirs)
    # decode with both packages, both directions
    back = selector.decompress(ours, device="cpu").numpy()
    np.testing.assert_array_equal(back, R.decompress(theirs))
    assert np.max(np.abs(back - x)) <= sel.eb_abs + 4 * np.spacing(np.abs(x).max())


@pytest.mark.parametrize("shape", [(64, 96), (12, 20, 24)])
def test_compress_end_to_end_on_cpu(shape):
    """The port's own decision, encode and decode: within eb_abs, and the
    2-D/3-D SZ fields go through the kernel wrappers' plain versions."""
    x = _field(shape, 2)
    cf = api.compress(x, policy.Policy.fixed_accuracy(eb_rel=EB_REL),
                      device_encode=True, device="cpu")
    want = R.select(x, eb_rel=EB_REL)
    assert cf.codec == want.codec
    out = selector.decompress(cf, device="cpu")
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    assert float((out - torch.from_numpy(x)).abs().max()) <= cf.selection.eb_abs
    assert ops.pallas_rank(shape) == len(shape)


def test_raw_policy_and_dtype_restore():
    x = _field((20, 30), 3).astype(np.float64)
    ours = api.compress(x, policy.Policy.raw(), device="cpu")
    theirs = R.compress(x, R.Policy.raw())
    assert ours.data == theirs.data and ours.dtype == "float64"
    out = selector.decompress(ours, device="cpu")
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), x)
    lossy = api.compress(x, policy.Policy.fixed_accuracy(eb_rel=EB_REL), device="cpu")
    assert selector.decompress(lossy, device="cpu").dtype == torch.float64


@pytest.mark.parametrize("mode", ["fixed_psnr", "fixed_ratio", "fixed_ssim",
                                  "fixed_correlation", "fixed_ks"])
def test_target_modes_are_declared_but_not_ported(mode):
    """Each target mode's policy is the reference's, and (now that the
    controller is ported) `compress` under it takes the reference's
    decision and decodes to the field's shape and dtype."""
    target = {"fixed_psnr": 60.0, "fixed_ratio": 8.0}.get(mode, 0.5)
    pol = getattr(policy.Policy, mode)(target)
    ref_pol = getattr(R.Policy, mode)(target)
    assert pol.spec() == ref_pol.spec()
    x = _field((64, 64), 4)
    cf = api.compress(x, pol, device="cpu")
    want = R.compress(x, ref_pol)
    assert cf.codec == want.codec
    assert cf.selection.eb_abs == pytest.approx(want.selection.eb_abs, rel=1e-4)
    y = selector.decompress(cf, device="cpu")
    assert tuple(y.shape) == x.shape and y.dtype == torch.float32


def test_policy_specs_and_sets_match_reference():
    for ref_pol in [R.Policy.fixed_accuracy(eb_abs=0.5), R.Policy.fixed_accuracy(eb_rel=1e-5, r_sp=0.1),
                    R.Policy.fixed_accuracy(codecs=("zfp",)), R.Policy.raw(),
                    R.Policy.fixed_psnr(55.0)]:
        ours = interop.policy_from_spec(ref_pol.spec())
        assert ours.spec() == ref_pol.spec()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref_pol)
    assert policy.MODES == r_policy.MODES
    rules = (("opt/*", policy.Policy.raw()), ("re:kv/\\d+", policy.Policy.fixed_ratio(4.0)))
    pset = policy.PolicySet(default=policy.Policy.fixed_accuracy(), rules=rules)
    rset = R.PolicySet(default=R.Policy.fixed_accuracy(), rules=(
        ("opt/*", R.Policy.raw()), ("re:kv/\\d+", R.Policy.fixed_ratio(4.0))))
    for name in ["opt/m", "kv/12", "w/kv/3", "layer0/w"]:
        assert pset.resolve(name).spec() == rset.resolve(name).spec()
    with pytest.raises(ValueError):
        policy.Policy.fixed_accuracy(codecs=("nope",))


def test_selection_carried_over_by_value():
    x = _field((64, 64), 5)
    ref_sel = R.select(x, eb_rel=EB_REL)
    sel = interop.selection_from_reference(dataclasses.asdict(ref_sel))
    assert dataclasses.asdict(sel) == dataclasses.asdict(ref_sel)


def test_codec_registry_matches_reference():
    from repro.core import codecs as r_codecs

    assert codecs.names() == r_codecs.names()
    assert codecs.DEFAULT_CODECS == r_codecs.DEFAULT_CODECS
    for name in codecs.names():
        assert codecs.supports_device_encode(name) == r_codecs.supports_device_encode(name)
        ours, theirs = codecs.get(name), r_codecs.get(name)
        for flag in ("blockwise", "pointwise_bound", "lossless"):
            assert getattr(ours, flag) == getattr(theirs, flag)
    with pytest.raises(KeyError):
        codecs.get("lz4")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    x = _field((64, 64), 6)
    sel = R.select(x, eb_rel=EB_REL)
    psel = interop.selection_from_reference(dataclasses.asdict(sel))
    cf = api.compress(x, device="cpu")
    calls = [
        lambda: api.compress(x),
        lambda: selector.select(x, eb_rel=EB_REL),
        lambda: selector.encode_with_selection(x, psel),
        lambda: selector.decompress(cf),
        lambda: device_encode.sz_encode_device(x, 0.01),
        lambda: device_encode.zfp_encode_device(x, 0.01),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_kernel_wrappers_take_the_tensors_device():
    """A CPU tensor runs the plain version (the caller chose the CPU); no
    launch is counted and nothing is built."""
    before = dict(lorenzo.LAUNCHES)
    d = lorenzo.lorenzo2d_encode(torch.from_numpy(_field((16, 16), 7)), 0.01)
    assert d.device.type == "cpu" and d.dtype == torch.int32
    assert lorenzo.LAUNCHES == before


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_no_jax_and_no_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_importing_the_api_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch.core.api, repro_torch.core.device_encode;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')];"
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr

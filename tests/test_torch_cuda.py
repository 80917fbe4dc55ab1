"""The port on the card: each CUDA kernel against its plain version, and the
main path on the GPU against the same path on the CPU.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The file
imports neither JAX nor the reference package, so it runs on a machine that
has only PyTorch (the reference comparisons live in the other
`test_torch_*.py` files, which run on the CPU):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Policy, compress, decompress, encode_with_selection, select
from repro_torch.core import device_encode as de
from repro_torch.kernels import lorenzo, ref

pytestmark = pytest.mark.cuda

SHAPES = [(300, 517), (8, 128), (4, 40), (7, 64, 64), (4, 4, 129)]
EB_REL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)


def _kernel_name(ndim):
    return "lorenzo2d_encode" if ndim == 2 else "lorenzo3d_encode"


def _launch_and_compare(x, eb, dev):
    name = _kernel_name(x.ndim)
    xt = torch.from_numpy(x).to(dev)
    before = lorenzo.LAUNCHES[name]
    got = getattr(lorenzo, name)(xt, eb)
    torch.cuda.synchronize()
    assert lorenzo.LAUNCHES[name] == before + 1
    assert got.device == xt.device and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), ref.lorenzo_encode_ref(xt, eb).cpu().numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_device, shape):
    x = _field(shape, 4)
    _launch_and_compare(x, 1e-3 * float(x.max() - x.min()), cuda_device)


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_half_bin_ties(cuda_device, shape):
    """Values exactly at (k + 0.5) * delta round half to even on the card."""
    eb = 2.0**-7
    k = np.random.default_rng(1).integers(-1000, 1000, size=shape)
    _launch_and_compare(((k + 0.5) * 2 * eb).astype(np.float32), eb, cuda_device)


@pytest.mark.parametrize("name,ndim", [("lorenzo2d_encode", 2), ("lorenzo3d_encode", 3)])
def test_cuda_wrapper_rejects_bad_inputs(cuda_device, name, ndim):
    kernel = getattr(lorenzo, name)
    good = torch.zeros((8,) * ndim, device=cuda_device)
    with pytest.raises(TypeError):
        kernel(good.double(), 0.1)
    with pytest.raises(ValueError):
        kernel(good.transpose(0, 1), 0.1)


# large enough that SZ stays below 32 bits/value also where zstandard is
# missing and the Huffman table costs 40 bits a symbol
@pytest.mark.parametrize("shape", [(64, 96), (16, 48, 48)])
@pytest.mark.parametrize("codecs", [("sz", "raw"), ("zfp", "raw")])
def test_main_path_on_card_equals_cpu(cuda_device, shape, codecs):
    """The same decision gives the same container bytes on the card and on
    the CPU, with no device-encode decline; SZ fields launch their kernel,
    and the card's own compress + decompress honours eb_abs."""
    x = _field(shape, 2)
    sel = select(x, eb_rel=EB_REL, codecs=codecs, device="cpu")
    assert sel.codec == codecs[0]
    name = _kernel_name(len(shape))
    launches, declines = lorenzo.LAUNCHES[name], sum(de.DECLINES.values())
    on_card = encode_with_selection(x, sel, device_encode=True, device=cuda_device)
    assert lorenzo.LAUNCHES[name] == launches + (sel.codec == "sz")
    on_cpu = encode_with_selection(x, sel, device_encode=True, device="cpu")
    assert on_card.data == on_cpu.data
    assert sum(de.DECLINES.values()) == declines
    cf = compress(x, Policy.fixed_accuracy(eb_rel=EB_REL, codecs=codecs),
                  device_encode=True, device=cuda_device)
    out = decompress(cf, device=cuda_device)
    assert out.device.type == cuda_device.type and tuple(out.shape) == shape
    assert float((out.cpu() - torch.from_numpy(x)).abs().max()) <= cf.selection.eb_abs

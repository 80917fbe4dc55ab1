"""The port's cell shapes (`repro_torch.launch.shapes`) against the
reference's `repro.launch.shapes`: the shape table and the field shapes,
and for every arch x shape `applicable`, `shape_config` and `input_specs`
(keys, shapes and dtypes), and `compression_view` on the reference's own
fold cases and more. Everything is equal exactly."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_get_config
from repro.launch import shapes as r_shp
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import shapes as shp

CELLS = [(a, s) for a in ARCHS for s in shp.SHAPES]
_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


def test_tables_are_the_references():
    assert ARCHS == R_ARCHS
    assert shp.SHAPES == r_shp.SHAPES
    assert shp.FIELD_SHAPES == r_shp.FIELD_SHAPES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_applicable_and_shape_config(arch, shape):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    assert shp.applicable(cfg, shape) == r_shp.applicable(rcfg, shape)
    got, want = shp.shape_config(cfg, shape), r_shp.shape_config(rcfg, shape)
    assert got.attn_window == want.attn_window
    assert dataclasses.asdict(got) == dataclasses.asdict(dataclasses.replace(
        cfg, attn_window=want.attn_window))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs(arch, shape):
    got = shp.input_specs(get_config(arch), shape)
    want = r_shp.input_specs(r_get_config(arch), shape)
    assert set(got) == set(want)
    for k in want:
        if k != "batch":
            assert got[k] == want[k], k
    assert list(got["batch"]) == list(want["batch"])
    for k, w in want["batch"].items():
        g = got["batch"][k]
        assert g.shape == tuple(w.shape), k
        assert g.dtype == _DTYPES[jnp.dtype(w.dtype).type], k


@pytest.mark.parametrize("shape", [
    (96, 256, 256), (8, 64, 64, 64), (2, 3, 8, 32, 32), (2, 96, 96),
    (384, 768), (100, 500, 500), (512, 512, 512), (1, 1, 64), (3, 4), (7,), (),
    (2, 2, 2, 2, 2, 64), (5, 1, 3, 9, 9),
])
def test_compression_view(shape):
    assert shp.compression_view(shape) == r_shp.compression_view(shape)


def test_compression_view_of_the_field_shapes():
    for name, shape in shp.FIELD_SHAPES.items():
        assert shp.compression_view(shape) == r_shp.compression_view(shape) == shape, name

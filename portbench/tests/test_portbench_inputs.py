"""The torch generator against the numpy rule it copies, and the plain
reference against the program at a small size on the CPU."""

import numpy as np
import pytest
import torch

from portbench import refcodec, refselect, spec
from portbench.fields import Snapshots, spectral_field


@pytest.mark.parametrize("shape,slope,nonlin", [
    ((48, 96), -3.5, "none"), ((48, 96), -1.2, "relu"), ((40, 64), -2.0, "exp"),
    ((12, 24, 20), -4.0, "relu"), ((12, 24, 20), -2.5, "none"),
])
def test_generator_matches_the_numpy_rule(shape, slope, nonlin):
    from benchmarks.common import _spectral_field

    seed = 123
    white = np.random.default_rng(seed).standard_normal(shape)
    want = _spectral_field(shape, slope, seed, None if nonlin == "none" else nonlin)
    got = spectral_field(torch.from_numpy(white), slope, nonlin).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("cell", ["atm-e4", "hurricane-e4"])
def test_snapshots_come_from_the_seed_and_differ_every_request(cell):
    c = spec.load_cell(cell)
    shape = (32, 64) if len(c.config["shape"]) == 2 else (8, 16, 16)
    a = Snapshots(c.config, 2**31 + 5, torch.device("cpu"), shape)
    b = Snapshots(c.config, 2**31 + 5, torch.device("cpu"), shape)
    other = Snapshots(c.config, 6, torch.device("cpu"), shape)
    s1, s2 = a.snapshot(1), a.snapshot(2)
    assert list(s1) == [f["name"] for f in c.config["fields"]] == a.names
    assert len(s1) == c.config["n_fields"] == c.config["published"]["n_fields"]
    for k in s1:
        assert s1[k].dtype == torch.float32 and tuple(s1[k].shape) == shape
        # made again bit for bit, as the check makes it
        assert torch.equal(s1[k], b.snapshot(1)[k])
        np.testing.assert_array_equal(a.host(1, k), s1[k].numpy())
        # a new snapshot every request, and other data under another seed
        assert not torch.equal(s1[k], s2[k])
        assert not torch.equal(s1[k], other.snapshot(1)[k])
    assert len({float(v.double().sum()) for v in s1.values()}) == len(s1)


def test_a_snapshot_is_the_rule_on_a_rotated_draw():
    shape = (48, 96)
    cfg = {"shape": list(shape), "fields": [
        {"name": "f", "slope": -2.2, "nonlin": "exp", "noise": 0.0},
        {"name": "n", "slope": -1.0, "nonlin": "relu", "noise": 0.01}]}
    snaps = Snapshots(cfg, 11, torch.device("cpu"))
    t = snaps.angle(3)
    for j, name in enumerate(snaps.names):
        a, b = (v.double().numpy() for v in snaps.bases[j])
        g = np.cos(t) * a + np.sin(t) * b
        g = (g - g.mean()) / g.std()
        got = snaps.host(3, name)
        if name == "f":
            np.testing.assert_allclose(got, np.exp(g), rtol=1e-5)
        else:
            noise = got - np.maximum(g, 0)
            assert 0.008 < noise.std() < 0.012 and abs(noise.mean()) < 0.003


def _program_fields(shape, n=4):
    c = spec.load_cell("atm-e4" if len(shape) == 2 else "hurricane-e4")
    f = Snapshots(c.config, 5, torch.device("cpu"), shape).snapshot(1)
    return dict(list(f.items())[:n])


@pytest.mark.parametrize("shape", [(64, 128), (16, 40, 40)])
@pytest.mark.parametrize("device_encode", [False, True])
def test_reference_decodes_the_programs_streams(shape, device_encode):
    from repro_torch.core import api
    from repro_torch.core.policy import Policy

    fields = _program_fields(shape)
    for pol in (Policy.fixed_accuracy(eb_rel=1e-4), Policy.fixed_psnr(60.0)):
        tree = api.compress_pytree(fields, pol, device_encode=device_encode, device="cpu")
        for name, cf in tree.fields.items():
            want = api.decompress(cf, device="cpu").numpy()
            got = refcodec.decode(cf.codec, cf.data, tuple(fields[name].shape))
            np.testing.assert_array_equal(got, want)


def test_reference_decoder_rejects_a_cut_stream():
    from repro_torch.core import api
    from repro_torch.core.policy import Policy

    fields = _program_fields((64, 128), 2)
    tree = api.compress_pytree(fields, Policy.fixed_accuracy(eb_rel=1e-4), device="cpu")
    for name, cf in tree.fields.items():
        with pytest.raises(Exception):
            refcodec.decode(cf.codec, cf.data[: len(cf.data) // 2], tuple(fields[name].shape))


@pytest.mark.parametrize("shape", [(256, 512), (32, 64, 64)])
def test_reference_algorithm1_agrees_with_the_program(shape):
    from repro_torch.core.policy import Policy
    from repro_torch.core.selector import select_many

    fields = _program_fields(shape)
    sels = select_many(list(fields.values()), policy=Policy.fixed_accuracy(eb_rel=1e-4),
                       device="cpu")
    for (name, x), s in zip(fields.items(), sels):
        r = refselect.decide(x.numpy(), 1e-4)
        assert s.codec == r["codec"], name
        assert abs(s.eb_abs / r["eb_abs"] - 1) < 1e-6
        assert abs(s.br_zfp / r["br_zfp"] - 1) < 1e-3
        assert abs(s.br_sz / r["br_sz"] - 1) < 2e-2

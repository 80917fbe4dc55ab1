"""The benchmark's inputs: spectral stand-ins for the SDRBench fields,
drawn on the device from the run's seed, a new snapshot every request.

A torch copy of the rule in `benchmarks/common.py` (`_spectral_field`,
`atm_suite`, `hurricane_suite`): a Gaussian random field with power-law
spectrum k^slope, normalised, then passed through an optional nonlinearity
(relu: intermittent, precipitation-like; exp: log-normal, density-like) and,
where the field has a noise level, white noise added. Each field's slope,
nonlinearity and noise level come from the configuration file.

A simulation writes a new step every time, so every request gets a new
snapshot. At set-up each field draws two independent Gaussian fields A and
B with its spectrum (white noise drawn and shaped in float64, as the numpy
rule does, kept normalised in float32). Snapshot r of the field is
cos(t_r) A + sin(t_r) B, which is again a Gaussian field with that
spectrum, normalised, through the nonlinearity, with white noise drawn
anew. The angle t_r and the noise follow from the seed, r and the field,
so the check makes any snapshot again, bit for bit, on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_field(white: torch.Tensor, slope: float) -> torch.Tensor:
    """The numpy rule's spectral shaping and normalisation of a float64
    white-noise tensor (float64, zero mean, unit deviation)."""
    shape = tuple(white.shape)
    nd = len(shape)
    f = torch.fft.fftn(white)
    k2 = None
    for ax, s in enumerate(shape):
        g = torch.fft.fftfreq(s, dtype=torch.float64, device=white.device) ** 2
        g = g.reshape([s if i == ax else 1 for i in range(nd)])
        k2 = g if k2 is None else k2 + g
    k = torch.sqrt(k2)
    k[(0,) * nd] = 1e-6
    f *= k ** (slope / 2.0)
    del k, k2
    x = torch.fft.ifftn(f).real
    del f
    return (x - x.mean()) / (x.std(correction=0) + 1e-12)


def nonlinear(x: torch.Tensor, nonlin: str) -> torch.Tensor:
    if nonlin == "exp":
        return torch.exp(x)
    if nonlin == "relu":
        return torch.clamp_min(x, 0.0)
    if nonlin != "none":
        raise ValueError(f"unknown nonlinearity {nonlin!r}")
    return x


def spectral_field(white: torch.Tensor, slope: float, nonlin: str) -> torch.Tensor:
    """The numpy rule's `_spectral_field` on a given float64 white-noise
    tensor: float32 field of the same shape, on the same device."""
    return nonlinear(gaussian_field(white, slope), nonlin).to(torch.float32)


def _seed64(*parts: int) -> int:
    return int(np.random.SeedSequence([int(p) % (1 << 63) for p in parts])
               .generate_state(1, np.uint64)[0])


class Snapshots:
    """The snapshots of one run: `field(r, j)` is field j of snapshot r,
    `snapshot(r)` all of them by name, in the configuration's order."""

    def __init__(self, config: dict, seed: int, device, shape=None):
        self.specs = list(config["fields"])
        self.names = [s["name"] for s in self.specs]
        self.shape = tuple(config["shape"] if shape is None else shape)
        self.seed = int(seed)
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_seed64(self.seed, 1))
        self.bases = []
        for s in self.specs:
            pair = []
            for _ in range(2):
                white = torch.randn(self.shape, generator=gen, dtype=torch.float64,
                                    device=self.device)
                pair.append(gaussian_field(white, float(s["slope"])).to(torch.float32))
                del white
            self.bases.append(tuple(pair))

    def angle(self, r: int) -> float:
        return 2.0 * math.pi * float(np.random.default_rng(_seed64(self.seed, 2, r)).random())

    def field(self, r: int, j: int) -> torch.Tensor:
        s, (a, b) = self.specs[j], self.bases[j]
        t = self.angle(r)
        g = math.cos(t) * a + math.sin(t) * b
        g = (g - g.mean()) / (g.std(correction=0) + 1e-12)
        x = nonlinear(g, s["nonlin"])
        if s["noise"]:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_seed64(self.seed, 3, r, j))
            x = x + float(s["noise"]) * torch.randn(self.shape, generator=gen,
                                                    dtype=torch.float32, device=self.device)
        return x.contiguous()

    def snapshot(self, r: int, names=None) -> dict[str, torch.Tensor]:
        keep = self.names if names is None else names
        return {n: self.field(r, j) for j, n in enumerate(self.names) if n in keep}

    def host(self, r: int, name: str) -> np.ndarray:
        """Field `name` of snapshot r, made again, as a host float32 array."""
        return self.field(r, self.names.index(name)).cpu().numpy()

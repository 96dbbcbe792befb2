"""Seeded synthetic fields: Gaussian random fields with a power-law
spectrum, given a fixed marginal law by rank, then shaped by a per-field
recipe into densities, velocities, cloud fractions, fluxes or topography.

A configuration file lists its fields, each with a recipe (`kind` and its
numbers); make_field reads them. The spectrum is flat below the knee
(`knee` times the shortest grid side, in cycles per grid) and falls as
|k|**-slope above it. The field's values are the standard normal quantiles
(i + 0.5) / n placed in the order of the random field's ranks, so every
seed gives the same multiset of values, the same range and the same
spectrum: only the arrangement moves with the seed, and with it the work of
a run as little as a random field allows. The same seed gives the same
fields on one device type. Fields are made on the given device in float32,
in a few large calls each (one normal draw, one FFT pair, one sort).
"""

from __future__ import annotations

import torch

_MASK63 = (1 << 63) - 1


def field_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for field `index` of a run seeded `seed`
    (any integer, negative or past 64 bits included)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019 * (index + 1)) & _MASK63


def gaussian_field(shape, slope: float, knee: float, gen: torch.Generator,
                   device) -> torch.Tensor:
    """Zero-mean float32 random field of `shape` whose amplitude goes as
    (k0**2 + |k|**2)**(-slope / 4), k0 = knee * min(shape) (the mean mode
    removed)."""
    noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    spec = torch.fft.rfftn(noise)
    del noise
    k2 = None
    for axis, n in enumerate(shape):
        last = axis == len(shape) - 1
        f = (torch.fft.rfftfreq(n, d=1.0 / n, device=device) if last
             else torch.fft.fftfreq(n, d=1.0 / n, device=device))
        view = [1] * len(shape)
        view[axis] = f.shape[0]
        term = (f * f).reshape(view)
        k2 = term if k2 is None else k2 + term
    k0 = max(1.0, knee * min(shape))
    amp = torch.where(k2 > 0, (k2 + k0 * k0) ** (-slope / 4.0),
                      torch.zeros_like(k2))
    spec *= amp
    del amp, k2
    g = torch.fft.irfftn(spec, s=shape)
    return g.reshape(-1)


def normal_scores(g: torch.Tensor) -> torch.Tensor:
    """The standard normal quantiles (i + 0.5) / n of a flat field, i its
    values' ranks: a fixed marginal law in the field's arrangement."""
    n = g.numel()
    order = torch.sort(g, stable=True).indices
    p = (torch.arange(n, device=g.device, dtype=torch.float64) + 0.5) / n
    z = torch.special.ndtri(p).to(torch.float32)
    out = torch.empty_like(g)
    out[order] = z
    return out


def _shape(field: dict, u: torch.Tensor, gen: torch.Generator, device,
           shape) -> torch.Tensor:
    kind = field["kind"]
    if kind == "gaussian":
        return field.get("loc", 0.0) + field["scale"] * u
    if kind == "lognormal":
        return field["scale"] * torch.exp(field["sigma"] * u)
    if kind == "fraction":
        return torch.clamp(field["loc"] + field["scale"] * u, 0.0, 1.0)
    if kind == "flux":
        # a smooth field over a latitude profile on a (lat, lon) grid; its
        # values are a fixed multiset (the profile plus the normal quantiles
        # in a fixed shuffle), placed by the rank of the seeded field
        lat = torch.linspace(-1.0, 1.0, shape[0], device=device)
        prof = torch.cos(lat * (torch.pi / 2.0))[:, None].expand(shape).reshape(-1)
        fixed = torch.Generator(device=device)
        fixed.manual_seed(0)
        z = u.sort().values[torch.randperm(u.numel(), generator=fixed, device=device)]
        values = (field["loc"] * prof + field["scale"] * z).sort().values
        out = torch.empty_like(u)
        out[torch.sort(field["loc"] * prof + field["scale"] * u, stable=True).indices] = values
        return torch.clamp_min(out, 0.0)
    if kind == "topography":
        # zero over the sea, a log-normal height over land: the land mask is
        # a second, smoother field's top (1 - sea_fraction) share by rank,
        # and the heights are placed by rank among the land points alone, so
        # the land's count and its heights are the same for every seed
        mask_u = normal_scores(gaussian_field(shape, field["mask_slope"],
                                              field["knee"], gen, device))
        cut = float(torch.special.ndtri(torch.tensor(field["sea_fraction"],
                                                     dtype=torch.float64)))
        land = mask_u > cut
        out = torch.zeros_like(u)
        out[land] = field["scale"] * torch.exp(field["sigma"] * normal_scores(u[land]))
        return out
    raise ValueError(f"unknown field kind {kind!r}")


def make_field(config: dict, index: int, seed: int, device,
               shape=None) -> torch.Tensor:
    """Field `index` of the configuration as a flat float32 tensor on
    `device`; `shape` replaces the configuration's (a rehearsal's size)."""
    shape = tuple(shape or config["shape"])
    field = config["fields"][index]
    gen = torch.Generator(device=device)
    gen.manual_seed(field_seed(seed, index))
    u = normal_scores(gaussian_field(shape, field["slope"], field["knee"],
                                     gen, device))
    return _shape(field, u, gen, device, shape).to(torch.float32).contiguous()

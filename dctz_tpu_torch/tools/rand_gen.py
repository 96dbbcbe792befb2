"""Synthetic test-data generator (tools/rand-gen.c:15-41 equivalent, plus
scientific-data-shaped signals the shell harness lacked).

Usage: python -m dctz_tpu_torch.tools.rand_gen <n> <out.bin> [--dtype f64|f32]
           [--kind rand|smooth|climate] [--seed N]

A copy of dctz_tpu.tools.rand_gen (numpy only).
"""

from __future__ import annotations

import argparse

import numpy as np


def generate(n: int, kind: str = "rand", seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "rand":
        # reference rand-gen emits random integers via rand(); keep the
        # spirit: uniform random values
        return rng.integers(0, 1 << 20, size=n).astype(np.float64)
    if kind == "smooth":
        t = np.linspace(0, 60 * np.pi, n)
        return np.sin(t) * 50 + np.cos(t * 0.37) * 20
    if kind == "climate":
        # smooth field + small-scale noise + rare moderate spikes, the
        # structure of CESM-ATM-like variables
        t = np.linspace(0, 200 * np.pi, n)
        x = np.sin(t) * 40 + np.sin(t * 13.7) * 3 + rng.standard_normal(n) * 0.2
        spikes = rng.random(n) < 1e-4
        x[spikes] *= 5
        return x
    if kind == "spiky":
        # adversarial stress case: huge isolated spikes drive the scaling
        # factor up and concentrate error in spike blocks
        t = np.linspace(0, 200 * np.pi, n)
        x = np.sin(t) * 40 + rng.standard_normal(n) * 0.2
        x[rng.random(n) < 1e-4] *= 50
        return x
    if kind.startswith("spectral"):
        # 1/f^alpha noise via FFT shaping: turbulence-like fields with a
        # realistic power spectrum — unlike the sinusoid kinds above they
        # are NOT trivially linearly predictable, so the dctz-vs-sz_like
        # rate-distortion comparison is not biased toward either codec
        # (docs: BASELINE.md rate-distortion section)
        alpha = {"spectral": 1.0, "spectral2": 2.0, "spectral05": 0.5}[kind]
        freqs = np.fft.rfftfreq(n)
        amp = np.where(freqs > 0, freqs ** (-alpha / 2.0), 0.0)
        phase = rng.uniform(0, 2 * np.pi, len(freqs))
        spec = amp * np.exp(1j * phase)
        x = np.fft.irfft(spec, n)
        return x / np.abs(x).max() * 100.0
    raise ValueError(f"unknown kind {kind}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rand_gen")
    p.add_argument("n", type=int)
    p.add_argument("out")
    p.add_argument("--dtype", choices=["f64", "f32"], default="f64")
    p.add_argument("--kind", choices=["rand", "smooth", "climate", "spiky", "spectral", "spectral2", "spectral05"], default="rand")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    x = generate(args.n, args.kind, args.seed)
    x.astype(np.float64 if args.dtype == "f64" else np.float32).tofile(args.out)
    print(f"wrote {args.n} {args.dtype} elements to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

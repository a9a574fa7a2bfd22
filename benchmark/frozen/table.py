"""The synthetic premixed opacity table, a copy of
``helios_tpu_torch.io.opacity.synthetic_premixed_table`` (with its
Gauss-Legendre nodes) that returns plain numpy arrays.
``benchmark/tests/test_frozen.py`` holds it to the program's generator bit
for bit."""

from __future__ import annotations

import numpy as np

AMU = 1.6605390666e-24          # [g]


def gauss_legendre_ypoints(ny: int):
    """Shifted Gauss-Legendre nodes and weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(ny)
    return 0.5 * (x + 1.0), w


def synthetic_premixed_table(nbin: int = 385, ny: int = 20,
                             ntemp: int = 60, npress: int = 31,
                             lambda_min: float = 0.245e-4,
                             lambda_max: float = 500e-4,
                             seed: int = 0, dtype=np.float64) -> dict:
    """The fields of the table: kpoints [ntemp, npress, nbin, ny],
    temperatures, pressures, wave_centers, wave_edges, delta_wave, gauss_y,
    scat_cross [ntemp, npress, nbin] and meanmolmass [ntemp, npress]."""
    rng = np.random.default_rng(seed)
    edges = np.geomspace(lambda_min, lambda_max, nbin + 1)
    centers = 0.5 * (edges[1:] + edges[:-1])
    dwave = np.diff(edges)
    temps = np.linspace(50.0, 6000.0, ntemp)
    press = np.logspace(0.0, 10.0, npress)
    y, _ = gauss_legendre_ypoints(ny)

    loglam = np.log10(centers)
    envelope = np.zeros(nbin)
    for _ in range(8):
        c = rng.uniform(loglam.min(), loglam.max())
        wdt = rng.uniform(0.05, 0.4)
        amp = rng.uniform(0.5, 3.0)
        envelope += amp * np.exp(-0.5 * ((loglam - c) / wdt) ** 2)
    base = 10.0 ** (envelope - 3.0)

    t_fac = (temps[:, None, None, None] / 1000.0) ** 0.3
    p_fac = (press[None, :, None, None] / 1e6) ** 0.15
    y_spread = 10.0 ** (4.0 * (y[None, None, None, :] - 0.5))
    kpoints = np.ascontiguousarray(
        base[None, None, :, None] * t_fac * p_fac * y_spread, dtype)

    sigma_ray = 8.49e-45 / centers ** 4
    scat = np.broadcast_to(sigma_ray[None, None, :],
                           (ntemp, npress, nbin)).astype(dtype)
    mmm = np.full((ntemp, npress), 2.3 * AMU, dtype)
    return dict(kpoints=kpoints, temperatures=temps.astype(dtype),
                pressures=press.astype(dtype),
                wave_centers=centers.astype(dtype),
                wave_edges=edges.astype(dtype),
                delta_wave=dwave.astype(dtype), gauss_y=y.astype(dtype),
                scat_cross=np.ascontiguousarray(scat), meanmolmass=mmm)


def make_table(spec: dict) -> dict:
    """The table a configuration file's ``table`` entry describes: the
    generator's arguments, and ``kpoints_scale`` applied to kpoints."""
    args = {k: v for k, v in spec.items() if k != "kpoints_scale"}
    t = synthetic_premixed_table(**args)
    t["kpoints"] *= float(spec.get("kpoints_scale", 1.0))
    return t

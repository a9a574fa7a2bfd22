"""Opacity table loading (reference HDF5 format) and synthetic tables.

File-format contract follows the reference loader (source/read.py:1040-1103):
datasets ``kpoints``/``opacities``, ``weighted Rayleigh cross-sections``,
``meanmolmass``, ``center wavelengths``/``wavelengths``, ``ypoints``,
``interface wavelengths``, ``wavelength width of bins``, ``temperatures``,
``pressures``.  The flat ``kpoints`` layout is ``[T, P, lambda, y]``
row-major (kernels.cu:563-567); we reshape into a dense 4-D array
immediately -- the TPU data model keeps it dense.

The synthetic generator provides physically-plausible tables for testing and
benchmarking in environments without the Zenodo input data (this framework's
test strategy; the reference ships none either, SURVEY.md section 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from helios_tpu_torch import constants as pc


@dataclass
class OpacityTable:
    """Premixed (or per-species) opacity table on a (T, P) grid."""
    kpoints: np.ndarray            # [ntemp, npress, nbin, ny] [cm^2/g]
    temperatures: np.ndarray       # [ntemp] [K]
    pressures: np.ndarray          # [npress] [cgs = 1e-6 bar]
    wave_centers: np.ndarray       # [nbin] [cm]
    wave_edges: np.ndarray         # [nbin+1] [cm]
    delta_wave: np.ndarray         # [nbin] [cm]
    gauss_y: np.ndarray            # [ny]
    scat_cross: Optional[np.ndarray] = None    # [ntemp, npress, nbin] [cm^2]
    meanmolmass: Optional[np.ndarray] = None   # [ntemp, npress] [g]

    @property
    def nbin(self):
        return len(self.wave_centers)

    @property
    def ny(self):
        return len(self.gauss_y)


def _edges_from_centers(centers: np.ndarray) -> np.ndarray:
    """Reference fallback construction (read.py:1080-1085)."""
    edges = np.empty(len(centers) + 1)
    edges[0] = centers[0] - (centers[1] - centers[0]) / 2
    edges[1:-1] = 0.5 * (centers[1:] + centers[:-1])
    edges[-1] = centers[-1] + (centers[-1] - centers[-2]) / 2
    return edges


def load_opacity_file(path: str, *, premixed: bool = True,
                      dtype=np.float64) -> OpacityTable:
    """Load a reference-format opacity HDF5 file into dense arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        if "kpoints" in f:
            k_flat = np.asarray(f["kpoints"][:], dtype)
        else:
            k_flat = np.asarray(f["opacities"][:], dtype)

        if "center wavelengths" in f:
            wave = np.asarray(f["center wavelengths"][:], dtype)
        else:
            wave = np.asarray(f["wavelengths"][:], dtype)

        if "ypoints" in f:
            gauss_y = np.asarray(f["ypoints"][:], dtype)
        else:
            gauss_y = np.zeros(1, dtype)

        if "interface wavelengths" in f:
            edges = np.asarray(f["interface wavelengths"][:], dtype)
        else:
            edges = _edges_from_centers(wave)

        if "wavelength width of bins" in f:
            dwave = np.asarray(f["wavelength width of bins"][:], dtype)
        else:
            dwave = np.diff(edges)

        temps = np.asarray(f["temperatures"][:], dtype)
        press = np.asarray(f["pressures"][:], dtype)

        scat = mmm = None
        if premixed:
            scat = np.asarray(f["weighted Rayleigh cross-sections"][:], dtype)
            mmm = np.asarray(f["meanmolmass"][:], dtype) * pc.AMU

    ntemp, npress, nbin, ny = len(temps), len(press), len(wave), len(gauss_y)
    kpoints = k_flat.reshape(ntemp, npress, nbin, ny)
    if scat is not None:
        scat = scat.reshape(ntemp, npress, nbin)
    if mmm is not None:
        mmm = mmm.reshape(ntemp, npress)

    return OpacityTable(kpoints=kpoints, temperatures=temps, pressures=press,
                        wave_centers=wave, wave_edges=edges, delta_wave=dwave,
                        gauss_y=gauss_y, scat_cross=scat, meanmolmass=mmm)


def save_opacity_file(path: str, table: OpacityTable,
                      premixed: bool = True) -> None:
    """Write an OpacityTable in the reference HDF5 format."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("kpoints", data=table.kpoints.ravel())
        f.create_dataset("center wavelengths", data=table.wave_centers)
        f.create_dataset("interface wavelengths", data=table.wave_edges)
        f.create_dataset("wavelength width of bins", data=table.delta_wave)
        f.create_dataset("ypoints", data=table.gauss_y)
        f.create_dataset("temperatures", data=table.temperatures)
        f.create_dataset("pressures", data=table.pressures)
        if premixed:
            f.create_dataset("weighted Rayleigh cross-sections",
                             data=table.scat_cross.ravel())
            f.create_dataset("meanmolmass",
                             data=(table.meanmolmass / pc.AMU).ravel())


def gauss_legendre_ypoints(ny: int):
    """Shifted Gauss-Legendre nodes/weights on [0, 1] (the k-distribution
    y grid; reference ktable build_individual_opacities.py:221-223 and
    host_functions.py:222)."""
    x, w = np.polynomial.legendre.leggauss(ny)
    return 0.5 * (x + 1.0), w


def synthetic_premixed_table(nbin: int = 385, ny: int = 20,
                             ntemp: int = 60, npress: int = 31,
                             lambda_min: float = 0.245e-4,
                             lambda_max: float = 500e-4,
                             seed: int = 0,
                             dtype=np.float64) -> OpacityTable:
    """Physically-plausible premixed table for tests and benchmarks.

    Smooth in T and log P (so interpolation tests are meaningful), with
    molecular-band-like wavelength structure and a k-distribution-like
    monotone spread over y, plus H2-like Rayleigh scattering and a
    2.3-amu mean molecular mass.
    """
    rng = np.random.default_rng(seed)

    # R=50-style log-spaced wavelength grid (reference default table)
    edges = np.geomspace(lambda_min, lambda_max, nbin + 1)
    centers = 0.5 * (edges[1:] + edges[:-1])
    dwave = np.diff(edges)

    temps = np.linspace(50.0, 6000.0, ntemp)
    press = np.logspace(0.0, 10.0, npress)      # 1e0..1e10 cgs

    y, _ = gauss_legendre_ypoints(ny)

    # wavelength envelope: a few broad "bands" in log-lambda
    loglam = np.log10(centers)
    envelope = np.zeros(nbin)
    for _ in range(8):
        c = rng.uniform(loglam.min(), loglam.max())
        wdt = rng.uniform(0.05, 0.4)
        amp = rng.uniform(0.5, 3.0)
        envelope += amp * np.exp(-0.5 * ((loglam - c) / wdt) ** 2)
    base = 10.0 ** (envelope - 3.0)             # ~1e-3..1 cm^2/g scale

    # temperature/pressure dependence: opacity grows with P, varies with T
    t_fac = (temps[:, None, None, None] / 1000.0) ** 0.3
    p_fac = (press[None, :, None, None] / 1e6) ** 0.15
    # y spread: k-distribution within a bin spans ~4 orders of magnitude
    y_spread = 10.0 ** (4.0 * (y[None, None, None, :] - 0.5))

    kpoints = (base[None, None, :, None] * t_fac * p_fac * y_spread)
    kpoints = np.ascontiguousarray(kpoints, dtype)

    # H2 Rayleigh-like cross section per molecule ~ lambda^-4
    sigma_ray = 8.49e-45 / centers ** 4          # [cm^2], H2-like magnitude
    scat = np.broadcast_to(sigma_ray[None, None, :],
                           (ntemp, npress, nbin)).astype(dtype)

    mmm = np.full((ntemp, npress), 2.3 * pc.AMU, dtype)

    return OpacityTable(kpoints=kpoints, temperatures=temps.astype(dtype),
                        pressures=press.astype(dtype),
                        wave_centers=centers.astype(dtype),
                        wave_edges=edges.astype(dtype),
                        delta_wave=dwave.astype(dtype),
                        gauss_y=y.astype(dtype),
                        scat_cross=np.ascontiguousarray(scat),
                        meanmolmass=mmm)

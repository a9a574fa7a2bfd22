"""ktable stage 2: combine per-species tables into the premixed table.

Parity with reference ktable/source_ktable/combination.py: interpolate each
species onto the hard-coded final (T, P) grid, weight by mass mixing ratio
(constant or FastChem), accumulate, add Rayleigh cross-sections and the
H-/He- continuum pseudo-species, and write mixed_opac_kdistr.h5 in the
reference format.

The (T, log P) bilinear interpolation -- the stage's hot loop, numba-jit in
the reference (combination.py:189-281) -- is a vectorized numpy expression
here, with a C++ variant in helios_tpu_torch/ktable/native.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from helios_tpu_torch import constants as pc
from helios_tpu_torch import species as sdb
from helios_tpu_torch.ktable import continuous, rayleigh


def final_pt_grid():
    """The hard-coded final grid: T = 50..6000 step 50; P = 1e0..1e10 in
    thirds of a decade (combination.py:857-869)."""
    temps = np.arange(50, 6050, 50).astype(float)
    p1 = 10.0 ** np.arange(0, 10, 1.0)
    p2 = 10.0 ** np.arange(0.33333333, 9.33333334, 1.0)
    p3 = 10.0 ** np.arange(0.66666666, 9.66666667, 1.0)
    press = np.sort(np.concatenate([p1, p2, p3]))
    return temps, press


def interpolate_tp_grid(values, temp_old, press_old, temp_new, press_new,
                        use_native: bool = True):
    """Edge-clamped bilinear interpolation in (T, log10 P) of a
    [nt_old, np_old, ...] array onto (temp_new, press_new)
    (combination.py:189-281 semantics, vectorized): the native library
    (raising when it does not build), or with ``use_native=False`` the
    numpy version below.

    Returns [nt_new, np_new, ...]."""
    if use_native:
        from helios_tpu_torch.ktable.native import bilinear_tp_native
        return bilinear_tp_native(values, temp_old, press_old, temp_new,
                                  press_new)

    temp_old = np.asarray(temp_old, float)
    press_old = np.asarray(press_old, float)
    logp_old = np.log10(press_old)
    logp_new = np.log10(np.asarray(press_new, float))

    ti = np.clip(np.searchsorted(temp_old, temp_new, side="right") - 1,
                 0, len(temp_old) - 1)
    pi = np.clip(np.searchsorted(press_old, press_new, side="right") - 1,
                 0, len(press_old) - 1)

    t_hi = np.minimum(ti + 1, len(temp_old) - 1)
    p_hi = np.minimum(pi + 1, len(press_old) - 1)

    wt = np.where(t_hi > ti,
                  (np.asarray(temp_new) - temp_old[ti])
                  / np.where(t_hi > ti, temp_old[t_hi] - temp_old[ti], 1.0),
                  0.0)
    wt = np.where(np.asarray(temp_new) < temp_old[0], 0.0, wt)
    wp = np.where(p_hi > pi,
                  (logp_new - logp_old[pi])
                  / np.where(p_hi > pi, logp_old[p_hi] - logp_old[pi], 1.0),
                  0.0)
    wp = np.where(np.asarray(press_new) < press_old[0], 0.0, wp)

    v = np.asarray(values)
    extra = (1,) * (v.ndim - 2)
    wt_b = wt[:, None].reshape(len(wt), 1, *extra)
    wp_b = wp[None, :].reshape(1, len(wp), *extra)

    v00 = v[np.ix_(ti, pi)]
    v01 = v[np.ix_(ti, p_hi)]
    v10 = v[np.ix_(t_hi, pi)]
    v11 = v[np.ix_(t_hi, p_hi)]
    return (v00 * (1 - wt_b) * (1 - wp_b) + v01 * (1 - wt_b) * wp_b
            + v10 * wt_b * (1 - wp_b) + v11 * wt_b * wp_b)


@dataclass
class MixSpecies:
    """One row of the final-species file (combination.py:790-855)."""
    name: str
    absorbing: bool
    scattering: bool
    mixing_ratio: str       # number, "x&y", or "FastChem"
    weight: float = None
    fc_name: str = None

    def __post_init__(self):
        if self.weight is not None:
            return          # explicit weight: tabulated pseudo-species
        info = sdb.SPECIES.get(self.name)
        if info is None:
            raise IOError(f"Species {self.name!r} not in the database.")
        self.weight = info.weight
        self.fc_name = info.fc_name


def parse_final_species_file(path: str) -> List[MixSpecies]:
    out = []
    with open(path) as f:
        next(f)
        next(f)
        for line in f:
            col = line.split()
            if col:
                out.append(MixSpecies(col[0], col[1] == "yes",
                                      col[2] == "yes", col[3]))
    # first species must absorb (combination.py:815-827)
    for i, s in enumerate(out):
        if s.absorbing:
            out.insert(0, out.pop(i))
            break
    else:
        raise IOError("At least one species needs to be absorbing.")
    return out


@dataclass
class Combiner:
    """Stage-2 state (reference Comb class)."""
    individual_dir: str
    final_dir: str
    format: str = "k-distribution"
    fastchem_dir: Optional[str] = None
    use_native: bool = True                # the native bilinear regrid

    # filled during combine
    k_x: np.ndarray = None
    k_i: np.ndarray = None
    k_w: np.ndarray = None
    k_y: np.ndarray = None
    nx: int = 0
    ny: int = 1
    final_temp: np.ndarray = None
    final_press: np.ndarray = None
    mu: np.ndarray = None                  # [nt, np] molar weight
    combined_opacities: np.ndarray = None  # [nt, np, nx, ny]
    combined_cross_sections: np.ndarray = None  # [nt, np, nx]
    molname_list: List[bytes] = field(default_factory=list)
    _fastchem: object = None

    def read_individual(self, name: str):
        import h5py
        if self.format == "k-distribution":
            path = os.path.join(self.individual_dir,
                                f"{name}_opac_kdistr.h5")
            with h5py.File(path) as f:
                self.k_y = np.asarray(f["ypoints"][:])
                self.k_x = np.asarray(f["center wavelengths"][:])
                self.k_w = np.asarray(f["wavelength width of bins"][:])
                self.k_i = np.asarray(f["interface wavelengths"][:])
                temps = np.asarray(f["temperatures"][:], float)
                press = np.asarray(f["pressures"][:], float)
                k = np.asarray(f["kpoints"][:])
            self.nx, self.ny = len(self.k_x), len(self.k_y)
        else:
            path = os.path.join(self.individual_dir,
                                f"{name}_opac_sampling.h5")
            with h5py.File(path) as f:
                self.k_x = np.asarray(f["wavelengths"][:])
                temps = np.asarray(f["temperatures"][:], float)
                press = np.asarray(f["pressures"][:], float)
                k = np.asarray(f["opacities"][:])
            self.nx, self.ny = len(self.k_x), 1
        self.molname_list.append(name.encode("utf8"))
        k = k.reshape(len(temps), len(press), self.nx, self.ny)
        return temps, press, k

    # ------------------------------------------------------------------ #
    def load_fastchem(self):
        from helios_tpu_torch.chem import load_fastchem_table
        data, temps, press = load_fastchem_table(self.fastchem_dir)
        self._fastchem = (data, temps, press)
        mu = np.asarray(data["mu"], float).reshape(len(temps), len(press))
        self.mu = interpolate_tp_grid(mu, temps, press, self.final_temp,
                                      self.final_press, self.use_native)

    def fastchem_vmr(self, fc_name: str):
        data, temps, press = self._fastchem
        col = np.asarray(data[fc_name], float).reshape(len(temps),
                                                       len(press))
        return interpolate_tp_grid(col, temps, press, self.final_temp,
                                   self.final_press, self.use_native)

    def species_vmrs(self, spec: MixSpecies):
        """(vmr, vmr2) on the final grid (combination.py:922-961)."""
        nt, npf = len(self.final_temp), len(self.final_press)
        ones = np.ones((nt, npf))
        two = ("CIA" in spec.name) or spec.name in ("H-_ff", "He-")
        if spec.mixing_ratio == "FastChem":
            if two:
                n1, n2 = spec.fc_name.split("&")
                return self.fastchem_vmr(n1), self.fastchem_vmr(n2)
            return self.fastchem_vmr(spec.fc_name), ones
        if two:
            a, b = spec.mixing_ratio.split("&")
            return float(a) * ones, float(b) * ones
        return float(spec.mixing_ratio) * ones, ones

    # ------------------------------------------------------------------ #
    def continuum_opacity(self, name: str):
        """H-_bf / H-_ff / He- opacities on the final grid
        (combination.py:676-788).  Returns [nt, np, nx, ny]."""
        nt, npf = len(self.final_temp), len(self.final_press)
        lam = self.k_x
        if name == "H-_bf":
            per_x = (continuous.h_min_bf_cross_sect(lam)
                     / (sdb.SPECIES["H"].weight * pc.AMU))
            out = np.broadcast_to(per_x[None, None, :, None],
                                  (nt, npf, self.nx, self.ny))
        elif name == "H-_ff":
            sig = continuous.h_min_ff_cross_sect(
                lam[None, None, :], self.final_temp[:, None, None],
                self.final_press[None, :, None])
            sig = sig / (sdb.SPECIES["H"].weight * pc.AMU)
            out = np.broadcast_to(sig[..., None],
                                  (nt, npf, self.nx, self.ny))
        elif name == "He-":
            logk = continuous.he_min_log_k(
                self.final_temp[:, None], np.log10(lam * 1e4)[None, :])
            k = 10.0 ** logk                                   # [nt, nx]
            sig = (k[:, None, :] * self.final_press[None, :, None]
                   / (sdb.SPECIES["He"].weight * pc.AMU))
            out = np.broadcast_to(sig[..., None],
                                  (nt, npf, self.nx, self.ny))
        else:
            raise KeyError(name)
        self.molname_list.append(name.encode("utf8"))
        return np.ascontiguousarray(out)

    def rayleigh_cross_section(self, spec: MixSpecies, vmr):
        """Per-species Rayleigh accumulation + scat file
        (combination.py:514-649)."""
        import h5py
        if spec.name not in rayleigh.IMPLEMENTED:
            print(f"WARNING: no Rayleigh cross sections for {spec.name}; "
                  "continuing without.")
            return
        if spec.name == "H2O":
            # P-T-dependent; not pre-tabulated
            sig = np.empty((len(self.final_temp), len(self.final_press),
                            self.nx))
            for t, T in enumerate(self.final_temp):
                for p, P in enumerate(self.final_press):
                    sig[t, p] = rayleigh.species_cross_section(
                        "H2O", self.k_x, press=P, temp=T,
                        f_h2o=vmr[t, p])
            self.combined_cross_sections += vmr[:, :, None] * sig
            return
        sig = rayleigh.species_cross_section(spec.name, self.k_x)
        path = os.path.join(self.individual_dir, "scat_cross_sections.h5")
        with h5py.File(path, "a") as f:
            if "wavelengths" not in f:
                f.create_dataset("wavelengths", data=self.k_x)
            key = "rayleigh_" + spec.name
            if key not in f:
                f.create_dataset(key, data=sig)
        self.combined_cross_sections += vmr[:, :, None] * sig[None, None, :]

    # ------------------------------------------------------------------ #
    def add_one_species(self, spec: MixSpecies, first: bool):
        """combination.py:885-987."""
        interpol = None
        if spec.absorbing:
            if spec.name not in ("H-_bf", "H-_ff", "He-"):
                temps, press, k = self.read_individual(spec.name)
                interpol = interpolate_tp_grid(
                    np.moveaxis(k, [0, 1], [0, 1]), temps, press,
                    self.final_temp, self.final_press, self.use_native)
                self._write_interpolated(spec.name, interpol)
            else:
                interpol = self.continuum_opacity(spec.name)

        if first:
            nt, npf = len(self.final_temp), len(self.final_press)
            self.combined_opacities = np.zeros((nt, npf, self.nx, self.ny))
            self.combined_cross_sections = np.zeros((nt, npf, self.nx))

        vmr, vmr2 = self.species_vmrs(spec)

        if spec.absorbing:
            mass_mix = vmr * vmr2 * spec.weight / self.mu
            self.combined_opacities += mass_mix[:, :, None, None] * interpol

        if spec.scattering:
            self.rayleigh_cross_section(spec, vmr)

    def _write_interpolated(self, name, interpol):
        import h5py
        ending = ("_opac_ip_kdistr.h5" if self.format == "k-distribution"
                  else "_opac_ip_sampling.h5")
        path = os.path.join(self.individual_dir, name + ending)
        if os.path.exists(path):
            return
        with h5py.File(path, "w") as f:
            f.create_dataset("pressures", data=self.final_press)
            f.create_dataset("temperatures", data=self.final_temp)
            if self.format == "k-distribution":
                f.create_dataset("interface wavelengths", data=self.k_i)
                f.create_dataset("center wavelengths", data=self.k_x)
                f.create_dataset("wavelength width of bins", data=self.k_w)
                f.create_dataset("ypoints", data=self.k_y)
                f.create_dataset("kpoints", data=interpol.ravel())
            else:
                f.create_dataset("wavelengths", data=self.k_x)
                f.create_dataset("opacities", data=interpol.ravel())

    # ------------------------------------------------------------------ #
    def combine_all(self, species_list: List[MixSpecies],
                    units: str = "CGS"):
        """combination.py:989-1010."""
        self.final_temp, self.final_press = final_pt_grid()

        # constant-VMR mean molecular weight; overwritten by FastChem mu
        mu, tot = 0.0, 0.0
        for s in species_list:
            try:
                v = float(s.mixing_ratio)
            except ValueError:
                continue
            mu += v * s.weight
            tot += v
        if tot > 0:
            self.mu = np.full((len(self.final_temp),
                               len(self.final_press)), mu / tot)

        if any(s.mixing_ratio == "FastChem" for s in species_list):
            self.load_fastchem()

        for i, s in enumerate(species_list):
            print(f"Including --> {s.name} <--")
            self.add_one_species(s, first=(i == 0))

        self.write_mixed_file(units)

    def write_mixed_file(self, units: str = "CGS"):
        """combination.py:455-496; units "CGS" or "MKS"
        (combination.py:470-479)."""
        import h5py
        if units not in ("CGS", "MKS"):
            raise ValueError(
                "Chosen units for the opacity table unknown. Please "
                "double-check entry in the parameter file.")
        press, opac = self.final_press, self.combined_opacities.ravel()
        scat, k_x = self.combined_cross_sections.ravel(), self.k_x
        k_i, k_w = self.k_i, self.k_w
        if units == "MKS":
            press = np.asarray(press) * 1e-1
            opac = opac * 1e-1
            scat = scat * 1e-4
            k_x = np.asarray(k_x) * 1e-2
            if self.format == "k-distribution":
                k_i = np.asarray(k_i) * 1e-2
                k_w = np.asarray(k_w) * 1e-2
        os.makedirs(self.final_dir, exist_ok=True)
        fn = ("mixed_opac_kdistr.h5" if self.format == "k-distribution"
              else "mixed_opac_sampling.h5")
        with h5py.File(os.path.join(self.final_dir, fn), "w") as f:
            f.create_dataset("pressures", data=press)
            f.create_dataset("temperatures", data=self.final_temp)
            f.create_dataset("meanmolmass", data=self.mu.ravel())
            f.create_dataset("kpoints", data=opac)
            f.create_dataset("weighted Rayleigh cross-sections", data=scat)
            f.create_dataset("included molecules", data=self.molname_list)
            f.create_dataset("wavelengths", data=k_x)
            f.create_dataset("units", data=units)
            if self.format == "k-distribution":
                f.create_dataset("center wavelengths", data=k_x)
                f.create_dataset("interface wavelengths", data=k_i)
                f.create_dataset("wavelength width of bins", data=k_w)
                f.create_dataset("ypoints", data=self.k_y)

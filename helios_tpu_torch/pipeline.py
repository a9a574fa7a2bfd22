"""The end-to-end RCE run (port of the core of :func:`helios_tpu.pipeline.run`,
the run_helios equivalent, helios.py:35-137): config -> model -> radiation
loop -> convection loop.

Covered: the un-monitored, un-sharded premixed path of an iterative
(non-isothermal) run, started from the grid's initial profile or from a
"helios"-format TP file.  Output files, monitoring, checkpoints, meshes, clouds, real-gas
thermodynamics (kappa from a file), stellar spectra from files, extra
heating and physical timestepping raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from helios_tpu_torch import grid as grid_mod
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.device import resolve_device, torch_dtype
from helios_tpu_torch.forward import (FluxState, ModelArrays, Phys,
                                      build_model)
from helios_tpu_torch.io.opacity import OpacityTable, load_opacity_file
from helios_tpu_torch.ops.integrate import FluxTotals
from helios_tpu_torch.rce.loop import ConvLoopState, convection_loop
from helios_tpu_torch.rce.radiative import (RadLoopState, ThermoProps,
                                            make_const_thermo,
                                            radiation_loop)


def initial_temperatures(cfg: HeliosConfig, phys: Phys) -> np.ndarray:
    """Initial TP profile: isothermal at T_eff (host_functions.py:164-184)
    or a restart from a TP file (read.py:1274-1322)."""
    if cfg.singlewalk or cfg.force_start_tp_from_file:
        return load_tp_file(cfg.temp_path, cfg.temp_format, phys.nlayer)
    return grid_mod.initial_temperature(
        phys.nlayer, f_factor=phys.f_factor, dir_beam=phys.dir_beam,
        mu_star=phys.mu_star, R_star=phys.R_star, a=phys.a,
        T_star=phys.T_star)


def load_tp_file(path: str, fmt: str, nlayer: int) -> np.ndarray:
    """Read a TP restart file in the "helios" format: the reference's
    *_tp.dat layout, BOA row then layers, temperature in column 1
    (read.py:1274-1322, write.py:128-145).  Returns [nlayer+1] with the
    surface/BOA ghost at index nlayer.  The "TP"/"PT" formats are not
    ported."""
    if fmt != "helios":
        raise NotImplementedError(f"temp_format={fmt!r} is not ported")
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    T_surf = float(lines[2][1])
    T = np.asarray([float(ln[1]) for ln in lines[3:]])
    if len(T) != nlayer:
        raise ValueError(
            f"restart file has {len(T)} layers, expected {nlayer}")
    return np.concatenate([T, [T_surf]])


def make_thermo(cfg: HeliosConfig) -> Optional[ThermoProps]:
    """kappa/c_p source (read.py:1105-1193): a constant kappa.  The
    "file"/"water_atmo" table modes are not ported."""
    if isinstance(cfg.kappa_value, str):
        raise NotImplementedError(
            f"kappa_value={cfg.kappa_value!r} (tabulated thermodynamics) is "
            "not ported")
    if cfg.convection:
        return make_const_thermo(float(cfg.kappa_value))
    return None


def _check_run_supported(cfg: HeliosConfig, write_output: bool):
    missing = []
    if write_output:
        missing.append("write_output=True (output files)")
    if cfg.singlewalk:
        missing.append("run_type='post-processing'")
    if cfg.stellar_model != "blackbody":
        missing.append(f"stellar_model={cfg.stellar_model!r}")
    if isinstance(cfg.surf_albedo, str):
        missing.append("surf_albedo='file'")
    if cfg.add_heating:
        missing.append("additional heating")
    if cfg.physical_tstep != 0.0:
        missing.append("physical timestepping")
    if cfg.approx_f and cfg.planet_type == "rocky":
        missing.append("the Koll f-factor approximation")
    if int(cfg.n_spectral_shards) > 1 or int(cfg.n_planet_batch) > 1:
        missing.append("meshes (n_spectral_shards / n_planet_batch)")
    if (cfg.checkpoint_every > 0 or cfg.realtime_plot or cfg.metrics_file
            or cfg.profile_dir or cfg.progress or cfg.debug or cfg.coupling
            or cfg.coupl_tp_write_interval):
        missing.append("monitoring (checkpoints, plots, metrics, profiles, "
                       "progress, debug, coupling)")
    if missing:
        raise NotImplementedError(
            "not ported to helios_tpu_torch yet: " + ", ".join(missing))


@dataclass
class RunOutput:
    phys: Phys
    arrays: ModelArrays
    rad: RadLoopState
    conv: Optional[ConvLoopState]
    T_lay: torch.Tensor          # final temperatures [L+1]
    flux: FluxState              # final flux state
    totals: FluxTotals           # final integrated fluxes
    wall_seconds: float          # the whole run, model build included
    rad_seconds: float           # radiation loop
    conv_seconds: float          # convection loop (0 when not run)

    @property
    def n_flux_solves(self) -> int:
        """Flux solves run by both loops (one per loop iteration)."""
        return self.rad.it + (self.conv.steps if self.conv is not None
                              else 0)


def run(cfg: HeliosConfig, table: Optional[OpacityTable] = None, *,
        write_output: bool = False, device="cuda") -> RunOutput:
    """One RCE solve of one atmosphere: radiation loop, then the
    convection loop when convection is on.  ``device`` defaults to CUDA
    and raises without it; ``device="cpu"`` runs the plain versions of
    the kernels on the CPU.  The times end after the device has
    finished."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    if not cfg._finalized:
        cfg = cfg.finalize()
    _check_run_supported(cfg, write_output)
    if table is None:
        table = load_opacity_file(cfg.opacity_path)

    phys, arrays = build_model(cfg, table, device=dev)
    thermo = make_thermo(cfg)
    T0 = torch.as_tensor(initial_temperatures(cfg, phys),
                         dtype=torch_dtype(cfg.dtype), device=dev)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t_rad = clock()
    rad = radiation_loop(phys, arrays, thermo, T0)
    t_conv = clock()
    conv = None
    final = rad
    if phys.convection:
        conv = convection_loop(phys, arrays, thermo, rad)
        final = conv
    t_end = clock()
    return RunOutput(phys=phys, arrays=arrays, rad=rad, conv=conv,
                     T_lay=final.T_lay, flux=final.flux,
                     totals=final.totals, wall_seconds=t_end - t0,
                     rad_seconds=t_conv - t_rad, conv_seconds=t_end - t_conv)

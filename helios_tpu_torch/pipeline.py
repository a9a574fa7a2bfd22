"""The end-to-end run (port of the core of :func:`helios_tpu.pipeline.run`,
the run_helios equivalent, helios.py:35-137): config -> model -> radiation
loop -> convection loop -> diagnostics -> output files.

Covered: the single-planet run of ``helios_tpu``, on one device or on a
mesh of spectral slices: an
iterative run (isothermal or non-isothermal layers, the adaptive or a
physical timestep) and a post-processing run, with a premixed opacity table
or species mixed on the fly, with the iterative or the matrix flux method,
with or without cloud decks and the geometric zenith-angle correction, on a
gas planet, a rocky surface (the surface albedo a constant or from a file,
the Koll f-factor) or a bare rock, with or without additional heating, a
blackbody star or a stellar spectrum from an HDF5 file, a constant kappa
or real-gas thermodynamics from a table ("file" / "water_atmo", with the
entropy and water-phase diagnostics), started from the grid's initial
profile, from a TP file ("helios", "TP" or "PT" format) or from a
checkpoint, with or without the output files, and with the monitored
runner (progress, metrics, realtime plots, debug checks, a profiler trace,
checkpoints, mid-run coupling TP writes) and coupling.  Planet ensembles
are :mod:`helios_tpu_torch.parallel.ensemble`: as in ``helios_tpu``, this
run ignores ``n_planet_batch`` and ``planet_ensemble_file`` (the command
line reads the latter).  With ``n_spectral_shards`` > 1 the loops run on
that many spectral slices (:mod:`helios_tpu_torch.parallel.sharding`), the
bin axis padded to a multiple of them, and post-processing runs on the
home device from the gathered fluxes without the padding.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from helios_tpu_torch import checkpoint as ckpt_mod
from helios_tpu_torch import chem
from helios_tpu_torch import clouds as clouds_mod
from helios_tpu_torch import fastpath as fp
from helios_tpu_torch import grid as grid_mod
from helios_tpu_torch import host_physics as hp
from helios_tpu_torch import monitor as monitor_mod
from helios_tpu_torch import planck as planck_mod
from helios_tpu_torch import thermo as thermo_mod
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.device import torch_dtype
from helios_tpu_torch.forward import (FluxState, ModelArrays, Phys,
                                      altitude_z, build_model, compute_cells,
                                      integrate_flux_flat)
from helios_tpu_torch.io import writers
from helios_tpu_torch.io.opacity import OpacityTable, load_opacity_file
from helios_tpu_torch.ops import integrate as int_ops
from helios_tpu_torch.ops import interp as interp_ops
from helios_tpu_torch.parallel import sharding as shd
from helios_tpu_torch.rce import convect
from helios_tpu_torch.rce.loop import ConvLoopState
from helios_tpu_torch.rce.radiative import (RadLoopState, ThermoProps,
                                            kappa_cp_lay, kappa_int,
                                            make_const_thermo,
                                            make_table_thermo)
from helios_tpu_torch.tracing import span


def initial_temperatures(cfg: HeliosConfig, phys: Phys,
                         m: ModelArrays) -> np.ndarray:
    """Initial TP profile: isothermal at T_eff (host_functions.py:164-184)
    or a restart from a TP file (read.py:1274-1322)."""
    if cfg.singlewalk or cfg.force_start_tp_from_file:
        return load_tp_file(cfg.temp_path, cfg.temp_format, phys.nlayer,
                            m.p_lay.cpu().numpy(), m.p_int.cpu().numpy())
    return grid_mod.initial_temperature(
        phys.nlayer, f_factor=phys.f_factor, dir_beam=phys.dir_beam,
        mu_star=phys.mu_star, R_star=phys.R_star, a=phys.a,
        T_star=phys.T_star)


def load_tp_file(path: str, fmt: str, nlayer: int, p_lay: np.ndarray,
                 p_int: np.ndarray) -> np.ndarray:
    """Read a TP restart file (read.py:1274-1322).

    "helios" format: the reference's *_tp.dat layout (BOA row then layers,
    temperature in column 1).  "TP"/"PT": two-column ASCII with pressure in
    [10^-6 bar], interpolated in log-P onto the model grid (clamped at the
    file's pressure range).

    Returns [nlayer+1] with the surface/BOA ghost at index nlayer.
    """
    if fmt == "helios":
        with open(path) as f:
            lines = [ln.split() for ln in f if ln.strip()]
        # row 2 = BOA (surface), rows 3.. = layers (write.py:128-145)
        T_surf = float(lines[2][1])
        T = np.asarray([float(ln[1]) for ln in lines[3:]])
        if len(T) != nlayer:
            raise ValueError(
                f"restart file has {len(T)} layers, expected {nlayer}")
        return np.concatenate([T, [T_surf]])

    if fmt not in ("PT", "TP"):
        raise ValueError(f"unknown TP format {fmt!r}")
    cols = np.loadtxt(path)
    if fmt == "PT":
        press, temp = cols[:, 0], cols[:, 1]
    else:
        temp, press = cols[:, 0], cols[:, 1]
    order = np.argsort(press)
    logp, temp = np.log10(press[order]), temp[order]
    T_lay = np.interp(np.log10(p_lay), logp, temp)
    T_surf = np.interp(np.log10(p_int[0]), logp, temp)
    return np.concatenate([T_lay, [T_surf]])


def make_thermo(cfg: HeliosConfig, *, device="cuda"
                ) -> Optional[ThermoProps]:
    """kappa/c_p/entropy source (read.py:1105-1193): a constant, or the
    "file"/"water_atmo" ASCII table modes of real-gas thermodynamics, with
    the table on ``device``.  The table is loaded whenever a file mode is
    selected, even for a post-processing run, because the entropy and
    phase diagnostics are interpolated from it at the end
    (computation.py:252-292)."""
    if (isinstance(cfg.kappa_value, str)
            and cfg.kappa_value in ("file", "water_atmo")):
        tbl = thermo_mod.load_entropy_table(cfg.kappa_file_path,
                                            cfg.kappa_value)
        return make_table_thermo(tbl, torch_dtype(cfg.dtype), device=device)
    if cfg.convection:
        return make_const_thermo(float(cfg.kappa_value))
    return None


def load_starflux(cfg: HeliosConfig, nbin: int) -> np.ndarray:
    """Stellar spectrum from the HDF5 file of ``stellar_model="file"``, or
    zeros for a blackbody (read.py:1195-1236)."""
    if cfg.stellar_model == "file":
        import h5py
        with h5py.File(cfg.stellar_path, "r") as f:
            starflux = np.asarray(f[cfg.stellar_dataset][:], float)
        if len(starflux) != nbin:
            raise OverflowError(
                "Stellar spectrum and opacity files have different "
                f"lengths ({len(starflux)} vs {nbin}).")
        return starflux
    if cfg.stellar_model == "blackbody":
        return np.zeros(nbin)
    raise IOError("Unknown stellar model. Please check your input.")


# --------------------------------------------------------------------------- #
# final-state diagnostics
# --------------------------------------------------------------------------- #

def post_process(phys: Phys, m: ModelArrays, T_lay, flux_state: FluxState,
                 sset=None):
    """Final-state diagnostics (computation.py:1176-1296): band-integrated
    optical depth/transmission, contribution function, mean opacities,
    beam flux.  Tensors stay on the model's device.  ``sset``: the species
    set of on-the-fly opacity mixing."""
    Y = phys.ny
    cube = lambda x: fp.flat_to_cube(x, Y)
    T_int = interp_ops.interface_temperatures(T_lay)
    cache = compute_cells(phys, m, T_lay, T_int, sset)
    totals = integrate_flux_flat(phys, m, flux_state, cache.F_dir)
    if phys.iso:
        cells = cache.cells_or_upper
        trans_full = cube(cells.trans)
        dtau_band, trans_band = int_ops.integrate_optdepth_transmission_iso(
            cube(cells.delta_tau_total), cube(cells.trans), m.gauss_weight)
    else:
        up, low = cache.cells_or_upper, cache.lower
        trans_full = cube(up.trans) * cube(low.trans)
        dtau_band, trans_band = (
            int_ops.integrate_optdepth_transmission_noniso(
                cube(up.delta_tau_total), cube(low.delta_tau_total),
                cube(up.trans), cube(low.trans), m.gauss_weight))

    planckband_lay = planck_mod.planckband_layers(
        m.planck_grid, T_lay, m.starflux, real_star=phys.real_star,
        dim=phys.plancktable_dim, step=phys.plancktable_step)
    trans_weight_band, contr_band = int_ops.contribution_function(
        trans_full, planckband_lay, m.gauss_weight, phys.epsi)

    means = int_ops.mean_opacities(
        cube(cache.opac_lay), m.cloud_abs_cross_lay, cache.meanmolmass_lay,
        planckband_lay, m.lambda_edges, m.delta_lambda, T_lay,
        m.gauss_weight, m.gauss_y, phys.T_star)

    return dict(cache=cache, totals=totals, dtau_band=dtau_band,
                trans_band=trans_band, trans_weight_band=trans_weight_band,
                contr_band=contr_band, means=means,
                planckband_lay=planckband_lay)


def collect_result(cfg: HeliosConfig, phys: Phys, m: ModelArrays, final_T,
                   post, *, conv_unstable=None, conv_layer=None,
                   F_smooth_sum=None, kappa_lay=None, c_p_lay=None,
                   entropy_lay=None, phase_number_lay=None,
                   relaxed=0, final_limit=None,
                   cloud_result=None) -> writers.RunResult:
    """Assemble the host-side RunResult snapshot: the device tensors are
    moved to numpy here, at the end of the run.  ``entropy_lay`` and
    ``phase_number_lay``: the diagnostics of a thermodynamics table (zeros
    and None without one).  ``cloud_result``: the run's cloud decks, whose
    fields the cloud files print."""
    L = phys.nlayer
    cache = post["cache"]
    totals = post["totals"]
    means = post["means"]
    delta_z, z_lay = altitude_z(phys, m, final_T, cache.meanmolmass_lay)
    planckband_int = (planck_mod.planckband_interfaces(
        m.planck_grid, interp_ops.interface_temperatures(final_T),
        dim=phys.plancktable_dim, step=phys.plancktable_step)
        if phys.iso == 0 else None)

    h = lambda x: None if x is None else x.detach().cpu().numpy()
    F_net = h(totals.F_net)
    r = writers.RunResult(
        name=cfg.name, output_dir=cfg.output_dir, nlayer=L, nbin=phys.nbin,
        iso=phys.iso, convection=phys.convection,
        singlewalk=phys.singlewalk, T_star=phys.T_star,
        R_planet=phys.R_planet, R_star=phys.R_star, F_intern=phys.F_intern,
        star_corr_factor=float(m.star_corr_factor),
        input_kappa_value=cfg.kappa_value,
        input_surf_albedo=cfg.surf_albedo,
        albedo_file_surface_name=cfg.albedo_surface_name,
        p_lay=h(m.p_lay), p_int=h(m.p_int),
        delta_colmass=h(m.delta_colmass), T_lay=h(final_T),
        z_lay=h(z_lay), delta_z_lay=h(delta_z),
        meanmolmass_lay=h(cache.meanmolmass_lay),
        c_p_lay=h(c_p_lay) if c_p_lay is not None else np.zeros(L),
        kappa_lay=h(kappa_lay) if kappa_lay is not None else np.zeros(L),
        entropy_lay=(h(entropy_lay) if entropy_lay is not None
                     else np.zeros(L)),
        phase_number_lay=h(phase_number_lay),
        conv_unstable=(h(conv_unstable).astype(int)
                       if conv_unstable is not None
                       else np.zeros(L + 1, int)),
        conv_layer=(h(conv_layer).astype(int) if conv_layer is not None
                    else np.zeros(L + 1, int)),
        opac_wave=h(m.lambda_centers), opac_interwave=h(m.lambda_edges),
        opac_deltawave=h(m.delta_lambda),
        F_down_tot=h(totals.F_down_tot), F_up_tot=h(totals.F_up_tot),
        F_net=F_net,
        F_dir_tot=h(int_ops.integrate_beamflux(totals.F_dir_band,
                                               m.delta_lambda)),
        F_net_diff=F_net[:L] - F_net[1:],
        F_add_heat_lay=h(cache.F_add_heat_lay),
        F_add_heat_sum=h(cache.F_add_heat_sum),
        F_smooth_sum=(h(F_smooth_sum) if F_smooth_sum is not None
                      else np.zeros(L)),
        F_down_band=h(totals.F_down_band), F_up_band=h(totals.F_up_band),
        F_dir_band=h(totals.F_dir_band),
        planckband_lay=h(post["planckband_lay"]),
        planckband_int=h(planckband_int),
        opac_band_lay=h(means["opac_band_lay"]),
        scat_cross_lay=h(cache.scat_cross_lay),
        g_0_tot_lay=(h(cache.cells_or_upper.g0).reshape(
            L, phys.nbin, phys.ny)[:, :, 0] if phys.clouds
            else np.full((L, phys.nbin), phys.g_0)),
        trans_band=h(post["trans_band"]),
        delta_tau_band=h(post["dtau_band"]),
        contr_func_band=h(post["contr_band"]),
        trans_weight_band=h(post["trans_weight_band"]),
        planck_opac_T_pl=h(means["planck_opac_T_pl"]),
        ross_opac_T_pl=h(means["ross_opac_T_pl"]),
        planck_opac_T_star=h(means["planck_opac_T_star"]),
        ross_opac_T_star=h(means["ross_opac_T_star"]),
        surf_albedo=h(m.surf_albedo),
        relaxed_criterion_trigger=relaxed,
        rad_convergence_limit=(float(final_limit) if final_limit is not None
                               else phys.rad_convergence_limit),
    )
    if cloud_result is not None:
        r.f_all_clouds_lay = cloud_result.f_lay
        r.abs_cross_all_clouds_lay = cloud_result.abs_cross_lay
        r.scat_cross_all_clouds_lay = cloud_result.scat_cross_lay
        r.delta_tau_all_clouds = (
            r.delta_colmass[:, None] * (cloud_result.abs_cross_lay
                                        + cloud_result.scat_cross_lay)
            / r.meanmolmass_lay[:, None])
    r.F_net_conv = writers.calculate_conv_flux(r)
    return r


def build_species_set_from_files(cfg: HeliosConfig, *, device="cuda"):
    """On-the-fly inputs from the configured file paths (helios.py:51-55):
    the species file, one opacity file per absorbing species, the Rayleigh
    cross sections, the VMR file and the FastChem tables.

    Returns (SpeciesSet on ``device``, donor OpacityTable carrying the
    spectral/T/P grids from the first absorbing species file)."""
    specs = chem.parse_species_file(cfg.species_path)

    donor = None
    opacity_tables = {}
    for spec in specs:
        if not spec.absorbing:
            continue
        for suffix in ("_opac_ip_kdistr.h5", "_opac_ip.h5",
                       "_opac_ip_sampling.h5"):
            path = os.path.join(cfg.species_opacity_dir,
                                spec.name + suffix)
            if os.path.exists(path):
                t = load_opacity_file(path, premixed=False)
                opacity_tables[spec.name] = t.kpoints
                if donor is None:
                    donor = t
                break
        else:
            raise IOError(f"No opacity file found for {spec.name} in "
                          f"{cfg.species_opacity_dir}")

    scat_tables = {}
    scat_path = os.path.join(cfg.species_opacity_dir,
                             "scat_cross_sections.h5")
    if os.path.exists(scat_path):
        import h5py
        with h5py.File(scat_path, "r") as f:
            for spec in specs:
                key = "rayleigh_" + spec.name
                if spec.scattering and spec.name != "H2O" and key in f:
                    scat_tables[spec.name] = np.asarray(f[key][:], float)

    vmr_table = vmr_press = None
    if any(s.source_for_vmr == "file" for s in specs):
        vmr_table = np.genfromtxt(cfg.vmr_file_path, names=True, dtype=None,
                                  skip_header=cfg.vmr_file_header_lines)
        vmr_press = np.asarray(vmr_table[cfg.vmr_file_press_name], float)
        if cfg.vmr_file_press_unit == "Pa":
            vmr_press = vmr_press * 10.0
        elif cfg.vmr_file_press_unit == "bar":
            vmr_press = vmr_press * 1e6

    g = grid_mod.build_grid(cfg.p_boa, cfg.p_toa, cfg.nlayer, cfg.g)
    sset = chem.build_species_set(
        specs, ktemps=donor.temperatures, kpress=donor.pressures,
        nbin=donor.nbin, ny=donor.ny, nlayer=cfg.nlayer,
        opacity_tables=opacity_tables, scat_tables=scat_tables,
        vmr_file_table=vmr_table, vmr_file_press=vmr_press,
        fastchem_dir=cfg.fastchem_dir, p_lay=g.p_lay, p_int=g.p_int,
        dtype=cfg.np_dtype, device=device)
    return sset, donor


def prepare_model(cfg: HeliosConfig, table: OpacityTable, *,
                  starflux: Optional[np.ndarray] = None, device="cuda"):
    """Input preprocessing and model assembly (helios.py:56-79): the Koll
    f-factor of a rocky planet, the stellar spectrum, the surface albedo,
    the cloud decks and the additional heating.  Returns (phys, arrays on
    ``device``, cloud_result or None).  ``starflux`` [B] is a stellar
    spectrum in memory in place of the file the config names (default:
    :func:`load_starflux`)."""
    if cfg.approx_f and cfg.planet_type == "rocky":
        # Koll (2021) f-factor, from the tau_lw of an earlier run's file
        # when there is one (helios.py:67-68)
        tau_lw = hp.read_tau_lw_from_file(cfg.output_dir, cfg.name)
        if tau_lw is None:
            tau_lw = cfg.tau_lw
        cfg = dataclasses.replace(cfg, tau_lw=tau_lw, f_factor=(
            hp.approx_f_from_formula(tau_lw=tau_lw, p_boa=cfg.p_boa,
                                     R_star=cfg.R_star, a=cfg.a,
                                     T_star=cfg.T_star)))

    if starflux is None:
        starflux = load_starflux(cfg, table.nbin)
    surf_albedo = hp.load_surf_albedo(cfg, table.wave_centers)
    cloud_result = None
    if cfg.clouds:
        g = grid_mod.build_grid(cfg.p_boa, cfg.p_toa, cfg.nlayer, cfg.g)
        cloud_result = clouds_mod.cloud_pre_processing(
            cfg, table.wave_centers, table.wave_edges, g.p_lay, g.p_int,
            cfg.iso)

    phys, arrays = build_model(cfg, table, starflux=starflux,
                               surf_albedo=surf_albedo,
                               cloud_result=cloud_result, device=device)
    if cfg.add_heating:
        heat = hp.load_additional_heating(cfg, arrays.p_lay.cpu().numpy())
        arrays = arrays._replace(add_heat_dens=torch.as_tensor(
            heat, dtype=arrays.p_lay.dtype, device=arrays.p_lay.device))
    return phys, arrays, cloud_result


# --------------------------------------------------------------------------- #
# the run
# --------------------------------------------------------------------------- #

@dataclass
class RunOutput:
    phys: Phys
    arrays: ModelArrays
    rad: RadLoopState
    conv: Optional[ConvLoopState]
    T_lay: torch.Tensor          # final temperatures [L+1]
    flux: FluxState              # final flux state
    totals: int_ops.FluxTotals   # final integrated fluxes
    result: writers.RunResult    # host snapshot of the final state
    wall_seconds: float          # the whole run, model build included
    rad_seconds: float           # radiation loop
    conv_seconds: float          # convection loop (0 when not run)
    rad_it0: int = 0             # where the radiation loop started
    #                              (a restored checkpoint's iteration)

    @property
    def n_flux_solves(self) -> int:
        """Flux solves made by this run (one per loop iteration; one in a
        post-processing run).  A run resumed from a checkpoint counts the
        iterations after the restore: the radiation loop's from
        ``rad_it0``, the convection loop's ``steps`` from its restore."""
        if self.phys.singlewalk:
            return 1
        return self.rad.it - self.rad_it0 + (
            self.conv.steps if self.conv is not None else 0)


def checkpoint_paths(cfg: HeliosConfig, default: str = "restart.ckpt.npz"):
    """(radiation, convection) checkpoint paths: ``cfg.checkpoint_path`` or
    ``<output_dir>/<name>/<default>``, and the same with ``_conv`` before
    the (possibly compound) extension, so that any path gives two distinct
    files."""
    path = cfg.checkpoint_path or os.path.join(cfg.output_dir, cfg.name,
                                               default)
    base, ext = os.path.splitext(path)
    if base.endswith(".ckpt"):
        base, ext = base[:-5], ".ckpt" + ext
    return path, base + "_conv" + ext


def monitored_chunk(cfg: HeliosConfig, coupl_interval: int) -> int:
    """Iterations per chunk of a monitored run: ``chunk_iters``, capped by
    the checkpoint, plot and coupling intervals, rounded down to the
    10-iteration cache-refresh cadence (at least 10), so that checkpoints
    land on refresh boundaries and a resume is bit for bit."""
    chunk = cfg.chunk_iters
    if cfg.checkpoint_every > 0:
        chunk = min(chunk, cfg.checkpoint_every)
    if cfg.realtime_plot:
        chunk = min(chunk, cfg.n_plot)
    if coupl_interval > 0:
        chunk = min(chunk, coupl_interval)
    return max(chunk // 10 * 10, 10)


def run(cfg: HeliosConfig, table: Optional[OpacityTable] = None, *,
        write_output: bool = True, sset=None,
        starflux: Optional[np.ndarray] = None,
        callbacks: Sequence[monitor_mod.Callback] = (),
        device="cuda") -> RunOutput:
    """One run of one atmosphere: the radiation loop (one flux solve in a
    post-processing run), then the convection loop when convection is on
    and the layers are non-isothermal, then the final-state diagnostics,
    and with ``write_output`` (the default, as in helios_tpu) the output
    files under ``cfg.output_dir/cfg.name`` (with ``approx_f`` also the
    tau_lw / tau_sw / f-factor file, with coupling the coupling TP and
    convergence files); pass ``write_output=False`` for no files.

    With on-the-fly opacity mixing, ``sset`` is the species set and
    ``table`` donates the grids; when neither is given both come from the
    config's files.  ``starflux`` is a stellar spectrum in memory in place
    of the config's file.  A monitored run (checkpoints, realtime plots,
    metrics, a profile, progress, debug or mid-run coupling TP writes)
    runs both loops in chunks with the callbacks between them, resumes
    from the checkpoint files when they exist, and gives the same final
    state as the unmonitored run; ``callbacks`` are extra chunk callbacks
    of both loops, called after the built-in ones (and make a run
    monitored).  ``device`` defaults to CUDA and raises without it;
    ``device="cpu"`` runs the plain versions of the kernels on the CPU.
    With ``n_spectral_shards`` = n > 1 the loops run on n spectral slices:
    on the first n visible CUDA devices for "cuda" (a RuntimeError when
    fewer are visible), all on the CPU for "cpu", or on a sequence of
    devices, one per slice (a device may repeat).
    The times end after the device has finished: the run is the span
    ``helios.run``, its phases ``helios.prepare``, ``helios.radiation``,
    ``helios.convection`` and ``helios.result`` (``tracing.span``)."""
    with span("helios.run") as whole:
        with span("helios.prepare"):
            if not cfg._finalized:
                cfg = cfg.finalize()
            n_spec = int(cfg.n_spectral_shards)
            dev = shd.home_device(device)
            if n_spec > 1:
                devs = shd.visible_devices(device, n_spec)
                if len(devs) < n_spec:
                    raise RuntimeError(
                        f"n_spectral_shards={n_spec} but only {len(devs)} "
                        "devices are visible")
            if (cfg.opacity_mixing == "on-the-fly" and sset is None
                    and table is None):
                sset, table = build_species_set_from_files(cfg, device=dev)
            if table is None:
                table = load_opacity_file(cfg.opacity_path)

            phys, arrays, cloud_result = prepare_model(
                cfg, table, starflux=starflux, device=dev)
            thermo = make_thermo(cfg, device=dev)
            T0 = torch.as_tensor(initial_temperatures(cfg, phys, arrays),
                                 dtype=torch_dtype(cfg.dtype), device=dev)

            # on a mesh the loops run on the padded model placed on the
            # slices; post-processing keeps the unpadded model
            mesh = (shd.make_mesh(1, n_spec, devs[:n_spec]) if n_spec > 1
                    else None)
            (phys_run, arrays_run, sset_run), (m_loop, sset_loop) = (
                shd.place_run(phys, arrays, sset, mesh))

            # a monitored run observes the loops between chunks (mid-run
            # coupling TP writes and the debug checks too); an unmonitored
            # run is one chunk
            coupl_interval = (int(cfg.coupl_tp_write_interval)
                              if cfg.coupling else 0)
            monitored = (cfg.checkpoint_every > 0 or cfg.realtime_plot
                         or cfg.metrics_file or cfg.profile_dir
                         or cfg.progress or phys.debug or coupl_interval > 0
                         or bool(callbacks)) and not phys.singlewalk
            convect_on = (phys.convection and not phys.singlewalk
                          and not phys.iso)

            conv = None
            rad_it0 = 0
            rad_cbs, conv_cbs = [], []
            rad_state0 = conv_state0 = None
            if monitored:
                obs = _observers(cfg, phys, arrays, coupl_interval)
                rad_cbs += obs
                conv_cbs += obs
                if cfg.checkpoint_every > 0:
                    path, conv_path = checkpoint_paths(cfg)
                    ckpt = ckpt_mod.load_rad_checkpoint(path)
                    if ckpt is not None:
                        rad_state0 = ckpt_mod.restore_rad_state(
                            phys_run, arrays_run, ckpt, sset_run)
                        rad_it0 = rad_state0.it
                    rad_cbs.append(ckpt_mod.CheckpointCallback(
                        path, cfg.checkpoint_every, phys_run))
                    if convect_on:
                        cckpt = ckpt_mod.load_conv_checkpoint(conv_path)
                        if (cckpt is not None
                                and ckpt_mod.checkpoint_phase(cckpt)
                                == "convection"):
                            conv_state0 = ckpt_mod.restore_conv_state(
                                phys_run, arrays_run, cckpt, sset_run)
                        conv_cbs.append(ckpt_mod.ConvCheckpointCallback(
                            conv_path, cfg.checkpoint_every, phys_run))
                rad_cbs += callbacks
                conv_cbs += callbacks
            chunk = (monitored_chunk(cfg, coupl_interval) if monitored
                     else None)
            settle(dev)
        with span("helios.radiation") as rad_span:
            rad = monitor_mod.run_radiation_chunked(
                phys_run, m_loop, thermo, T0, chunk_iters=chunk,
                sset=sset_loop, callbacks=rad_cbs, state0=rad_state0,
                profile_dir=cfg.profile_dir or None, mesh=mesh)
            settle(dev)
        with span("helios.convection") as conv_span:
            if convect_on:
                conv = monitor_mod.run_convection_chunked(
                    phys_run, m_loop, thermo, rad, chunk_iters=chunk,
                    sset=sset_loop, callbacks=conv_cbs, state0=conv_state0,
                    mesh=mesh)
            settle(dev)

        with span("helios.result"):
            final = conv if conv is not None else rad
            # the outputs carry the real bins only (padded bins had
            # delta_lambda 0)
            final = final._replace(flux=shd.strip_flux(
                final.flux, phys.nbin, phys.ny))
            result = final_result(cfg, phys, arrays, thermo, final, conv,
                                  cloud_result, sset)
            if write_output:
                _write_outputs(cfg, phys, result, final)

    return RunOutput(phys=phys, arrays=arrays, rad=rad, conv=conv,
                     T_lay=final.T_lay, flux=final.flux,
                     totals=final.totals, result=result,
                     wall_seconds=whole.seconds,
                     rad_seconds=rad_span.seconds,
                     conv_seconds=conv_span.seconds, rad_it0=rad_it0)


def settle(dev) -> None:
    """Wait for the work queued on ``dev`` (a CUDA device): a phase of a
    run ends with its device work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _write_outputs(cfg: HeliosConfig, phys: Phys, result, final) -> None:
    """The output files of one run: the result, the abort file, the
    coupling TP and convergence files, the tau_lw / tau_sw file."""
    writers.write_all(result)
    if final.aborted:
        writers.write_abort_file(result)
    if cfg.coupling:
        # coupling: TP write + cross-iteration convergence test
        # (helios.py:129-131)
        T_prev = None
        if cfg.coupling_speed_up and cfg.coupling_iter_nr > 0:
            T_prev = _read_coupling_tp(cfg, cfg.coupling_iter_nr - 1)
        result.coupling_speed_up = int(cfg.coupling_speed_up)
        result.coupling_iter_nr = int(cfg.coupling_iter_nr)
        result.coupling_full_output = int(cfg.coupling_full_output)
        writers.write_tp_for_coupling(result, T_previous=T_prev)
        _coupling_convergence(cfg, result)
    # tau_lw / tau_sw estimate for the Koll f approximation
    # (helios.py:133-134)
    if cfg.approx_f:
        tau_lw, tau_sw = hp.calc_tau_lw_sw(
            result.delta_tau_band, result.opac_wave,
            result.opac_deltawave, result.T_lay[phys.nlayer],
            phys.T_star)
        hp.write_tau_lw_sw_file(cfg.output_dir, cfg.name, tau_lw,
                                tau_sw, phys.f_factor)


def final_result(cfg: HeliosConfig, phys: Phys, arrays: ModelArrays,
                 thermo: Optional[ThermoProps], final, conv, cloud_result,
                 sset=None) -> writers.RunResult:
    """The end-of-run bookkeeping of one planet: the thermodynamics and
    entropy / water-phase diagnostics at the final T, the post-processing
    diagnostics and the RunResult.  ``final``: the last loop's state;
    ``conv``: the convection loop's, or None."""
    if thermo is not None:
        kappa_lay, c_p_lay = kappa_cp_lay(thermo, final.T_lay, arrays.p_lay)
        T_int = interp_ops.interface_temperatures(final.T_lay)
        conv_unstable = convect.conv_check(
            final.T_lay, arrays.p_lay, arrays.p_int, kappa_lay,
            kappa_int(thermo, T_int, arrays.p_int))
    else:
        kappa_lay = c_p_lay = conv_unstable = None

    # entropy / water-phase diagnostics from the thermodynamics table
    # (computation.py:252-292, entropy_interpol / phase_number_interpol)
    entropy_lay = phase_number_lay = None
    if thermo is not None and thermo.from_table:
        T_lay = final.T_lay[:phys.nlayer]
        entropy_lay = interp_ops.interpolate_entropy(
            thermo.entropy_table, thermo.temps, thermo.press, T_lay,
            arrays.p_lay)
        if thermo.has_phase:
            phase_number_lay = interp_ops.interpolate_phase_number(
                thermo.phase_table, thermo.temps, thermo.press, T_lay,
                arrays.p_lay)

    post = post_process(phys, arrays, final.T_lay, final.flux, sset)
    final_limit = final.local_limit
    return collect_result(
        cfg, phys, arrays, final.T_lay, post, conv_unstable=conv_unstable,
        conv_layer=conv.conv_layer if conv is not None else None,
        F_smooth_sum=final.F_smooth_sum, kappa_lay=kappa_lay,
        c_p_lay=c_p_lay, entropy_lay=entropy_lay,
        phase_number_lay=phase_number_lay,
        relaxed=int(final_limit > phys.rad_convergence_limit * 1.5),
        final_limit=final_limit, cloud_result=cloud_result)


def _observers(cfg: HeliosConfig, phys: Phys, arrays: ModelArrays,
               coupl_interval: int) -> list:
    """The observation callbacks of a monitored run (both loops)."""
    obs = []
    if cfg.progress:
        obs.append(monitor_mod.ProgressPrinter(phys.nlayer))
    if cfg.metrics_file:
        obs.append(monitor_mod.MetricsWriter(cfg.metrics_file))
    if cfg.realtime_plot:
        obs.append(monitor_mod.PlotCallback(phys, cfg.p_boa, cfg.p_toa))
    if phys.debug:
        obs.append(monitor_mod.DebugChecker())
    if coupl_interval > 0:
        obs.append(monitor_mod.CouplingTPWriter(
            _coupling_tp_path(cfg, cfg.coupling_iter_nr), phys.nlayer,
            arrays.p_lay.cpu().numpy(), arrays.p_int.cpu().numpy(),
            coupl_interval))
    return obs


def _coupling_tp_path(cfg: HeliosConfig, iter_nr: int) -> str:
    """Path of a coupling TP file (write.py:725-746 naming)."""
    name = cfg.name
    if cfg.coupling_full_output:
        base = name[:name.rfind("_") + 1]
        name = base + str(iter_nr)
    return os.path.join(cfg.output_dir, name,
                        f"{name}_tp_coupling_{iter_nr}.dat")


def _read_coupling_tp(cfg: HeliosConfig, iter_nr: int) -> np.ndarray:
    """The temperatures of a coupling TP file (BOA row first)."""
    T = []
    with open(_coupling_tp_path(cfg, iter_nr)) as f:
        next(f)
        for line in f:
            col = line.split()
            if len(col) > 1:
                T.append(float(col[1]))
    return np.asarray(T)


def _coupling_convergence(cfg: HeliosConfig, result) -> int:
    """Cross-iteration TP convergence (host_functions.py:962-1018): from
    coupling iteration 1 on, writes 1 to ``<name>_coupling_convergence.dat``
    when every temperature moved less than ``coupl_convergence_limit``
    (relative) from the previous iteration's file, else 0."""
    converged = 0
    if cfg.coupling_iter_nr > 0 and not cfg.singlewalk:
        prev = _read_coupling_tp(cfg, cfg.coupling_iter_nr - 1)
        cur = _read_coupling_tp(cfg, cfg.coupling_iter_nr)
        rel = np.abs(prev - cur) / cur
        converged = int(np.all(rel < cfg.coupl_convergence_limit))
        with open(os.path.join(
                result.out,
                f"{result.name}_coupling_convergence.dat"), "w") as f:
            f.write(str(converged))
    return converged

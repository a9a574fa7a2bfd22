"""The forward radiative-transfer model: T profile -> spectral fluxes
(port of :mod:`helios_tpu.forward`).

Per iteration of the reference's radiation loop (computation.py:856-888):
temperature interpolation -> Planck lookup -> opacity interpolation (from
the premixed table, or species mixed on the fly from a
:class:`helios_tpu_torch.chem.SpeciesSet`) -> half-layer cell quantities
-> altitude -> direct beam (with or without the geometric zenith-angle
correction) -> flux solve (iterative sweeps or the Thomas matrix method)
-> integration, with or without cloud decks, on a gas planet, a rocky
surface or a bare rock (``planet_type="no_atmosphere"``), with a blackbody
star or a stellar spectrum (``stellar_model="file"``).  Static physics
scalars live in :class:`Phys`; tensors in :class:`ModelArrays`, on the
device chosen in :func:`build_model`.

Every function here also takes a batch of P planets that share ``Phys``
(:func:`helios_tpu_torch.parallel.ensemble.stack_models`): the planet axis
sits after the layer axis, so temperatures are [L+1, P], spectral arrays
[L, P, S] and boundary rows [P, S], and each flux solve is one kernel
launch over the P*S columns.  The functions the loops call also take a
model split into spectral slices (:mod:`helios_tpu_torch.ops.slices`,
placed by :func:`helios_tpu_torch.parallel.sharding.place_model`): they
run once per slice, and the band->total sum runs on from slice to slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from helios_tpu_torch import chem
from helios_tpu_torch import constants as pc
from helios_tpu_torch import fastpath as fp
from helios_tpu_torch import grid as grid_mod
from helios_tpu_torch import planck as planck_mod
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.device import resolve_device, torch_dtype
from helios_tpu_torch.io.opacity import OpacityTable, gauss_legendre_ypoints
from helios_tpu_torch.kernels.integrate import BandTotals, band_integrate
from helios_tpu_torch.kernels.ordered import ordered_cumsum
from helios_tpu_torch.ops import integrate as int_ops
from helios_tpu_torch.ops import interp as interp_ops
from helios_tpu_torch.ops import thomas as thomas_ops
from helios_tpu_torch.ops.members import memberwise
from helios_tpu_torch.ops.slices import (Slices, count, devices, over_slices,
                                         take)
from helios_tpu_torch.ops import twostream as ts_ops


@dataclass(frozen=True)
class Phys:
    """Static physics configuration."""
    nlayer: int
    nbin: int
    ny: int
    iso: int
    scat: int
    scat_corr: int
    clouds: int
    dir_beam: int
    geom_zenith_corr: int
    singlewalk: int
    real_star: int
    energy_correction: int
    flux_calc_method: str          # "iteration" | "matrix"
    planet_type: str               # "gas" | "rocky" | "no_atmosphere"
    debug: int
    g: float
    R_planet: float
    R_star: float
    a: float
    T_star: float
    T_intern: float
    F_intern: float
    mu_star: float
    f_factor: float
    epsi: float
    epsi2: float
    g_0: float
    w_0_limit: float
    w_0_scat_limit: float
    delta_tau_limit: float
    i2s_transition: float
    plancktable_dim: int
    plancktable_step: int
    smooth: int
    adapt_interval: int
    foreplay: int
    physical_tstep: float
    convection: int
    no_atmo: int
    dtype: str
    rad_convergence_limit: float = 1e-8
    crit_relaxation_numbers: tuple = (10000, 20000)
    max_nr_iterations: int = 100000
    runtime_limit: float = 86400.0
    input_dampara: str = "automatic"
    opacity_mixing: str = "premixed"     # premixed | on-the-fly
    ro_method: int = 1                   # 1 = Random Overlap, 0 = corr-k

    @property
    def ninterface(self) -> int:
        return self.nlayer + 1

    @property
    def n_sweep_passes(self) -> int:
        """3*scat+1 during iteration, 1000*scat+1 in post-processing
        (reference computation.py:531-537)."""
        nscat_step = 1000 if self.singlewalk else 3
        return nscat_step * self.scat + 1

    @classmethod
    def from_config(cls, cfg: HeliosConfig, nbin: int, ny: int) -> "Phys":
        assert cfg._finalized, "call cfg.finalize() first"
        return cls(
            nlayer=int(cfg.nlayer), nbin=nbin, ny=ny, iso=int(cfg.iso),
            scat=int(cfg.scat), scat_corr=int(cfg.scat_corr),
            clouds=int(cfg.clouds), dir_beam=int(cfg.dir_beam),
            geom_zenith_corr=int(cfg.geom_zenith_corr),
            singlewalk=int(cfg.singlewalk), real_star=int(cfg.real_star),
            energy_correction=int(cfg.energy_correction),
            flux_calc_method=cfg.flux_calc_method,
            planet_type=cfg.planet_type, debug=int(cfg.debug),
            g=float(cfg.g), R_planet=float(cfg.R_planet),
            R_star=float(cfg.R_star), a=float(cfg.a),
            T_star=float(cfg.T_star), T_intern=float(cfg.T_intern),
            F_intern=float(cfg.F_intern), mu_star=float(cfg.mu_star),
            f_factor=float(cfg.f_factor), epsi=float(cfg.epsi),
            epsi2=float(cfg.epsi2), g_0=float(cfg.g_0),
            w_0_limit=float(cfg.w_0_limit),
            w_0_scat_limit=float(cfg.w_0_scat_limit),
            delta_tau_limit=float(cfg.delta_tau_limit),
            i2s_transition=float(cfg.i2s_transition),
            plancktable_dim=int(cfg.plancktable_dim),
            plancktable_step=int(cfg.plancktable_step),
            smooth=int(cfg.smooth), adapt_interval=int(cfg.adapt_interval),
            foreplay=int(cfg.foreplay),
            physical_tstep=float(cfg.physical_tstep),
            convection=int(cfg.convection), no_atmo=int(cfg.no_atmo),
            dtype=cfg.dtype,
            rad_convergence_limit=float(cfg.rad_convergence_limit),
            crit_relaxation_numbers=tuple(
                int(n) for n in cfg.crit_relaxation_numbers),
            max_nr_iterations=int(cfg.max_nr_iterations),
            runtime_limit=float(cfg.runtime_limit),
            input_dampara=(cfg.input_dampara
                           if isinstance(cfg.input_dampara, str)
                           else str(float(cfg.input_dampara))),
            opacity_mixing=cfg.opacity_mixing,
            ro_method=1 if cfg.k_mixing_method == "RO" else 0)


class ModelArrays(NamedTuple):
    """Static inputs of the forward model, as tensors on one device."""
    # vertical grid
    p_lay: torch.Tensor
    p_int: torch.Tensor
    delta_colmass: torch.Tensor
    delta_col_upper: torch.Tensor
    delta_col_lower: torch.Tensor
    # opacity table (flat spectral layout)
    ktable: torch.Tensor            # [ntemp, npress, S]
    scat_cross_table: torch.Tensor  # [ntemp, npress, B]
    meanmolmass_table: torch.Tensor  # [ntemp, npress]
    ktemps: torch.Tensor
    kpress: torch.Tensor
    # spectral grid
    lambda_centers: torch.Tensor
    lambda_edges: torch.Tensor
    delta_lambda: torch.Tensor
    gauss_y: torch.Tensor
    gauss_weight: torch.Tensor
    # radiation inputs
    planck_grid: torch.Tensor       # [dim+1, B]
    starflux: torch.Tensor          # [B]
    surf_albedo: torch.Tensor       # [B]
    # clouds (zeros if inactive)
    cloud_abs_cross_lay: torch.Tensor   # [L, B]
    cloud_scat_cross_lay: torch.Tensor  # [L, B]
    g_0_cloud_lay: torch.Tensor         # [L, B]
    cloud_abs_cross_int: torch.Tensor   # [L+1, B]
    cloud_scat_cross_int: torch.Tensor  # [L+1, B]
    g_0_cloud_int: torch.Tensor         # [L+1, B]
    # additional heating density [erg s^-1 cm^-3] (zeros if inactive)
    add_heat_dens: torch.Tensor         # [L]
    # stellar energy-budget correction factor (kernels.cu:420-468)
    star_corr_factor: torch.Tensor      # scalar


class FluxState(NamedTuple):
    """Fluxes carried across RCE iterations, flat layout [.., S]."""
    F_down: torch.Tensor   # [I, S]
    F_up: torch.Tensor     # [I, S]
    Fc_down: torch.Tensor  # [L, S]
    Fc_up: torch.Tensor    # [L, S]


class CellCache(NamedTuple):
    """Per-cell quantities refreshed every 10th iteration
    (reference computation.py:860-879).  Isothermal layers have one cell
    per layer: ``cells_or_upper`` and ``lower`` are then both that cell,
    and ``Fc_dir`` is zeros."""
    cells_or_upper: fp.FlatCells      # iso cells, or upper half-layers [L, S]
    lower: fp.FlatCells               # iso cells, or lower half-layers [L, S]
    scat_trigger: torch.Tensor        # [S] bool
    F_dir: torch.Tensor               # [I, S]
    Fc_dir: torch.Tensor              # [L, S]
    meanmolmass_lay: torch.Tensor     # [L]
    z_lay: torch.Tensor               # [L]
    opac_lay: torch.Tensor            # [L, S]
    scat_cross_lay: torch.Tensor      # [L, B]
    F_add_heat_lay: torch.Tensor      # [L]  add_heat_dens * delta_z
    F_add_heat_sum: torch.Tensor      # [L]  cumulative sum
    # static sweep coefficients
    coeff: Union[fp.IsoCoeffCache, fp.NonIsoCoeffCache]


def init_flux_state(phys: Phys, dtype, device, batch=()) -> FluxState:
    """Zero fluxes; ``batch`` = (P,) for a batch of P planets."""
    L, S = phys.nlayer, phys.nbin * phys.ny
    kw = dict(dtype=dtype, device=device)
    I_shape, L_shape = (L + 1, *batch, S), (L, *batch, S)
    return FluxState(F_down=torch.zeros(I_shape, **kw),
                     F_up=torch.zeros(I_shape, **kw),
                     Fc_down=torch.zeros(L_shape, **kw),
                     Fc_up=torch.zeros(L_shape, **kw))


@over_slices
def zero_fluxes(phys: Phys, m: ModelArrays, T_lay) -> FluxState:
    """Zero fluxes on the model's device for temperatures T_lay [L+1] (a
    batch: [L+1, P])."""
    return init_flux_state(phys, T_lay.dtype, T_lay.device,
                           tuple(T_lay.shape[1:]))


def build_model(cfg: HeliosConfig, table: OpacityTable, *,
                starflux: Optional[np.ndarray] = None,
                surf_albedo: Optional[np.ndarray] = None, cloud_result=None,
                device="cuda") -> Tuple[Phys, ModelArrays]:
    """Assemble (Phys, ModelArrays) from a finalized config and an opacity
    table (premixed, or with on-the-fly mixing the donor of the spectral,
    T and P grids), with the tensors on ``device`` (default CUDA; raises
    if CUDA is absent).  ``starflux`` [B] is the stellar spectrum of
    ``stellar_model="file"`` (default: zeros, the blackbody star's
    placeholder).  ``surf_albedo`` [B] is the surface albedo per bin (default:
    the config's constant, 0 when the config names a file, as in
    helios_tpu); ``cloud_result`` a
    :class:`helios_tpu_torch.clouds.CloudDeckResult` (default: no
    clouds).  With ``planet_type="no_atmosphere"`` the gas opacity is
    1e-30 (read.py:1014-1023)."""
    dev = resolve_device(device)
    phys = Phys.from_config(cfg, nbin=table.nbin, ny=table.ny)
    dt = torch_dtype(cfg.dtype)
    # copies: the model never aliases the caller's numpy arrays
    t = lambda x: torch.tensor(np.asarray(x), dtype=dt, device=dev)

    g = grid_mod.build_grid(cfg.p_boa, cfg.p_toa, cfg.nlayer, cfg.g,
                            dtype=cfg.np_dtype)
    _, gauss_w = gauss_legendre_ypoints(table.ny)
    delta_lambda = t(table.delta_wave)

    planck_grid = planck_mod.build_planck_table(
        t(table.wave_edges), delta_lambda, phys.T_star,
        dim=phys.plancktable_dim, step=phys.plancktable_step)

    if starflux is None:
        starflux = np.zeros(table.nbin, cfg.np_dtype)
    starflux = t(starflux)

    star_corr = t(1.0)
    if phys.energy_correction:
        planck_grid, starflux, star_corr = (
            planck_mod.correct_incident_energy(
                planck_grid, starflux, delta_lambda,
                real_star=phys.real_star, T_star=phys.T_star,
                dim=phys.plancktable_dim))

    if surf_albedo is None:
        alb = cfg.surf_albedo if not isinstance(cfg.surf_albedo, str) else 0.0
        surf_albedo = np.full(table.nbin, alb, cfg.np_dtype)

    L, B = phys.nlayer, phys.nbin
    kpoints = table.kpoints
    if phys.no_atmo:
        kpoints = np.full_like(kpoints, 1e-30)
    scat_tab = table.scat_cross
    mmm_tab = table.meanmolmass
    if scat_tab is None:
        scat_tab = np.zeros(kpoints.shape[:2] + (table.nbin,), cfg.np_dtype)
    if mmm_tab is None:
        mmm_tab = np.full(kpoints.shape[:2], 2.3 * pc.AMU, cfg.np_dtype)

    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    cloud = lambda name, *shape: (zeros(*shape) if cloud_result is None
                                  else t(getattr(cloud_result, name)))
    arrays = ModelArrays(
        p_lay=t(g.p_lay), p_int=t(g.p_int),
        delta_colmass=t(g.delta_colmass),
        delta_col_upper=t(g.delta_col_upper),
        delta_col_lower=t(g.delta_col_lower),
        ktable=t(kpoints.reshape(kpoints.shape[0], kpoints.shape[1], -1)),
        scat_cross_table=t(scat_tab), meanmolmass_table=t(mmm_tab),
        ktemps=t(table.temperatures), kpress=t(table.pressures),
        lambda_centers=t(table.wave_centers),
        lambda_edges=t(table.wave_edges), delta_lambda=delta_lambda,
        gauss_y=t(table.gauss_y), gauss_weight=t(gauss_w),
        planck_grid=planck_grid, starflux=starflux,
        surf_albedo=t(surf_albedo),
        cloud_abs_cross_lay=cloud("abs_cross_lay", L, B),
        cloud_scat_cross_lay=cloud("scat_cross_lay", L, B),
        g_0_cloud_lay=cloud("g_0_lay", L, B),
        cloud_abs_cross_int=cloud("abs_cross_int", L + 1, B),
        cloud_scat_cross_int=cloud("scat_cross_int", L + 1, B),
        g_0_cloud_int=cloud("g_0_int", L + 1, B),
        add_heat_dens=zeros(L), star_corr_factor=star_corr)
    return phys, arrays


# --------------------------------------------------------------------------- #
# altitude (reference host_functions.py:673-698)
# --------------------------------------------------------------------------- #

def layer_index(n: int, like):
    """arange(n) shaped to broadcast along the leading axis of ``like``
    ([n] for a planet, [n, 1] for a batch)."""
    return torch.arange(n, device=like.device).reshape(
        (n,) + (1,) * (like.dim() - 1))


def altitude_z(phys: Phys, m: ModelArrays, T_lay, meanmolmass_lay):
    """Layer thickness delta_z = k_B T/(mu g) ln(p_i/p_{i+1})
    (kernels.cu:1247-1261) and center altitudes, anchored at 10 bar for a
    gas planet or at the surface otherwise."""
    L = phys.nlayer
    delta_z = (pc.K_B * T_lay[:L] / (meanmolmass_lay * phys.g)
               * memberwise(torch.log, m.p_int[:L] / m.p_int[1:],
                            batched=T_lay.dim() > 1))
    mid = 0.5 * (delta_z[:-1] + delta_z[1:])
    s = torch.cat([torch.zeros_like(delta_z[:1]), ordered_cumsum(mid, 0)])
    if phys.planet_type == "gas":
        mask = m.p_lay >= 1e7
        idx = torch.where(mask, layer_index(L, mask), -1).amax(dim=0)
        at = s.gather(0, torch.clamp(idx, min=0)[None])[0]
        anchor = torch.where(idx >= 0, at, s[0])
        z_lay = s - anchor
    else:
        z_lay = s + 0.5 * delta_z[0]
    return delta_z, z_lay


# --------------------------------------------------------------------------- #
# per-cell quantities refresh (every 10th iteration in the reference)
# --------------------------------------------------------------------------- #

def _gas_properties(phys: Phys, m: ModelArrays, T, p, sset):
    """(opacity [n, S], Rayleigh cross-section [n, B], mean molecular mass
    [n]) on a T-P profile: premixed-table interpolation, or on-the-fly
    species mixing from ``sset``."""
    if phys.opacity_mixing == "on-the-fly":
        if sset is None:
            raise ValueError("on-the-fly opacity mixing needs a species "
                             "set (sset)")
        opac, scat, mmm = chem.mixed_opacities(
            sset, T, p, m.lambda_centers, m.gauss_weight, m.gauss_y,
            ro_method=phys.ro_method, scat=phys.scat)
        # [n, B, Y] -> the flat [n, S]
        return opac.flatten(-2), scat, mmm
    opac, scat = interp_ops.interpolate_opacity(
        m.ktable, m.scat_cross_table, m.ktemps, m.kpress, T, p)
    mmm = interp_ops.interpolate_meanmolmass(
        m.meanmolmass_table, m.ktemps, m.kpress, T, p)
    return opac, scat, mmm


def _effective_g0(phys: Phys, scat_band, cloud_scat, g0_cloud):
    """The asymmetry per band: the config's g_0, or with clouds the
    scattering-weighted mean of gas and clouds."""
    if phys.clouds:
        return ts_ops.g0_total(scat_band, g0_cloud, cloud_scat, phys.g_0)
    return torch.full_like(scat_band, phys.g_0)


@over_slices
def compute_cells(phys: Phys, m: ModelArrays, T_lay, T_int,
                  sset=None) -> CellCache:
    """Opacity interpolation (or on-the-fly mixing of ``sset``) + layer
    (iso) or half-layer (non-iso) transmission + direct beam + sweep
    coefficient cache: the block the reference refreshes every 10th
    iteration (computation.py:860-879)."""
    L, Y = phys.nlayer, phys.ny

    opac_lay, scat_lay, mmm_lay = _gas_properties(phys, m, T_lay[:L],
                                                  m.p_lay, sset)
    delta_z, z_lay = altitude_z(phys, m, T_lay, mmm_lay)

    planckband_lay = planck_mod.planckband_layers(
        m.planck_grid, T_lay, m.starflux, real_star=phys.real_star,
        dim=phys.plancktable_dim, step=phys.plancktable_step)
    planck_star_flat = fp.band_to_flat(planckband_lay[L], Y)

    if phys.scat:
        ray_lay = scat_lay
        cld_scat_lay = m.cloud_scat_cross_lay
        cld_scat_int = m.cloud_scat_cross_int
    else:
        ray_lay = torch.zeros_like(scat_lay)
        cld_scat_lay = torch.zeros_like(m.cloud_scat_cross_lay)
        cld_scat_int = torch.zeros_like(m.cloud_scat_cross_int)
    g0_lay = _effective_g0(phys, scat_lay, m.cloud_scat_cross_lay,
                           m.g_0_cloud_lay)

    kw = dict(epsi=phys.epsi, epsi2=phys.epsi2, mu_star=phys.mu_star,
              w_0_limit=phys.w_0_limit, scat_corr=phys.scat_corr,
              i2s_transition=phys.i2s_transition)
    coeff_kw = dict(scat_corr=phys.scat_corr,
                    i2s_transition=phys.i2s_transition, epsi=phys.epsi,
                    mu_star=phys.mu_star, dir_beam=phys.dir_beam,
                    f_factor=phys.f_factor, R_star=phys.R_star, a=phys.a)
    alb_flat = fp.band_to_flat(m.surf_albedo, Y)
    nint = L + 1
    cols = opac_lay.shape[1:]           # (S,) or (P, S)
    zeros = lambda n: torch.zeros((n,) + cols, dtype=opac_lay.dtype,
                                  device=opac_lay.device)

    # the masked 1/mu(i, j) [I, L] only for the geometric zenith
    # correction; the plain-mu* beam takes cumulative sums in fdir_*_flat
    if phys.dir_beam and phys.geom_zenith_corr:
        mu_mat = fp.mu_star_matrix(z_lay, phys.mu_star, phys.R_planet, nint)
        idx = torch.arange(L, device=z_lay.device)
        mask = idx[None, :] >= torch.arange(nint, device=z_lay.device)[:, None]
        mask = mask.reshape(mask.shape + (1,) * (z_lay.dim() - 1))
        mu_weights = torch.where(mask, 1.0 / mu_mat, torch.zeros_like(mu_mat))
        mu_diag = torch.diagonal(mu_mat[:L], dim1=0, dim2=1).movedim(-1, 0)
    else:
        mu_weights = mu_diag = None

    if phys.iso:
        cells = fp.cell_quantities_flat(
            opac_lay, mmm_lay, ray_lay, m.cloud_abs_cross_lay,
            cld_scat_lay, m.delta_colmass, g0_lay, Y, **kw)
        if phys.dir_beam:
            # the reference attenuates the direct beam through the gas-only
            # optical depth (delta_tau_wg, kernels.cu:1306)
            F_dir = fp.fdir_iso_flat(
                planck_star_flat, cells.delta_tau, mu_weights,
                mu_star=phys.mu_star, R_star=phys.R_star, a=phys.a,
                dir_beam=phys.dir_beam)
        else:
            F_dir = zeros(nint)
        Fc_dir = zeros(L)
        upper = lower = cells
        scat_trigger = torch.any(cells.w0 > phys.w_0_scat_limit, dim=0)
        coeff = fp.iso_coeff_cache(cells, planck_star_flat, F_dir,
                                   alb_flat, **coeff_kw)
    else:
        opac_int, scat_int, mmm_int = _gas_properties(phys, m, T_int,
                                                      m.p_int, sset)
        ray_int = scat_int if phys.scat else torch.zeros_like(scat_int)
        g0_int = _effective_g0(phys, scat_int, m.cloud_scat_cross_int,
                               m.g_0_cloud_int)

        # upper/lower half-layer averages (calc_trans_noniso,
        # kernels.cu:1171-1196)
        def up_mean(lay, intr):
            return 0.5 * (lay + intr[1:])

        def low_mean(lay, intr):
            return 0.5 * (intr[:-1] + lay)

        upper = fp.cell_quantities_flat(
            up_mean(opac_lay, opac_int), up_mean(mmm_lay, mmm_int),
            up_mean(ray_lay, ray_int),
            up_mean(m.cloud_abs_cross_lay, m.cloud_abs_cross_int),
            up_mean(cld_scat_lay, cld_scat_int),
            m.delta_col_upper, up_mean(g0_lay, g0_int), Y, **kw)
        lower = fp.cell_quantities_flat(
            low_mean(opac_lay, opac_int), low_mean(mmm_lay, mmm_int),
            low_mean(ray_lay, ray_int),
            low_mean(m.cloud_abs_cross_lay, m.cloud_abs_cross_int),
            low_mean(cld_scat_lay, cld_scat_int),
            m.delta_col_lower, low_mean(g0_lay, g0_int), Y, **kw)
        scat_trigger = (torch.any(upper.w0 > phys.w_0_scat_limit, dim=0)
                        | torch.any(lower.w0 > phys.w_0_scat_limit, dim=0))

        if phys.dir_beam:
            # the gas-only optical depths, as in the iso branch
            F_dir, Fc_dir = fp.fdir_noniso_flat(
                planck_star_flat, upper.delta_tau, lower.delta_tau,
                mu_weights, mu_diag, mu_star=phys.mu_star,
                R_star=phys.R_star, a=phys.a, dir_beam=phys.dir_beam)
        else:
            F_dir = zeros(nint)
            Fc_dir = zeros(L)

        coeff = fp.noniso_coeff_cache(
            upper, lower, planck_star_flat, F_dir, Fc_dir, alb_flat,
            delta_tau_limit=phys.delta_tau_limit, **coeff_kw)

    # additional heating flux per layer: volumetric density * layer height
    # (host_functions.py:701-711), refreshed with delta_z
    F_add_heat_lay = m.add_heat_dens * delta_z
    F_add_heat_sum = ordered_cumsum(F_add_heat_lay, 0)

    return CellCache(cells_or_upper=upper, lower=lower,
                     scat_trigger=scat_trigger, F_dir=F_dir, Fc_dir=Fc_dir,
                     meanmolmass_lay=mmm_lay, z_lay=z_lay,
                     opac_lay=opac_lay, scat_cross_lay=scat_lay,
                     F_add_heat_lay=F_add_heat_lay,
                     F_add_heat_sum=F_add_heat_sum, coeff=coeff)


# --------------------------------------------------------------------------- #
# flux solve (every iteration)
# --------------------------------------------------------------------------- #

@over_slices
def solve_fluxes(phys: Phys, m: ModelArrays, cache: CellCache, T_lay,
                 flux_state: FluxState) -> FluxState:
    """One flux solve: Planck lookups, then either the source assembly
    from the coefficient cache and the iso or non-iso sweep (iterative
    method), or the row assembly and the Thomas solve (matrix method); the
    CUDA kernels on the card."""
    L, Y = phys.nlayer, phys.ny
    planckband_lay = planck_mod.planckband_layers(
        m.planck_grid, T_lay, m.starflux, real_star=phys.real_star,
        dim=phys.plancktable_dim, step=phys.plancktable_step)
    B_lay_flat = fp.band_to_flat(planckband_lay[:L], Y)
    B_surf_flat = fp.band_to_flat(planckband_lay[L + 1], Y)
    matrix = phys.flux_calc_method == "matrix"
    common = dict(scat_corr=phys.scat_corr,
                  i2s_transition=phys.i2s_transition, epsi=phys.epsi,
                  mu_star=phys.mu_star, dir_beam=phys.dir_beam,
                  f_factor=phys.f_factor, R_star=phys.R_star, a=phys.a)

    if phys.iso and matrix:
        F_down, F_up = thomas_ops.fband_matrix_iso(
            cache.cells_or_upper, planckband_lay, cache.F_dir,
            m.surf_albedo, cache.scat_trigger, **common)
        return flux_state._replace(F_down=F_down, F_up=F_up)
    if phys.iso:
        C = fp.iso_coeffs_from_cache(cache.coeff, B_lay_flat, B_surf_flat)
        F_down, F_up = fp.fband_iso_flat(C, cache.F_dir[0], flux_state.F_up,
                                         n_passes=phys.n_sweep_passes)
        return flux_state._replace(F_down=F_down, F_up=F_up)

    T_int = interp_ops.interface_temperatures(T_lay)
    planckband_int = planck_mod.planckband_interfaces(
        m.planck_grid, T_int, dim=phys.plancktable_dim,
        step=phys.plancktable_step)
    if matrix:
        F_down, F_up, Fc_down, Fc_up = thomas_ops.fband_matrix_noniso(
            cache.cells_or_upper, cache.lower, planckband_lay,
            planckband_int, cache.F_dir, cache.Fc_dir, m.surf_albedo,
            cache.scat_trigger, delta_tau_limit=phys.delta_tau_limit,
            **common)
        return FluxState(F_down=F_down, F_up=F_up, Fc_down=Fc_down,
                         Fc_up=Fc_up)
    B_int_flat = fp.band_to_flat(planckband_int, Y)
    C = fp.noniso_coeffs_from_cache(
        cache.coeff, B_lay_flat, B_int_flat[:-1], B_int_flat[1:],
        B_surf_flat)
    F_down, F_up, Fc_down, Fc_up = fp.fband_noniso_flat(
        C, cache.F_dir[0], flux_state.F_up, flux_state.Fc_up,
        n_passes=phys.n_sweep_passes)
    return FluxState(F_down=F_down, F_up=F_up, Fc_down=Fc_down,
                     Fc_up=Fc_up)


def _band_totals(m: ModelArrays, flux_state: FluxState, F_dir_flat,
                 carry=None) -> BandTotals:
    """The band fluxes and totals of one flux solve (one kernel launch on
    the card); ``carry``: the totals of the bins before these, which the
    sums start from."""
    return band_integrate(flux_state.F_down, flux_state.F_up, F_dir_flat,
                          m.gauss_weight, m.delta_lambda, carry)


def integrate_flux_flat(phys: Phys, m: ModelArrays, flux_state: FluxState,
                        F_dir_flat) -> int_ops.FluxTotals:
    """Band + total integration from flat fluxes (kernels.cu:2428-2513).

    On a sliced model the band->total sum runs on from slice to slice, in
    slice order, each slice's sum starting from the total of the slices
    before it (the JAX package's psum over the spectral axis): on the card
    the same chain of adds as over the whole bin axis, bit for bit.  A
    padded bin (delta_lambda 0) adds an exact zero."""
    if count(m):
        parts, carry = [], None
        for k, d in enumerate(devices(m)):
            if carry is not None:
                carry = tuple(c.to(d) for c in carry)
            t = _band_totals(take(m, k, d), take(flux_state, k, d),
                             take(F_dir_flat, k, d), carry)
            parts.append(t)
            carry = (t.F_up_tot, t.F_down_tot)
        first = devices(m)[0]
        bands = [Slices(getattr(t, f) for t in parts)
                 for f in ("F_down_band", "F_up_band", "F_dir_band")]
        up, down, net = (getattr(parts[-1], f).to(first)
                         for f in ("F_up_tot", "F_down_tot", "F_net"))
    else:
        t = _band_totals(m, flux_state, F_dir_flat)
        bands = (t.F_down_band, t.F_up_band, t.F_dir_band)
        up, down, net = t.F_up_tot, t.F_down_tot, t.F_net
    F_down_band, F_up_band, F_dir_band = bands
    return int_ops.FluxTotals(
        F_down_band=F_down_band, F_up_band=F_up_band,
        F_dir_band=F_dir_band, F_down_tot=down, F_up_tot=up, F_net=net)


def forward_fluxes(phys: Phys, m: ModelArrays, T_lay,
                   flux_state: Optional[FluxState] = None, sset=None
                   ) -> Tuple[FluxState, int_ops.FluxTotals, CellCache]:
    """Full forward model: temperatures [L+1] -> integrated fluxes (a
    batch: [L+1, P] with stacked arrays).  ``sset``: the species set of
    on-the-fly opacity mixing."""
    if flux_state is None:
        flux_state = zero_fluxes(phys, m, T_lay)
    T_int = interp_ops.interface_temperatures(T_lay)
    cache = compute_cells(phys, m, T_lay, T_int, sset)
    flux_state = solve_fluxes(phys, m, cache, T_lay, flux_state)
    totals = integrate_flux_flat(phys, m, flux_state, cache.F_dir)
    return flux_state, totals, cache

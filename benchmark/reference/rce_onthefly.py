"""Plain reference of a HELIOS planet in radiative-convective equilibrium
whose opacities are mixed on the fly: HELIOS v3.1's ``opacity_mixing =
on-the-fly`` with ``k_mixing_method = RO`` (computation.py:1454-1501,
kernels.cu:3209-3459, host_functions.py:927-958), written afresh in plain
PyTorch, in float64, with no kernels, caches or batches.  The two-stream
solve, the Planck table, the grid and the judgement are those of
:mod:`rce_premixed`; only the opacity source differs.

At each profile (the layers' and the interfaces' temperatures and
pressures) the gas properties come from the species the configuration's
inputs hand over in the table argument (``benchmark/inputs/onthefly.py``):

- ``species``: rows (name, absorbing, scattering) in the species file's
  order; ``species_weight``: g/mol per species;
- ``species_vmr``: per species a constant, or its volume mixing ratio
  tabulated on the opacity table's (T, p) grid (FastChem's, a pair's
  product taken at the nodes, as HELIOS takes it on FastChem's grid);
- ``species_kpoints``: per absorber its k-table [ntemp, npress, B, ny] in
  cm^2 per gram of the species;
- ``species_rayleigh``: per scatterer other than H2O its cross-section
  [B] in cm^2 per molecule (H2O's follows from its density).

Each species' opacity and each tabulated VMR is bilinear in T and log10 p
with the fractional index clamped to [0, n - 1] (opac_species_interpol);
the mean molecular mass is the VMR-weighted mean weight of every species
but the CIA pairs; each absorber adds vmr m / mu times its opacity; the
first absorber is added plain and every later one by Random Overlap: per
cell the ny^2 pairwise sums with the products of the half Gauss weights, a
stable sort, the weights' running sum less half the current weight (yg),
and for each Gauss point y the first sorted position w after the previous
point's (and at least 1) with yg[w] > gauss_y[y], interpolated linearly
between w - 1 and w; a cell whose one opacity's largest value is under 1%
of the other's smallest takes the plain sum.  Rayleigh: the sum of vmr
times each scatterer's cross-section, H2O's from its refractive index
(Schiebener et al. 1990, as calc_h2o_scat).

Departures from the published description, to be checked:

- HELIOS mixes in the species file's order and, as the survey of its code
  reads computation.py, adds the CIA pairs plain as well as the first
  species; the program (``ops/mixing.py``) and the JAX package exempt
  only the first.  This reference follows the program: both CIA pairs
  are mixed by Random Overlap.
- Where the walk runs out of sorted positions before the last Gauss point
  (it does not at ny = 20: the last yg lies above the last node), the last
  interval is used, as the program does; HELIOS's loop would leave the
  point unset.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rce_premixed as premixed

AMU = 1.6605390666e-24          # [g]
K_B = premixed.K_B
PI = premixed.PI
NEGLIGIBLE = 0.01               # kernels.cu:3296-3302
H2O_LAMBDA_LIMIT = 2.5e-4       # [cm], calc_h2o_scat

pressure_grid = premixed.pressure_grid
planck_table = premixed.planck_table


def deployment(helios: dict, member: dict) -> dict:
    """The physical numbers of one planet, as :func:`rce_premixed.
    deployment` reads them, for a configuration that mixes on the fly by
    Random Overlap (anything else raises)."""
    f = dict(helios, **member)
    if f.get("opacity_mixing") != "on-the-fly" or f.get(
            "k_mixing_method", "RO") != "RO":
        raise ValueError("this reference mixes on the fly by Random "
                         "Overlap only")
    return premixed.deployment(dict(f, opacity_mixing="premixed"), {})


# --------------------------------------------------------------------------- #
# the gas properties on a profile
# --------------------------------------------------------------------------- #

def bilinear_species(values, temps, press, T, p):
    """values [nt, np, ...] at (T, p) [n], linear in T and log10 p, the
    fractional indices clamped to [0, n - 1] (kernels.cu:3209-3259)."""
    def index(x, grid_x):
        n = grid_x.shape[0]
        step = (grid_x[-1] - grid_x[0]) / (n - 1.0)
        f = torch.clamp((x - grid_x[0]) / step, 0.0, n - 1.0)
        lo = torch.clamp(torch.floor(f).long(), max=n - 2)
        return lo, f - lo
    ti, tw = index(T, temps)
    pi, pw = index(torch.log10(p), torch.log10(press))
    shape = tw.shape + (1,) * (values.dim() - 2)
    tw, pw = tw.reshape(shape), pw.reshape(shape)
    return ((values[ti, pi] * (1 - tw) + values[ti + 1, pi] * tw) * (1 - pw)
            + (values[ti, pi + 1] * (1 - tw)
               + values[ti + 1, pi + 1] * tw) * pw)


def random_overlap(mixed, new, gauss_weight, gauss_y):
    """Random Overlap of two k-distributions per cell: mixed, new [C, ny]
    -> [C, ny] (kernels.cu:3311-3397)."""
    C, ny = mixed.shape
    n2 = ny * ny
    sums = (mixed[:, :, None] + new[:, None, :]).reshape(C, n2)
    half = 0.5 * gauss_weight
    pair_w = (half[:, None] * half[None, :]).reshape(n2)
    k, order = torch.sort(sums, dim=1, stable=True)
    w = pair_w[order]
    yg = torch.cumsum(w, dim=1) - 0.5 * w
    pos = torch.arange(n2, device=mixed.device)
    out = torch.empty_like(mixed)
    prev = torch.zeros(C, dtype=torch.long, device=mixed.device)
    for y in range(ny):
        g = gauss_y[y]
        start = torch.clamp(prev + 1, min=1)
        ok = (yg > g) & (pos[None, :] >= start[:, None])
        at = torch.clamp(torch.where(ok, pos[None, :], n2).amin(dim=1),
                         max=n2 - 1)
        lo, hi = (at - 1)[:, None], at[:, None]
        y_lo, y_hi = yg.gather(1, lo)[:, 0], yg.gather(1, hi)[:, 0]
        k_lo, k_hi = k.gather(1, lo)[:, 0], k.gather(1, hi)[:, 0]
        out[:, y] = (k_lo * (y_hi - g) + k_hi * (g - y_lo)) / (y_hi - y_lo)
        prev = at
    plain = ((NEGLIGIBLE * mixed[:, 0] > new[:, ny - 1])
             | (NEGLIGIBLE * new[:, 0] > mixed[:, ny - 1]))
    return torch.where(plain[:, None], mixed + new, out)


def h2o_rayleigh(wave, p, T, vmr, mass):
    """H2O's Rayleigh cross-section [n, B] from its refractive index at
    its density (Schiebener et al. 1990; calc_index_h2o, calc_h2o_scat,
    kernels.cu:3174-3205, :3404-3440), zero from 2.5 um on."""
    dens = vmr * p * mass / (K_B * T)
    lam = (wave / 0.589e-4)[None, :]
    delta = torch.clamp(dens, max=1.0)[:, None]
    theta = (T / 273.15)[:, None]
    a = (0.244257733, 0.974634476e-2, -0.373234996e-2, 0.268678472e-3,
         0.158920570e-2, 0.245934259e-2, 0.900704920, -0.166626219e-1)
    uv, ir = 0.229202, 5.432937
    A = delta * (a[0] + a[1] * delta + a[2] * theta
                 + a[3] * lam ** 2 * theta + a[4] * lam ** -2
                 + a[5] / (lam ** 2 - uv ** 2) + a[6] / (lam ** 2 - ir ** 2)
                 + a[7] * delta ** 2)
    n = torch.sqrt((2.0 * A + 1.0) / (1.0 - A))
    number = (vmr * p / (K_B * T))[:, None]
    king = (6.0 + 3.0 * 3e-4) / (6.0 - 7.0 * 3e-4)
    cross = (24.0 * PI ** 3 / (number ** 2 * wave[None, :] ** 4)
             * ((n ** 2 - 1.0) / (n ** 2 + 2.0)) ** 2 * king)
    return torch.where(wave[None, :] < H2O_LAMBDA_LIMIT, cross,
                       torch.zeros_like(cross))


def gas(d: dict, table: dict, T, p):
    """(opacity [n, B*ny] in cm^2/g, Rayleigh cross-section [n, B] per
    molecule, mean molecular mass [n] in g) on the profile (T, p) [n]."""
    dev = T.device
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=dev)
    temps, press = t(table["temperatures"]), t(table["pressures"])
    nt, npr = temps.shape[0], press.shape[0]
    B, ny = len(table["wave_centers"]), len(table["gauss_y"])
    wave = t(table["wave_centers"])
    x, wts = np.polynomial.legendre.leggauss(ny)
    gauss_y, gauss_w = t(0.5 * (x + 1.0)), t(wts)

    def vmr(name):
        v = table["species_vmr"][name]
        if np.ndim(v) == 0:
            return torch.full_like(T, float(v))
        return bilinear_species(t(v), temps, press, T, p)

    vmrs = {name: vmr(name) for name, _, _ in table["species"]}
    weight = table["species_weight"]
    counted = [n for n, _, _ in table["species"] if "CIA" not in n]
    mmm = (sum(vmrs[n] * weight[n] for n in counted)
           / sum(vmrs[n] for n in counted) * AMU)

    opac = None
    ray = torch.zeros(T.shape[0], B, dtype=T.dtype, device=dev)
    for name, absorbing, scattering in table["species"]:
        if absorbing:
            k = t(table["species_kpoints"][name]).reshape(nt, npr, B * ny)
            add = (vmrs[name] * weight[name] * AMU / mmm)[:, None] * (
                bilinear_species(k, temps, press, T, p))
            if opac is None:            # the first absorber: added plain
                opac = add
            else:
                opac = random_overlap(opac.reshape(-1, ny),
                                      add.reshape(-1, ny), gauss_w,
                                      gauss_y).reshape(opac.shape)
        if scattering and d["scat"]:
            sigma = (h2o_rayleigh(wave, p, T, vmrs[name], weight[name] * AMU)
                     if name == "H2O"
                     else t(table["species_rayleigh"][name])[None, :])
            ray = ray + vmrs[name][:, None] * sigma
    return opac, ray, mmm


# --------------------------------------------------------------------------- #
# the forward model and the judgement
# --------------------------------------------------------------------------- #

def fluxes(d: dict, table: dict, T_lay, planck_grid=None):
    """The fluxes of a planet at temperatures T_lay [L+1] (the last the
    surface), as :func:`rce_premixed.fluxes` gives them, with the gas
    properties mixed on the fly."""
    dev = T_lay.device
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=dev)
    L = d["nlayer"]
    B, ny = len(table["wave_centers"]), len(table["gauss_y"])
    if planck_grid is None:
        planck_grid = planck_table(d, table, dev)
    p_lay, p_int = (t(x) for x in pressure_grid(d))
    T_int = premixed.interface_T(T_lay)
    opac_lay, ray_lay, mmm_lay = gas(d, table, T_lay[:L], p_lay)
    opac_int, ray_int, mmm_int = gas(d, table, T_int, p_int)
    up = premixed._half(
        0.5 * (opac_lay + opac_int[1:]), 0.5 * (ray_lay + ray_int[1:]),
        0.5 * (mmm_lay + mmm_int[1:]), (p_lay - p_int[1:]) / d["g"], ny, d)
    low = premixed._half(
        0.5 * (opac_int[:-1] + opac_lay), 0.5 * (ray_int[:-1] + ray_lay),
        0.5 * (mmm_int[:-1] + mmm_lay), (p_int[:-1] - p_lay) / d["g"], ny,
        d)

    flat = lambda x: torch.repeat_interleave(x, ny, dim=-1)
    at = lambda T: flat(premixed.planck_at(planck_grid, T, d))
    B_lay, B_int, B_surf = at(T_lay[:L]), at(T_int), at(T_lay[L])
    alb = torch.full_like(B_surf, d["albedo"])
    toa = (d["f_factor"] * (d["R_star"] / d["a"]) ** 2 * PI
           * flat(planck_grid[-1]))
    cells = [c for i in range(L) for c in (
        {k: v[i] for k, v in low.items()}, {k: v[i] for k, v in up.items()})]
    B_level = [x for i in range(L) for x in (B_int[i], B_lay[i])]
    B_level.append(B_int[L])
    F_down, F_up = premixed._adding(cells, B_level, alb, B_surf, toa, low, d)
    F_down, F_up = F_down[0::2], F_up[0::2]     # the interfaces

    _, w = np.polynomial.legendre.leggauss(ny)
    band = lambda f: 0.5 * (f.reshape(L + 1, B, ny) * t(w)).sum(-1)
    dl = t(table["delta_wave"])
    F_up_band, F_down_band = band(F_up), band(F_down)
    F_up_tot = (F_up_band * dl).sum(-1)
    F_down_tot = (F_down_band * dl).sum(-1)
    return dict(F_up=F_up, F_down=F_down, F_up_band=F_up_band,
                F_down_band=F_down_band, F_up_tot=F_up_tot,
                F_down_tot=F_down_tot, F_net=F_up_tot - F_down_tot)


def check_planet(d: dict, table: dict, reported: dict, device,
                 planck_grid=None) -> dict:
    """``flux_gap``, ``rad_residual`` and ``adiabat_gap`` of one reported
    planet, as :func:`rce_premixed.check_planet` reads them, against
    these fluxes."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=device)
    L = d["nlayer"]
    ref = fluxes(d, table, t(reported["T_lay"]), planck_grid)
    gap = 0.0
    for key, want in (("F_up_tot", ref["F_up_tot"]),
                      ("F_down_tot", ref["F_down_tot"]),
                      ("F_up_band_toa", ref["F_up_band"][L])):
        got = t(reported[key])
        gap = max(gap, float((got - want).abs().max() / want.abs().max()))

    conv = np.asarray(reported["conv_layer"]).astype(bool)
    F_net = ref["F_net"]
    denom = float(ref["F_down_tot"][L]) + d["F_intern"]
    diff = torch.cat([(d["F_intern"] - F_net[1:]).abs(),
                      (d["F_intern"] - F_net[:1]).abs()])
    rad = torch.as_tensor(~conv, device=device)
    residual = float(diff[rad].max()) / denom if bool(rad.any()) else 0.0

    p_lay, p_int = pressure_grid(d)
    T_h = np.asarray(reported["T_lay"], dtype=np.float64)
    theta = np.concatenate([[T_h[L] / p_int[0] ** d["kappa"]],
                            T_h[:L] / p_lay ** d["kappa"]])
    flags = np.concatenate([[conv[L]], conv[:L]])
    spread = 0.0
    for s, e in premixed._zones(flags):
        if e > s:
            z = theta[s:e + 1]
            spread = max(spread, float((z.max() - z.min()) / z.mean()))
    return dict(flux_gap=gap, rad_residual=residual, adiabat_gap=spread)

"""Plain reference of a HELIOS planet in radiative-convective equilibrium
with a premixed opacity table: the equations of exoclime/HELIOS v3.1
(Malik et al. 2017, 2019; source/kernels.cu, host_functions.py), written
afresh in plain PyTorch, in float64, with no kernels, caches or batches.

It covers what the benchmark's configurations use: non-isothermal layers
(each layer an upper and a lower half), a premixed table (bilinear in T
and log10 p), Rayleigh scattering with a constant asymmetry, a blackbody
star with the incident-energy correction, no direct beam, a gas planet, a
constant kappa, and the flux methods "iteration" and "matrix".  Anything
else raises.

The two-stream relations of each half layer are solved exactly, column by
column, by an adding recursion (reflection R and source S of the
atmosphere below each level, then downward): the fixed point that the
iterative sweeps approach, and the coupled system that the matrix method
solves.  A column of the matrix method with no scattering cell above the
limit takes HELIOS's pure-absorption recurrences, as HELIOS does.

:func:`check_planet` judges what a run reports for one planet at its own
final temperatures: its fluxes against these (``flux_gap``), radiative
equilibrium in the layers it reports radiative (``rad_residual``), and
the dry adiabat through the layers it reports convective
(``adiabat_gap``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = 3.141592653589793
H = 6.62607004e-27              # [erg s]
C = 29979245800.0               # [cm/s]
K_B = 1.38064852e-16            # [erg/K]
SIGMA_SB = 5.6703669999999995e-5
AU = 14959787070000.0           # [cm]
R_JUP = 7149200000.0            # [cm]
R_SUN = 69570000000.0           # [cm]

W0_LIMIT = 1.0 - 1e-10          # host_functions.py:209-222
W0_SCAT_LIMIT = 1e-3
DTAU_LIMIT = 1e-4
N_SERIES = 200                  # terms of the Planck series, kernels.cu:410
P_TOP_IGNORE = 1e1              # no instability test above 10 ubar


def _yes(v) -> bool:
    return v in ("yes", 1, True)


def deployment(helios: dict, member: dict) -> dict:
    """The physical numbers of one planet: the configuration's ``helios``
    fields with the member's overrides, units resolved as HELIOS reads
    them (read.py, host_functions.py:33-48, :203)."""
    f = dict(helios, **member)
    unsupported = dict(
        run_type=f.get("run_type") != "iterative",
        iso=f.get("iso_input") != "no",
        beam=_yes(f.get("direct_beam")),
        clouds=int(f.get("nr_cloud_decks", 0)) > 0,
        planet=f.get("planet") != "manual"
        or f.get("planet_type", "gas") != "gas",
        star=f.get("stellar_model", "blackbody") != "blackbody",
        mixing=f.get("opacity_mixing", "premixed") != "premixed",
        smooth=_yes(f.get("smooth", "no")),
        heating=_yes(f.get("add_heating", "no")),
        kappa=isinstance(f.get("kappa_value"), str))
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the reference does not cover: {bad}")
    g = float(f["g"])
    g = 10.0 ** g if g < 10 else g
    p_boa, p_toa = float(f["p_boa"]), float(f["p_toa"])
    nlayer = f.get("nlayer", "automatic")
    nlayer = (int(math.ceil(10.5 * math.log10(p_boa / p_toa)))
              if nlayer == "automatic" else int(nlayer))
    method = f.get("flux_calc_method", "iteration")
    if method not in ("iteration", "matrix"):
        raise ValueError(f"unknown flux method {method!r}")
    energy = f.get("energy_correction", "automatic")
    return dict(
        nlayer=nlayer, g=g, p_boa=p_boa, p_toa=p_toa,
        a=float(f["a"]) * AU, R_star=float(f["R_star"]) * R_SUN,
        T_star=max(float(f["T_star"]), 2.7),
        F_intern=SIGMA_SB * float(f["T_intern"]) ** 4.0,
        f_factor=float(f["f_factor"]), epsi=1.0 / float(f["diffusivity"]),
        g_0=float(f["g_0"]), scat=_yes(f["scattering"]),
        scat_corr=_yes(f["scat_corr"]),
        i2s=float(f["i2s_transition"]),
        albedo=max(1e-8, min(0.999, float(f["surf_albedo"]))),
        kappa=float(f["kappa_value"]),
        energy_correction=(True if energy == "automatic"
                           else _yes(energy)),
        planck_dim=int(f["plancktable_dim"]),
        planck_step=int(f["plancktable_step"]),
        matrix=method == "matrix",
        rad_limit=float(f["rad_convergence_limit"]))


# --------------------------------------------------------------------------- #
# inputs: grid, Planck table, opacities
# --------------------------------------------------------------------------- #

def pressure_grid(d: dict):
    """(p_lay [L], p_int [L+1]): 2L log-spaced levels from BOA to TOA, the
    odd ones layer centres, the even ones interfaces, and one interface
    extrapolated above the top (host_functions.py:714-724)."""
    L = d["nlayer"]
    ratio = d["p_toa"] / d["p_boa"]
    i = np.arange(2 * L, dtype=np.float64)
    levels = d["p_boa"] * ratio ** (i / (2 * L - 1))
    p_int = np.append(levels[0::2], d["p_toa"] * ratio ** (1.0 / (2 * L - 1)))
    return levels[1::2], p_int


def planck_band(edges, dwave, T):
    """Band-mean Planck function [..., B] at temperatures T [...]: the
    closed series of the integral over each bin, divided by its width
    (kernels.cu:362-416); zero at T <= 0.01."""
    T = T[..., None]
    y = H * C / (edges * K_B * T)
    S = torch.zeros_like(y)
    for n in range(1, N_SERIES):
        S = S + torch.exp(-n * y) * (y ** 3 / n + 3.0 * y ** 2 / n ** 2
                                     + 6.0 * y / n ** 3 + 6.0 / n ** 4)
    pref = 2.0 * K_B ** 4 * T ** 4 / (H ** 3 * C ** 2)
    band = pref * (S[..., 1:] - S[..., :-1])
    return torch.where(T > 0.01, band, torch.zeros_like(band)) / dwave


def planck_table(d: dict, table: dict, device):
    """The tabulated band Planck grid: rows at T = 1 + step * t, t < dim,
    and the star's row, scaled so that the star's band sum is sigma
    T_star^4 with the energy correction (kernels.cu:384-468)."""
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)
    edges, dwave = t(table["wave_edges"]), t(table["delta_wave"])
    T = torch.arange(d["planck_dim"], dtype=torch.float64,
                     device=device) * d["planck_step"] + 1.0
    rows = torch.cat([T, t([d["T_star"]])])
    grid = torch.cat([planck_band(edges, dwave, rows[k:k + 500])
                      for k in range(0, len(rows), 500)])
    if d["energy_correction"]:
        star = grid[-1]
        corr = SIGMA_SB * d["T_star"] ** 4 / torch.sum(dwave * PI * star)
        grid[-1] = star * corr
    return grid


def planck_at(grid, T, d: dict):
    """Linear lookup in the Planck grid, the index (T - 1)/step clamped to
    [0.001, dim - 1.001] (kernels.cu:952-974).  [..., B]."""
    dim, step = d["planck_dim"], d["planck_step"]
    x = torch.clamp((T - 1.0) / step, 0.001, dim - 1.001)
    lo = torch.floor(x).long()
    w = (x - lo)[..., None]
    return grid[lo] * (1.0 - w) + grid[lo + 1] * w


def interface_T(T_lay):
    """Interface temperatures [L+1] from the layers' [L+1] (the last entry,
    the surface, unused): the means of neighbours, extrapolated linearly
    at both ends (kernels.cu:496-520)."""
    t = T_lay[:-1]
    return torch.cat([(t[0] - 0.5 * (t[1] - t[0]))[None],
                      0.5 * (t[:-1] + t[1:]),
                      (t[-1] + 0.5 * (t[-1] - t[-2]))[None]])


def bilinear(values, temps, press, T, p):
    """values [nt, np, ...] at (T, p) [n]: linear in T and in log10 p, the
    fractional indices clamped to [0.001, n - 1.001] (kernels.cu:524-698).
    Returns [n, ...]."""
    def index(x, grid_x):
        n = grid_x.shape[0]
        step = (grid_x[-1] - grid_x[0]) / (n - 1.0)
        f = torch.clamp((x - grid_x[0]) / step, 0.001, n - 1.001)
        lo = torch.clamp(torch.floor(f).long(), max=n - 2)
        return lo, f - lo
    ti, tw = index(T, temps)
    pi, pw = index(torch.log10(p), torch.log10(press))
    shape = tw.shape + (1,) * (values.dim() - 2)
    tw, pw = tw.reshape(shape), pw.reshape(shape)
    return ((values[ti, pi] * (1 - tw) + values[ti + 1, pi] * tw) * (1 - pw)
            + (values[ti, pi + 1] * (1 - tw)
               + values[ti + 1, pi + 1] * tw) * pw)


# --------------------------------------------------------------------------- #
# the forward model
# --------------------------------------------------------------------------- #

def _E(w0, g0, d):
    """The improved two-stream correction E(w0, g0) (Heng, Malik &
    Kitzmann 2018), 1 when it is off."""
    if not d["scat_corr"]:
        return torch.ones_like(w0)
    fit = torch.clamp(1.225 - 0.1582 * g0 - 0.1777 * w0 - 0.07465 * g0 ** 2
                      + 0.2351 * w0 * g0 - 0.05582 * w0 ** 2, min=1.0)
    return torch.where((w0 > d["i2s"]) & (g0 >= 0), fit,
                       torch.ones_like(w0))


def _half(opac, ray, mmm, dcol, ny, d):
    """Two-stream quantities of one half layer [L, S]: opac [L, S] (cm^2/g),
    ray [L, B] (cm^2 per molecule), mmm [L] (g), dcol [L] (g/cm^2)."""
    ray = torch.repeat_interleave(ray, ny, dim=-1)
    abs_ = opac * mmm[:, None]
    w0 = torch.clamp(ray / (ray + abs_), max=W0_LIMIT)
    dtau = dcol[:, None] * (opac + ray / mmm[:, None])
    g0 = torch.full_like(w0, d["g_0"])
    E = _E(w0, g0, d)
    root = torch.sqrt((E - w0) / (E * (1.0 - w0 * g0)))
    zp, zm = 0.5 * (1.0 + root), 0.5 * (1.0 - root)
    t = torch.exp(-1.0 / d["epsi"] * torch.sqrt(E * (1.0 - w0 * g0)
                                                * (E - w0)) * dtau)
    return dict(w0=w0, g0=g0, E=E, dtau=dtau, t=t,
                M=zm ** 2 * t ** 2 - zp ** 2, N=zp * zm * (1.0 - t ** 2),
                P=(zm ** 2 - zp ** 2) * t)


def _source(c, B_to, B_from, d):
    """2 pi eps (1-w0)/(E-w0) times the Planck term of a half layer for the
    flux that leaves it at the level of B_to, linear in optical depth
    between the levels (the isothermal form below the optical-depth
    limit)."""
    M, N, P, dtau = c["M"], c["N"], c["P"], c["dtau"]
    grad = (B_to - B_from) / torch.clamp(dtau, min=1e-30)
    lin = (B_to * (M + N) - B_from * P + d["epsi"]
           / (c["E"] * (1.0 - c["w0"] * c["g0"])) * (P - M + N) * grad)
    iso = 0.5 * (B_to + B_from) * (N + M - P)
    term = torch.where(dtau < DTAU_LIMIT, iso, lin)
    return 2.0 * PI * d["epsi"] * (1.0 - c["w0"]) / (c["E"] - c["w0"]) * term


def _absorption_source(c, B_to, B_from, d):
    """The pure-absorption source of a half layer (kernels.cu:2294-2421)."""
    t, dtau = c["t"], c["dtau"]
    grad = (B_to - B_from) / torch.clamp(dtau, min=1e-30)
    lin = B_to - t * B_from + d["epsi"] * (t - 1.0) * grad
    iso = 0.5 * (B_to + B_from) * (1.0 - t)
    return 2.0 * PI * d["epsi"] * torch.where(dtau < DTAU_LIMIT, iso, lin)


def fluxes(d: dict, table: dict, T_lay, planck_grid=None):
    """The fluxes of a planet at temperatures T_lay [L+1] (the last the
    surface): {F_up, F_down} per interface and column [L+1, S], the band
    fluxes [L+1, B] and the totals [L+1]."""
    dev = T_lay.device
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=dev)
    L = d["nlayer"]
    nt, npr, B, ny = table["kpoints"].shape
    if planck_grid is None:
        planck_grid = planck_table(d, table, dev)
    p_lay, p_int = (t(x) for x in pressure_grid(d))
    T_int = interface_T(T_lay)
    temps, press = t(table["temperatures"]), t(table["pressures"])
    k = t(table["kpoints"]).reshape(nt, npr, B * ny)
    scat = t(table["scat_cross"]) if d["scat"] else torch.zeros(
        nt, npr, B, dtype=torch.float64, device=dev)
    mmm_tab = t(table["meanmolmass"])
    opac_lay = bilinear(k, temps, press, T_lay[:L], p_lay)
    opac_int = bilinear(k, temps, press, T_int, p_int)
    ray_lay = bilinear(scat, temps, press, T_lay[:L], p_lay)
    ray_int = bilinear(scat, temps, press, T_int, p_int)
    mmm_lay = bilinear(mmm_tab, temps, press, T_lay[:L], p_lay)
    mmm_int = bilinear(mmm_tab, temps, press, T_int, p_int)
    up = _half(0.5 * (opac_lay + opac_int[1:]), 0.5 * (ray_lay + ray_int[1:]),
               0.5 * (mmm_lay + mmm_int[1:]), (p_lay - p_int[1:]) / d["g"],
               ny, d)
    low = _half(0.5 * (opac_int[:-1] + opac_lay),
                0.5 * (ray_int[:-1] + ray_lay),
                0.5 * (mmm_int[:-1] + mmm_lay),
                (p_int[:-1] - p_lay) / d["g"], ny, d)

    flat = lambda x: torch.repeat_interleave(x, ny, dim=-1)
    B_lay = flat(planck_at(planck_grid, T_lay[:L], d))
    B_int = flat(planck_at(planck_grid, T_int, d))
    B_surf = flat(planck_at(planck_grid, T_lay[L], d))
    B_star = flat(planck_grid[-1])
    alb = torch.full_like(B_surf, d["albedo"])
    toa = d["f_factor"] * (d["R_star"] / d["a"]) ** 2 * PI * B_star

    # the 2L half layers from the bottom: half h lies between level h and
    # level h + 1; even levels are interfaces, odd ones layer centres
    cells = [c for i in range(L) for c in (
        {k_: v[i] for k_, v in low.items()},
        {k_: v[i] for k_, v in up.items()})]
    B_level = [x for i in range(L) for x in (B_int[i], B_lay[i])]
    B_level.append(B_int[L])

    coupled = _adding(cells, B_level, alb, B_surf, toa, low, d)
    if d["matrix"]:
        trig = ((low["w0"] > W0_SCAT_LIMIT).any(0)
                | (up["w0"] > W0_SCAT_LIMIT).any(0))
        absorb = _absorption(cells, B_level, alb, B_surf, toa, d)
        F_down = torch.where(trig, coupled[0], absorb[0])
        F_up = torch.where(trig, coupled[1], absorb[1])
    else:
        F_down, F_up = coupled
    F_down, F_up = F_down[0::2], F_up[0::2]     # the interfaces

    _, w = np.polynomial.legendre.leggauss(ny)
    w = t(w)
    band = lambda f: 0.5 * (f.reshape(L + 1, B, ny) * w).sum(-1)
    dl = t(table["delta_wave"])
    F_up_band, F_down_band = band(F_up), band(F_down)
    F_up_tot = (F_up_band * dl).sum(-1)
    F_down_tot = (F_down_band * dl).sum(-1)
    return dict(F_up=F_up, F_down=F_down, F_up_band=F_up_band,
                F_down_band=F_down_band, F_up_tot=F_up_tot,
                F_down_tot=F_down_tot, F_net=F_up_tot - F_down_tot)


def _adding(cells, B_level, alb, B_surf, toa, low, d):
    """The coupled two-stream solve of every column, exact: for a half
    layer between levels b (below) and a (above),
        M D_b = P D_a - N U_b + s_down,   M U_a = P U_b - N D_a + s_up,
    with U_0 = albedo D_0 + emission at the bottom and D_top = toa.  Going
    up, U_h = R_h D_h + S_h; then down from the top.  Returns (F_down,
    F_up) on the 2L + 1 levels [2L+1, S]."""
    w0, E = low["w0"][0], low["E"][0]
    R = [alb]
    S = [(1.0 - alb) * PI * (1.0 - w0) / (E - w0) * B_surf]
    for h, c in enumerate(cells):
        M, N, P = c["M"], c["N"], c["P"]
        s_down = _source(c, B_level[h], B_level[h + 1], d)
        s_up = _source(c, B_level[h + 1], B_level[h], d)
        den = M + N * R[h]
        c["den"], c["s_down"] = den, s_down
        R.append((P * P * R[h] / den - N) / M)
        S.append((P * R[h] * (s_down - N * S[h]) / den + P * S[h] + s_up)
                 / M)
    n = len(cells)
    D = [None] * (n + 1)
    D[n] = toa
    for h in range(n - 1, -1, -1):
        c = cells[h]
        D[h] = (c["P"] * D[h + 1] - c["N"] * S[h] + c["s_down"]) / c["den"]
    U = [R[h] * D[h] + S[h] for h in range(n + 1)]
    return torch.stack(D), torch.stack(U)


def _absorption(cells, B_level, alb, B_surf, toa, d):
    """HELIOS's pure-absorption recurrences, downward then upward."""
    n = len(cells)
    D = [None] * (n + 1)
    D[n] = toa
    for h in range(n - 1, -1, -1):
        c = cells[h]
        D[h] = c["t"] * D[h + 1] + _absorption_source(
            c, B_level[h], B_level[h + 1], d)
    U = [alb * D[0] + (1.0 - alb) * PI * B_surf]
    for h, c in enumerate(cells):
        U.append(c["t"] * U[h] + _absorption_source(
            c, B_level[h + 1], B_level[h], d))
    return torch.stack(D), torch.stack(U)


# --------------------------------------------------------------------------- #
# the judgement
# --------------------------------------------------------------------------- #

def _zones(flags_ext):
    """Runs of consecutive True in a list: [(start, end)], inclusive."""
    out, start = [], None
    for i, f in enumerate(list(flags_ext) + [False]):
        if f and start is None:
            start = i
        elif not f and start is not None:
            out.append((start, i - 1))
            start = None
    return out


def check_planet(d: dict, table: dict, reported: dict, device,
                 planck_grid=None) -> dict:
    """The numbers that judge one planet as a run reports it: ``reported``
    holds T_lay [L+1], conv_layer [L+1] (the layers it reports
    convective, the last the surface), and its F_up_tot, F_down_tot [L+1]
    and TOA spectrum F_up_band_toa [B].

    - flux_gap: the widest gap between its fluxes and these at its T, over
      the upward and downward totals and the TOA spectrum, each against
      the largest value of its array;
    - rad_residual: |F_intern - F_net| at the top of every layer it
      reports radiative (and at the bottom, for the surface), over
      F_down(TOA) + F_intern, from these fluxes: HELIOS's convergence test
      (host_functions.py:251-286), whose limit the configuration states;
    - adiabat_gap: the widest relative spread of T / p^kappa (the dry
      adiabat of a constant kappa) within a run of layers it reports
      convective, 0 where it reports none."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=device)
    L = d["nlayer"]
    T = t(reported["T_lay"])
    ref = fluxes(d, table, T, planck_grid)
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
    # the surface below layer 0 sits at p_int[0]
    theta = np.concatenate([[T_h[L] / p_int[0] ** d["kappa"]],
                            T_h[:L] / p_lay ** d["kappa"]])
    flags = np.concatenate([[conv[L]], conv[:L]])
    spread = 0.0
    for s, e in _zones(flags):
        if e > s:
            z = theta[s:e + 1]
            spread = max(spread, float((z.max() - z.min()) / z.mean()))
    return dict(flux_gap=gap, rad_residual=residual, adiabat_gap=spread)

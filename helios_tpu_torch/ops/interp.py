"""Vectorized table interpolation ops (port of :mod:`helios_tpu.ops.interp`;
reference kernels.cu:496-919).

One gather + weighted-sum expression over the whole layer column, with the
reference's clamped index math.
"""

from __future__ import annotations

import torch

from helios_tpu_torch.ops.members import memberwise


def interface_temperatures(T_lay):
    """Layer -> interface temperatures (kernels.cu:496-520).

    T_lay: [nlayer+1] (index nlayer = surface ghost layer, unused here),
    or [nlayer+1, P] for a batch of P planets.
    Returns T_int of the same shape.
    """
    t = T_lay[:-1]
    inner = 0.5 * (t[:-1] + t[1:])
    bottom = t[0] - 0.5 * (t[1] - t[0])
    top = t[-1] + 0.5 * (t[-1] - t[-2])
    return torch.cat([bottom[None], inner, top[None]])


def _fractional_index(x, x0, dx, n, lo=0.001):
    """Clamped fractional table index (kernels.cu:545-559):
    t = (x - x0)/dx clamped to [lo, n-1-lo].  Returns (idx_down, weight_up)
    with value = v[idx]*(1-w) + v[idx+1]*w."""
    t = (x - x0) / dx
    t = torch.clamp(t, lo, n - 1.0 - lo)
    td = torch.clamp(torch.floor(t).long(), max=n - 2)
    return td, t - td


def bilinear_tp(table, temps, press, T, p, *, log_temp: bool = False,
                clamp_lo: float = 0.001):
    """Bilinear interpolation in (T, log10 P) of a tabulated quantity.

    table: [ntemp, npress, ...trailing] on uniformly spaced temps (in log10
    with ``log_temp``) and log10-uniform press; T, p: [n].  ``log_temp``
    interpolates in log10 T, with the grid step taken in log10 (the c_p and
    entropy tables, kernels.cu:777-779).  Returns [n, ...trailing].

    A batch of P planets passes T, p [n, P].  A table shared by the batch
    keeps its shape; a table per member is [ntemp, npress, P, ...trailing]
    with grids temps [ntemp, P] and press [npress, P], and each member
    looks up its own.  Returns [n, P, ...trailing].
    """
    ntemp, npress = table.shape[0], table.shape[1]
    log10 = lambda x: memberwise(torch.log10, x, batched=T.dim() > 1)
    if log_temp:
        tx, t0 = log10(T), log10(temps[0])
        dT = (log10(temps[-1]) - log10(temps[0])) / (ntemp - 1.0)
    else:
        tx, t0 = T, temps[0]
        dT = (temps[-1] - temps[0]) / (ntemp - 1.0)
    dP = (log10(press[-1]) - log10(press[0])) / (npress - 1.0)

    td, wt = _fractional_index(tx, t0, dT, ntemp, clamp_lo)
    pd, wp = _fractional_index(log10(p), log10(press[0]), dP, npress,
                               clamp_lo)

    if temps.dim() > 1:
        member = torch.arange(temps.shape[1], device=T.device)
        look = lambda i, j: table[i, j, member]
        extra_dims = (1,) * (table.ndim - 3)
    else:
        look = lambda i, j: table[i, j]
        extra_dims = (1,) * (table.ndim - 2)
    v00 = look(td, pd)
    v01 = look(td, pd + 1)
    v10 = look(td + 1, pd)
    v11 = look(td + 1, pd + 1)

    wt = wt.reshape(wt.shape + extra_dims)
    wp = wp.reshape(wp.shape + extra_dims)

    return (v00 * (1 - wp) * (1 - wt) + v01 * wp * (1 - wt)
            + v10 * (1 - wp) * wt + v11 * wp * wt)


def interpolate_opacity(ktable, scat_cross_table, temps, press, T, p):
    """Premixed opacity + Rayleigh cross-section interpolation
    (opac_interpol, kernels.cu:524-609).  Returns (opac [n, ...],
    scat_cross [n, nbin])."""
    opac = bilinear_tp(ktable, temps, press, T, p)
    scat = bilinear_tp(scat_cross_table, temps, press, T, p)
    return opac, scat


def interpolate_species_opacity(ktable, temps, press, T, p):
    """Per-species opacity interpolation (opac_species_interpol,
    kernels.cu:3209-3259; clamps to [0, n-1] instead of [0.001, ...])."""
    return bilinear_tp(ktable, temps, press, T, p, clamp_lo=0.0)


def interpolate_meanmolmass(meanmass_table, temps, press, T, p):
    """Mean molecular mass interpolation (kernels.cu:649-698)."""
    return bilinear_tp(meanmass_table, temps, press, T, p)


def interpolate_kappa(kappa_table, temps, press, T, p):
    """Adiabatic coefficient kappa(T, P), linear-T log-P (kernels.cu:703-756)."""
    return bilinear_tp(kappa_table, temps, press, T, p)


def interpolate_cp(cp_table, temps, press, T, p):
    """Heat capacity c_p(T, P), log-log (kernels.cu:761-810)."""
    return bilinear_tp(cp_table, temps, press, T, p, log_temp=True)


def interpolate_entropy(entropy_table, temps, press, T, p):
    """Entropy(T, P), log-log (kernels.cu:815-865)."""
    return bilinear_tp(entropy_table, temps, press, T, p, log_temp=True)


def interpolate_phase_number(state_table, temps, press, T, p):
    """Water phase state number, linear-T log-P (kernels.cu:869-919)."""
    return bilinear_tp(state_table, temps, press, T, p)

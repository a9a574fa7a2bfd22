"""Planck function utilities: band-integrated Planck table and lookups.

Port of :mod:`helios_tpu.planck` (reference kernels.cu:55-105, :362-416,
:923-1010).  The table is built in one vectorized pass (the 200-term
analytic series per bin edge, differenced across edges); lookups are
gathers with the reference's clamped linear interpolation.

The H100 computes fp64 natively, so lookups run in the grid's own dtype.
(On the TPU the JAX package gathers fp64 rows as two-float32 pairs; that
path reproduces native fp64 to about 1e-14 and has no counterpart here.)
"""

from __future__ import annotations

import torch

from helios_tpu_torch import constants as pc

_N_SERIES = 200  # reference kernels.cu:410: n = 1..199


def dB_dT(lamda, T):
    """Temperature derivative of the Planck function (kernels.cu:294-308).
    lamda**6 is written as the JAX package's integer power evaluates it."""
    l2 = lamda * lamda
    D = 2.0 * pc.H * pc.C ** 3 * pc.H / (l2 * (l2 * l2) * pc.K_B * T * T)
    e = torch.exp(pc.H * pc.C / (lamda * pc.K_B * T))
    return D * e / ((e - 1.0) * (e - 1.0))


def _series_antiderivative(y, n_terms=_N_SERIES):
    """S(y) = sum_{n=1}^{n_terms-1} exp(-n y)(y^3/n + 3y^2/n^2 + 6y/n^3 + 6/n^4).

    The powers of y are written as products, as the JAX package's integer
    powers evaluate them, so both packages round alike.
    """
    y2 = y * y
    y3 = y * y2
    acc = torch.zeros_like(y)
    for n in range(1, n_terms):
        dn = float(n)
        e = torch.exp(-dn * y)
        acc = acc + e * (y3 / dn + 3.0 * y2 / (dn * dn)
                         + 6.0 * y / (dn * (dn * dn))
                         + 6.0 / ((dn * dn) * (dn * dn)))
    return acc


def integrated_planck_over_bins(lambda_edge, delta_lambda, T):
    """Band-mean Planck function over wavelength bins for temperatures T.

    lambda_edge [nbin+1] (increasing), delta_lambda [nbin], T [...]
    -> [..., nbin] band-integrated B divided by bin width.
    """
    Tb = T[..., None]
    y_edge = pc.H * pc.C / (lambda_edge * pc.K_B * Tb)
    S = _series_antiderivative(y_edge)
    T2 = Tb * Tb
    D = (2.0 * (pc.K_B / pc.H) ** 3 * pc.K_B * (T2 * T2)) / (pc.C * pc.C)
    band = D * (S[..., 1:] - S[..., :-1])
    band = torch.where(Tb > 0.01, band, torch.zeros_like(band))
    return band / delta_lambda


def build_planck_table(lambda_edge, delta_lambda, T_star, dim: int = 8000,
                       step: int = 2):
    """Pre-tabulated band-integrated Planck grid [dim+1, nbin]: rows
    T_t = t*step + 1 for t = 0..dim-1, plus one row at T_star
    (reference kernels.cu:384-393).  dtype/device follow lambda_edge."""
    kw = dict(dtype=lambda_edge.dtype, device=lambda_edge.device)
    T_grid = torch.arange(dim, **kw) * step + 1.0
    T_all = torch.cat([T_grid, torch.tensor([T_star], **kw)])
    return integrated_planck_over_bins(lambda_edge, delta_lambda, T_all)


def interpolate_planck(planck_grid, T, dim: int, step: int):
    """Linear lookup of band Planck values at temperatures T -> [..., nbin].
    With a batch of P planets the grid is [dim+1, P, nbin] and T [..., P].

    Index math of kernels.cu:952-974: t = (T-1)/step clamped to
    [0.001, dim-1.001]."""
    t = (T - 1.0) / step
    t = torch.clamp(t, 0.001, dim - 1.001)
    tdown = torch.floor(t).long()
    w = (t - tdown)[..., None]
    if planck_grid.dim() == 3:
        # a batch's grids [dim+1, P, B]: T [..., P] looks up its own member
        member = torch.arange(planck_grid.shape[1], device=T.device)
        lo = planck_grid[tdown, member]
        hi = planck_grid[tdown + 1, member]
    else:
        # rows by index_select: a 0-d index tensor (the surface row) would
        # be read to the host by plain indexing
        rows = lambda i: planck_grid.index_select(0, i.reshape(-1)).reshape(
            i.shape + planck_grid.shape[1:])
        lo, hi = rows(tdown), rows(tdown + 1)
    return lo * (1.0 - w) + hi * w


def planckband_layers(planck_grid, T_lay, starflux, *, real_star: int,
                      dim: int, step: int):
    """[nlayer+2, nbin]: layer rows, the stellar row (starflux/pi or the
    tabulated B(T_star) row), and the surface row at T_lay[nlayer].  A
    batch of P planets gives [nlayer+2, P, nbin] from T_lay [nlayer+1, P],
    starflux [P, nbin] and grids [dim+1, P, nbin]."""
    nlayer = T_lay.shape[0] - 1
    lay_rows = interpolate_planck(planck_grid, T_lay[:nlayer], dim, step)
    surf_row = interpolate_planck(planck_grid, T_lay[nlayer], dim, step)
    if real_star:
        star_row = starflux / pc.PI
    else:
        star_row = planck_grid[dim]
    return torch.cat([lay_rows, star_row[None], surf_row[None]], dim=0)


def planckband_interfaces(planck_grid, T_int, *, dim: int, step: int):
    """Planck band values at interface temperatures: [ninterface, nbin]."""
    return interpolate_planck(planck_grid, T_int, dim, step)


def correct_incident_energy(planck_grid, starflux, delta_lambda, *,
                            real_star: int, T_star: float, dim: int):
    """Rescale the stellar spectrum / BB row so its integral equals
    sigma*T_star^4 (kernels.cu:420-468).  Returns (planck_grid, starflux,
    corr_factor)."""
    if real_star:
        num_flux = torch.sum(delta_lambda * starflux)
    else:
        num_flux = torch.sum(delta_lambda * pc.PI * planck_grid[dim])
    theo_flux = pc.SIGMA_SB * T_star ** 4.0
    corr = theo_flux / num_flux
    if real_star:
        starflux = starflux * corr
    else:
        planck_grid = planck_grid.clone()
        planck_grid[dim] = planck_grid[dim] * corr
    return planck_grid, starflux, corr

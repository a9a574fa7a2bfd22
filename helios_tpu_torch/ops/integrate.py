"""Spectral integration and post-processing reductions (port of
:mod:`helios_tpu.ops.integrate`; reference kernels.cu:2428-2513,
:2888-3139).

The band and total integration of the fluxes is
:func:`helios_tpu_torch.forward.integrate_flux_flat`; this module holds the
result type and the final-state diagnostics: band-integrated optical depth
and transmission, the contribution function and the mean opacities.  They
are plain weighted reductions over [..., B, Y] tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from helios_tpu_torch import constants as pc
from helios_tpu_torch.planck import dB_dT


def gauss_band(f_wg, gauss_weight):
    """Gauss-quadrature reduction over the y axis: 0.5 * sum_y w_y f.

    f_wg: [..., B, Y]; returns [..., B].  (kernels.cu:2474-2476)
    """
    return 0.5 * torch.sum(f_wg * gauss_weight, dim=-1)


class FluxTotals(NamedTuple):
    F_down_band: torch.Tensor   # [I, B] (excl. direct)
    F_up_band: torch.Tensor     # [I, B]
    F_dir_band: torch.Tensor    # [I, B]
    F_down_tot: torch.Tensor    # [I]  (incl. direct)
    F_up_tot: torch.Tensor      # [I]
    F_net: torch.Tensor         # [I]  F_up - F_down


def integrate_beamflux(F_dir_band, delta_lambda):
    """Total direct beam flux per interface (kernels.cu:3119-3139)."""
    return torch.sum(F_dir_band * delta_lambda, dim=-1)


def integrate_optdepth_transmission_iso(delta_tau_wg, trans_wg, gauss_weight):
    """Band-integrated optical depth and transmission (kernels.cu:2888-2912).

    Returns (delta_tau_band [L, B], trans_band [L, B]).
    """
    return (gauss_band(delta_tau_wg, gauss_weight),
            gauss_band(trans_wg, gauss_weight))


def integrate_optdepth_transmission_noniso(delta_tau_up, delta_tau_low,
                                           trans_up, trans_low, gauss_weight):
    """Non-isothermal variant (kernels.cu:2916-2946); the transmission of a
    full layer is the product of its half-layer transmissions."""
    return (gauss_band(delta_tau_up + delta_tau_low, gauss_weight),
            gauss_band(trans_up * trans_low, gauss_weight))


def contribution_function(trans_wg, planckband_lay, gauss_weight, epsi):
    """Contribution function 2 pi eps B (1 - T_i) prod_{j>i} T_j.

    kernels.cu:2951-3019.  trans_wg: [L, B, Y] full-layer transmission (for
    non-iso pass trans_up*trans_low).  Returns (trans_weight_band [L, B],
    contr_func_band [L, B]).
    """
    L = trans_wg.shape[0]
    # cumulative product of transmissions above each layer:
    # trans_to_top[i] = prod_{j>i} trans[j]
    log_t = torch.log(torch.clamp(trans_wg, min=1e-30))
    csum = torch.flip(torch.cumsum(torch.flip(log_t, [0]), dim=0), [0])
    trans_to_top = torch.exp(csum - log_t)              # exclude own layer
    tw = gauss_band((1.0 - trans_wg) * trans_to_top, gauss_weight)
    B_lay = planckband_lay[:L]
    contr = 2.0 * pc.PI * epsi * B_lay * tw
    return tw, contr


def mean_opacities(opac_wg_lay, cloud_abs_cross_lay, meanmolmass_lay,
                   planckband_lay, lambda_edge, delta_lambda, T_lay,
                   gauss_weight, gauss_y, T_star: float):
    """Planck and Rosseland mean opacities per layer (kernels.cu:3024-3115).

    Returns dict with planck/ross means weighted by B(T_lay) and B(T_star),
    plus the band-integrated opacity.
    """
    L = opac_wg_lay.shape[0]
    opac_band = gauss_band(opac_wg_lay, gauss_weight)          # [L, B]
    kappa_tot = opac_band + cloud_abs_cross_lay / meanmolmass_lay[:, None]

    B_lay = planckband_lay[:L]                                  # [L, B]
    B_star = planckband_lay[L]                                  # [B]

    def planck_mean(B):
        num = torch.sum(kappa_tot * B * delta_lambda, dim=-1)
        denom = torch.sum(B * delta_lambda, dim=-1)
        return num / denom

    # integrated dB/dT over each bin via Gauss-Legendre on [edge, edge+1]
    # (kernels.cu:312-329): x = (y-0.5)*2, arg = half-width*x + midpoint
    lam_bot = lambda_edge[:-1]
    lam_top = lambda_edge[1:]
    half = 0.5 * (lam_top - lam_bot)                            # [B]
    mid = 0.5 * (lam_top + lam_bot)
    x = (gauss_y - 0.5) * 2.0                                   # [Y]
    arg = half[:, None] * x[None, :] + mid[:, None]             # [B, Y]

    def ross_mean(T):
        # T: [L] or 0-d
        if T.dim() == 0:
            dB = dB_dT(arg, T)                                  # [B, Y]
            idB = (half * torch.sum(dB * gauss_weight, dim=-1))[None, :]
        else:
            dB = dB_dT(arg[None], T[:, None, None])             # [L, B, Y]
            idB = half[None] * torch.sum(dB * gauss_weight, dim=-1)
        num = torch.sum(idB, dim=-1)
        denom = torch.sum(torch.where(kappa_tot > 0, idB / kappa_tot, 0.0),
                          dim=-1)
        return num / denom

    T_pl = T_lay[:L]
    planck_T_pl = planck_mean(B_lay)
    ross_T_pl = torch.where(T_pl < 70.0, -3.0, ross_mean(T_pl))
    if T_star < 70.0:
        planck_T_star = torch.full((L,), -3.0, dtype=opac_band.dtype,
                                   device=opac_band.device)
        ross_T_star = planck_T_star.clone()
    else:
        T_s = torch.tensor(T_star, dtype=opac_band.dtype,
                           device=opac_band.device)
        planck_T_star = planck_mean(B_star[None, :]).expand(L)
        ross_T_star = ross_mean(T_s).expand(L)

    return dict(opac_band_lay=opac_band,
                planck_opac_T_pl=planck_T_pl, ross_opac_T_pl=ross_T_pl,
                planck_opac_T_star=planck_T_star,
                ross_opac_T_star=ross_T_star)

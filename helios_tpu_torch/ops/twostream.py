"""Two-stream cell quantities: w0, transmission, coupling terms.

Port of the device helpers of :mod:`helios_tpu.ops.twostream` (reference
kernels.cu:109-331) as elementwise tensor expressions.  Expressions keep
the JAX package's operation order so both round alike.
"""

from __future__ import annotations

import torch


def E_parameter(w0, g0, i2s_transition):
    """Improved two-stream correction E(w0, g0), Heng/Malik/Kitzmann 2018
    (kernels.cu:109-124)."""
    E_fit = torch.clamp(
        1.225 - 0.1582 * g0 - 0.1777 * w0 - 0.07465 * (g0 * g0)
        + 0.2351 * w0 * g0 - 0.05582 * (w0 * w0), min=1.0)
    return torch.where((w0 > i2s_transition) & (g0 >= 0), E_fit,
                       torch.ones_like(E_fit))


def E_maybe(w0, g0, scat_corr: int, i2s_transition):
    if scat_corr:
        return E_parameter(w0, g0, i2s_transition)
    return torch.ones_like(w0)


def single_scat_albedo(scat_cross, abs_cross, w_0_limit):
    """w0 = min(sigma_s/(sigma_s+sigma_a), limit) (kernels.cu:249-256)."""
    return torch.clamp(scat_cross / (scat_cross + abs_cross), max=w_0_limit)


def trans_func(epsi, delta_tau, w0, g0, scat_corr: int, i2s_transition):
    """T = exp(-(1/eps)*sqrt(E(1-w0 g0)(E-w0))*dtau) (kernels.cu:128-145)."""
    E = E_maybe(w0, g0, scat_corr, i2s_transition)
    return torch.exp(-1.0 / epsi * torch.sqrt(E * (1.0 - w0 * g0) * (E - w0))
                     * delta_tau)


def zeta_minus(w0, g0, scat_corr: int, i2s_transition):
    E = E_maybe(w0, g0, scat_corr, i2s_transition)
    return 0.5 * (1.0 - torch.sqrt((E - w0) / (E * (1.0 - w0 * g0))))


def zeta_plus(w0, g0, scat_corr: int, i2s_transition):
    E = E_maybe(w0, g0, scat_corr, i2s_transition)
    return 0.5 * (1.0 + torch.sqrt((E - w0) / (E * (1.0 - w0 * g0))))


def _G_pm(w0, g0, epsi, epsi2, mu_star, scat_corr: int, i2s_transition,
          sign: float):
    """G+ (sign=+1) / G- (sign=-1) coupling coefficients
    (kernels.cu:149-213), with the JAX package's sign-preserving floor on
    an exactly-zero resonance denominator."""
    E = E_maybe(w0, g0, scat_corr, i2s_transition)
    num = w0 * (E * (1.0 - w0 * g0) + g0 * epsi / epsi2)
    denom = E * epsi ** -2.0 * (E - w0) * (1.0 - w0 * g0) - mu_star ** -2.0
    denom = torch.where(denom == 0.0, torch.full_like(denom, 1e-30), denom)
    second = 1.0 / epsi + sign * 1.0 / (mu_star * E * (1.0 - w0 * g0))
    third = epsi * w0 * g0 * mu_star / (epsi2 * E * (1.0 - w0 * g0))
    return 0.5 * (num / denom * second + sign * third)


def G_limiter(G):
    """Clamp |G| <= 1e8 (kernels.cu:218-231)."""
    return torch.where(torch.abs(G) < 1e8, G, 1e8 * torch.sign(G))


def g0_total(scat_cross, g_0_clouds, scat_cross_clouds, g_0: float):
    """Scattering-weighted mean asymmetry of gas + clouds
    (calc_total_g_0_of_gas_and_clouds, kernels.cu:472-492).  [L_or_I, B]."""
    num = g_0 * scat_cross + g_0_clouds * scat_cross_clouds
    denom = scat_cross + scat_cross_clouds
    return num / denom

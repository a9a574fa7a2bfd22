"""Flat-layout per-iteration pipeline on [.., S] tensors, S = nbin * ny
(port of :mod:`helios_tpu.fastpath`, isothermal and non-isothermal paths).

Ordering s = b * ny + y (bin-major).  Every [L, S] array is row-major with
s fastest, which is the layout the CUDA sweep reads coalesced.

A batch of P planets puts the planet axis between the layer axis and the
spectral axis: [L, P, S] and boundary rows [P, S], per-layer arrays [L, P].
A contiguous [L, P, S] tensor is the [L, P*S] layout of the kernels, so one
launch solves the P*S columns of the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from helios_tpu_torch import constants as pc
from helios_tpu_torch.kernels.ordered import ordered_cumsum
from helios_tpu_torch.kernels.sweep import iso_sweep, noniso_sweep
from helios_tpu_torch.ops.twostream import (E_maybe, G_limiter, _G_pm,
                                            single_scat_albedo, trans_func,
                                            zeta_minus, zeta_plus)


def band_to_flat(x_band, ny: int):
    """[.., B] -> [.., B*ny] repeating each band value over its y-points."""
    return torch.repeat_interleave(x_band, ny, dim=-1)


def flat_to_cube(x, ny: int):
    """[.., S] -> [.., B, Y]."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // ny, ny))


class FlatCells(NamedTuple):
    """Per-cell two-stream quantities, flat layout [L, S]."""
    w0: torch.Tensor
    delta_tau: torch.Tensor         # gas-only optical depth
    delta_tau_total: torch.Tensor   # gas + clouds
    trans: torch.Tensor
    M: torch.Tensor
    N: torch.Tensor
    P: torch.Tensor
    G_pl: torch.Tensor
    G_min: torch.Tensor
    g0: torch.Tensor                # effective asymmetry, flat


def cell_quantities_flat(opac_flat, meanmolmass, ray_band, cloud_abs_band,
                         cloud_scat_band, delta_colmass, g0_band, ny, *,
                         epsi, epsi2, mu_star, w_0_limit, scat_corr,
                         i2s_transition) -> FlatCells:
    """calc_trans cell quantities (kernels.cu:1015-1104) on flat arrays.

    opac_flat: [L, S]; per-band inputs [L, B]; delta_colmass/meanmolmass
    [L]; returns FlatCells with [L, S] members (a batch: [L, P, S], [L, P,
    B] and [L, P]).
    """
    mmm = meanmolmass[..., None]
    dcm = delta_colmass[..., None]

    scat_tot = band_to_flat(ray_band + cloud_scat_band, ny)
    cloud_abs = band_to_flat(cloud_abs_band, ny)
    abs_tot = opac_flat * mmm + cloud_abs
    w0 = single_scat_albedo(scat_tot, abs_tot, w_0_limit)

    delta_tau = dcm * (opac_flat + band_to_flat(ray_band, ny) / mmm)
    delta_tau_clouds = (dcm * band_to_flat(
        cloud_abs_band + cloud_scat_band, ny) / mmm)
    del_tau = delta_tau + delta_tau_clouds

    g0 = band_to_flat(g0_band, ny)
    trans = trans_func(epsi, del_tau, w0, g0, scat_corr, i2s_transition)
    zm = zeta_minus(w0, g0, scat_corr, i2s_transition)
    zp = zeta_plus(w0, g0, scat_corr, i2s_transition)

    M = zm * zm * trans * trans - zp * zp
    N = zp * zm * (1.0 - trans * trans)
    P = (zm * zm - zp * zp) * trans

    G_pl = G_limiter(_G_pm(w0, g0, epsi, epsi2, mu_star, scat_corr,
                           i2s_transition, +1.0))
    G_min = G_limiter(_G_pm(w0, g0, epsi, epsi2, mu_star, scat_corr,
                            i2s_transition, -1.0))

    return FlatCells(w0=w0, delta_tau=delta_tau, delta_tau_total=del_tau,
                     trans=trans, M=M, N=N, P=P, G_pl=G_pl, G_min=G_min,
                     g0=g0)


# --------------------------------------------------------------------------- #
# direct beam
# --------------------------------------------------------------------------- #

def _rev_cumsum_above(dtau):
    """[L, S] -> [L+1, S]: row i = sum of dtau over layers l >= i (the
    optical depth above interface i); row L (TOA) is zero."""
    rev = torch.flip(ordered_cumsum(torch.flip(dtau, [0]), 0), [0])
    return torch.cat([rev, torch.zeros_like(dtau[:1])], dim=0)


def mu_star_matrix(z_lay, mu_star, R_planet, ninterface: int):
    """mu(i, j) [I, L]: the zenith cosine seen at interface i through layer
    j with the geometric zenith-angle correction (ops/beam.py:26-41 of
    helios_tpu; reference kernels.cu:1296-1303).  As in the reference,
    interface i is paired with layer centre i (z has L entries, so the top
    interface reuses the top layer's z; no layer lies above it).  mu* is
    negative, and so is the root.  A batch's z_lay [L, P] gives [I, L,
    P]."""
    z_i = torch.cat([z_lay, z_lay[-1:]])                 # [I]
    ratio = (R_planet + z_i[:, None]) / (R_planet + z_lay[None])
    return -torch.sqrt(1.0 - ratio ** 2 * (1.0 - mu_star ** 2))


def beam_exponent(weights, dtau):
    """sum_j weights[i, j] dtau[j]: [I, L] @ [L, S], or per member of a
    batch, [I, L, P] and [L, P, S] -> [I, P, S] (the weights follow each
    member's altitudes)."""
    if weights.dim() == 2:
        return torch.matmul(weights, dtau)
    return torch.matmul(weights.permute(2, 0, 1),
                        dtau.transpose(0, 1)).transpose(0, 1)


def fdir_iso_flat(planck_star_flat, delta_tau_tot, mu_weights, *,
                  mu_star, R_star, a, dir_beam):
    """Flat isothermal direct beam: F_dir [I, S].  ``mu_weights=None``:
    plain mu*, the exponent a cumulative optical depth above each
    interface.  ``mu_weights`` [I, L], the masked 1/mu(i, j) of the
    geometric zenith correction: the exponent is one matrix product
    mu_weights @ delta_tau (O(L^2 S), no [I, L, S] intermediate)."""
    I_dir = (R_star / a) ** 2 * pc.PI * planck_star_flat   # [S]
    if mu_weights is None:
        expo = _rev_cumsum_above(delta_tau_tot) / mu_star
    else:
        expo = beam_exponent(mu_weights, delta_tau_tot)
    F0 = -dir_beam * mu_star * I_dir
    return F0[None, :] * torch.exp(expo)


def fdir_noniso_flat(planck_star_flat, dtau_up, dtau_low, mu_weights,
                     mu_diag, *, mu_star, R_star, a, dir_beam):
    """Flat non-isothermal direct beam: (F_dir [I,S], Fc_dir [L,S]).
    ``mu_weights=None``: plain mu*, cumulative optical depths.  Else
    ``mu_weights`` [I, L] is the masked 1/mu(i, j) and ``mu_diag`` [L]
    mu(i, i) of the geometric zenith correction, and the exponents are
    matrix products as in fdir_iso_flat."""
    I_dir = (R_star / a) ** 2 * pc.PI * planck_star_flat
    dtau_full = dtau_up + dtau_low
    F0 = -dir_beam * mu_star * I_dir
    if mu_weights is None:
        above = _rev_cumsum_above(dtau_full)
        F_dir = F0[None, :] * torch.exp(above / mu_star)
        # Fc_dir[i]: full layers strictly above i + upper half of layer i
        Fc_dir = F0[None, :] * torch.exp((above[1:] + dtau_up) / mu_star)
        return F_dir, Fc_dir

    F_dir = F0[None, :] * torch.exp(beam_exponent(mu_weights, dtau_full))
    L = dtau_up.shape[0]
    idx = torch.arange(L, device=dtau_up.device)
    above = idx[None, :] > idx[:, None]
    above = above.reshape(above.shape + (1,) * (mu_weights.dim() - 2))
    W_above = torch.where(above, mu_weights[:L],
                          torch.zeros_like(mu_weights[:L]))
    expo_c = (beam_exponent(W_above, dtau_full)
              + dtau_up / mu_diag[..., None])
    return F_dir, F0[None, :] * torch.exp(expo_c)


# --------------------------------------------------------------------------- #
# iterative isothermal sweep
# --------------------------------------------------------------------------- #

class FlatIsoCoeffs(NamedTuple):
    a: torch.Tensor          # P/M        [L, S]
    b_nm: torch.Tensor       # -N/M       [L, S]
    src_down: torch.Tensor   # [L, S]
    src_up: torch.Tensor     # [L, S]
    boa_refl: torch.Tensor   # [S]
    boa_emis: torch.Tensor   # [S]
    toa: torch.Tensor        # [S]


class IsoCoeffCache(NamedTuple):
    """The temperature-independent part of FlatIsoCoeffs, refreshed with
    the cell cache (every 10th iteration).  Every source term is linear in
    the Planck arrays, so the per-iteration work is two fmas and a mul:
      src_down = planck_coeff * B_lay + dir_down
      src_up   = planck_coeff * B_lay + dir_up
      boa_emis = boa_coeff * B_surf
    """
    a: torch.Tensor             # P/M                       [L, S]
    b_nm: torch.Tensor          # -N/M                      [L, S]
    planck_coeff: torch.Tensor  # 2*pi*eps*(1-w0)/(E-w0)*(N+M-P)/M  [L, S]
    dir_down: torch.Tensor      # min(0, ...)/M             [L, S]
    dir_up: torch.Tensor        # min(0, ...)/M             [L, S]
    boa_coeff: torch.Tensor     # (1-alb)*pi*(1-w0_0)/(E_0-w0_0)  [S]
    boa_refl: torch.Tensor      # [S]
    toa: torch.Tensor           # [S] (star row is iteration-invariant)


def iso_coeff_cache(cells: FlatCells, planck_star_flat, F_dir,
                    surf_albedo_flat, *, scat_corr, i2s_transition, epsi,
                    mu_star, dir_beam, f_factor, R_star, a
                    ) -> IsoCoeffCache:
    """Precompute the static iso sweep coefficients (Planck-linear form)."""
    w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
    G_pl, G_min = cells.G_pl, cells.G_min
    E = E_maybe(w0, cells.g0, scat_corr, i2s_transition)

    planck_coeff = (2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0)
                    * (N + M - P)) / M
    inv_neg_mu = 1.0 / (-mu_star)
    zero = torch.zeros((), dtype=F_dir.dtype, device=F_dir.device)
    Fd_top, Fd_bot = F_dir[1:], F_dir[:-1]
    dir_down = torch.minimum(
        zero, Fd_bot * inv_neg_mu * (G_min * M + G_pl * N)
        - Fd_top * inv_neg_mu * P * G_min) / M
    dir_up = torch.minimum(
        zero, Fd_top * inv_neg_mu * (G_min * N + G_pl * M)
        - Fd_bot * inv_neg_mu * P * G_pl) / M

    boa_coeff = ((1.0 - surf_albedo_flat) * pc.PI
                 * (1.0 - w0[0]) / (E[0] - w0[0]))
    toa = ((1.0 - dir_beam) * f_factor * (R_star / a) ** 2 * pc.PI
           * planck_star_flat)
    return IsoCoeffCache(a=P / M, b_nm=-N / M, planck_coeff=planck_coeff,
                         dir_down=dir_down, dir_up=dir_up,
                         boa_coeff=boa_coeff, boa_refl=surf_albedo_flat,
                         toa=toa)


def iso_coeffs_from_cache(cc: IsoCoeffCache, planck_lay_flat,
                          planck_surf_flat) -> FlatIsoCoeffs:
    """Assemble the per-iteration FlatIsoCoeffs: two fmas + one mul."""
    return FlatIsoCoeffs(
        a=cc.a, b_nm=cc.b_nm,
        src_down=cc.planck_coeff * planck_lay_flat + cc.dir_down,
        src_up=cc.planck_coeff * planck_lay_flat + cc.dir_up,
        boa_refl=cc.boa_refl,
        boa_emis=cc.boa_coeff * planck_surf_flat,
        toa=cc.toa)


def columns(x):
    """[n, P, S] -> the kernels' [n, P*S] view (no copy when contiguous);
    [n, S] as it is."""
    return x.reshape(x.shape[0], -1)


def fband_iso_flat(C: FlatIsoCoeffs, F_dir0, F_up_prev, *, n_passes: int):
    """Iterative iso solve (flat): the CUDA sweep kernel for CUDA tensors,
    its plain version for CPU tensors.  Returns (F_down, F_up) [I, S]; a
    batch's [I, P, S] from one launch over its P*S columns."""
    F_down, F_up = iso_sweep(
        columns(C.a), columns(C.b_nm), columns(C.src_down),
        columns(C.src_up), C.toa.reshape(-1), C.boa_refl.reshape(-1),
        C.boa_emis.reshape(-1), F_dir0.reshape(-1), columns(F_up_prev),
        n_passes=n_passes)
    return F_down.view(F_up_prev.shape), F_up.view(F_up_prev.shape)


# --------------------------------------------------------------------------- #
# iterative non-isothermal sweep
# --------------------------------------------------------------------------- #

class FlatNonIsoCoeffs(NamedTuple):
    a_up: torch.Tensor
    b_up: torch.Tensor
    src_up_down: torch.Tensor
    src_up_up: torch.Tensor
    a_low: torch.Tensor
    b_low: torch.Tensor
    src_low_down: torch.Tensor
    src_low_up: torch.Tensor
    boa_refl: torch.Tensor
    boa_emis: torch.Tensor
    toa: torch.Tensor


class NonIsoCoeffCache(NamedTuple):
    """Temperature-independent non-iso sweep coefficients, refreshed with
    the cell cache (every 10th iteration).  Every source term is linear in
    its two Planck inputs: per direction/half
        src = At * Bt + Ab * Bb + D
    with (Bt, Bb) drawn per half from (B_lay, B_int_above, B_int_below).
    """
    a_up: torch.Tensor
    b_up: torch.Tensor
    a_low: torch.Tensor
    b_low: torch.Tensor
    # src_up_down: Bt = B_lay, Bb = B_int_above
    At_ud: torch.Tensor
    Ab_ud: torch.Tensor
    D_ud: torch.Tensor
    # src_up_up: Bt = B_int_above, Bb = B_lay
    At_uu: torch.Tensor
    Ab_uu: torch.Tensor
    D_uu: torch.Tensor
    # src_low_down: Bt = B_int_below, Bb = B_lay
    At_ld: torch.Tensor
    Ab_ld: torch.Tensor
    D_ld: torch.Tensor
    # src_low_up: Bt = B_lay, Bb = B_int_below
    At_lu: torch.Tensor
    Ab_lu: torch.Tensor
    D_lu: torch.Tensor
    boa_coeff: torch.Tensor     # [S]
    boa_refl: torch.Tensor      # [S]
    toa: torch.Tensor           # [S]


def _noniso_planck_linear(M, N, P, del_tau, epsi, E, w0, g0,
                          delta_tau_limit):
    """(alpha_t, alpha_b) with planck_terms = alpha_t*Bt + alpha_b*Bb.

    Both sweep directions share these coefficients (the direction sign
    cancels); they differ only in which Planck arrays feed (Bt, Bb)."""
    iso_c = 0.5 * (N + M - P)
    c_over_d = (epsi / (E * (1.0 - w0 * g0))
                / torch.clamp(del_tau, min=1e-30) * (M - N - P))
    a_t = (M + N) - c_over_d
    a_b = -P + c_over_d
    small = del_tau < delta_tau_limit
    return torch.where(small, iso_c, a_t), torch.where(small, iso_c, a_b)


def noniso_coeff_cache(upper: FlatCells, lower: FlatCells, B_star,
                       F_dir, Fc_dir, surf_albedo_flat, *, scat_corr,
                       i2s_transition, epsi, mu_star, dir_beam, f_factor,
                       R_star, a, delta_tau_limit) -> NonIsoCoeffCache:
    """Precompute the static non-iso coefficients (Planck-linear form)."""
    inv_neg_mu = 1.0 / (-mu_star)
    zero = torch.zeros((), dtype=F_dir.dtype, device=F_dir.device)
    out = {}
    for half, cells in (("up", upper), ("low", lower)):
        w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
        G_pl, G_min = cells.G_pl, cells.G_min
        E = E_maybe(w0, cells.g0, scat_corr, i2s_transition)
        del_tau = cells.delta_tau_total
        pref_M = 2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0) / M

        at, ab = _noniso_planck_linear(
            M, N, P, del_tau, epsi, E, w0, cells.g0, delta_tau_limit)

        if half == "up":
            dir_down = torch.minimum(
                zero, Fc_dir * inv_neg_mu * (G_min * M + G_pl * N)
                - F_dir[1:] * inv_neg_mu * G_min * P)
            dir_up = torch.minimum(
                zero, F_dir[1:] * inv_neg_mu * (G_min * N + G_pl * M)
                - Fc_dir * inv_neg_mu * P * G_pl)
        else:
            dir_down = torch.minimum(
                zero, F_dir[:-1] * inv_neg_mu * (G_min * M + G_pl * N)
                - Fc_dir * inv_neg_mu * P * G_min)
            dir_up = torch.minimum(
                zero, Fc_dir * inv_neg_mu * (G_min * N + G_pl * M)
                - F_dir[:-1] * inv_neg_mu * P * G_pl)
            w0_0, E_0 = w0[0], E[0]

        out[f"a_{half}"] = P / M
        out[f"b_{half}"] = -N / M
        k = "u" if half == "up" else "l"
        out[f"At_{k}d"] = pref_M * at
        out[f"Ab_{k}d"] = pref_M * ab
        out[f"D_{k}d"] = dir_down / M
        out[f"At_{k}u"] = out[f"At_{k}d"]
        out[f"Ab_{k}u"] = out[f"Ab_{k}d"]
        out[f"D_{k}u"] = dir_up / M

    boa_coeff = ((1.0 - surf_albedo_flat) * pc.PI
                 * (1.0 - w0_0) / (E_0 - w0_0))
    toa = ((1.0 - dir_beam) * f_factor * (R_star / a) ** 2 * pc.PI
           * B_star)
    return NonIsoCoeffCache(boa_coeff=boa_coeff, boa_refl=surf_albedo_flat,
                            toa=toa, **out)


def noniso_coeffs_from_cache(cc: NonIsoCoeffCache, B_lay, B_int_below,
                             B_int_above, B_surf) -> FlatNonIsoCoeffs:
    """Assemble the per-iteration FlatNonIsoCoeffs: 4 x (2 fma) + 1 mul."""
    return FlatNonIsoCoeffs(
        a_up=cc.a_up, b_up=cc.b_up,
        src_up_down=cc.At_ud * B_lay + cc.Ab_ud * B_int_above + cc.D_ud,
        src_up_up=cc.At_uu * B_int_above + cc.Ab_uu * B_lay + cc.D_uu,
        a_low=cc.a_low, b_low=cc.b_low,
        src_low_down=cc.At_ld * B_int_below + cc.Ab_ld * B_lay + cc.D_ld,
        src_low_up=cc.At_lu * B_lay + cc.Ab_lu * B_int_below + cc.D_lu,
        boa_refl=cc.boa_refl,
        boa_emis=cc.boa_coeff * B_surf,
        toa=cc.toa)


def fband_noniso_flat(C: FlatNonIsoCoeffs, F_dir0, F_up_prev, Fc_up_prev,
                      *, n_passes: int):
    """Iterative non-iso solve (flat): the CUDA sweep kernel for CUDA
    tensors, its plain version for CPU tensors.  Returns (F_down, F_up,
    Fc_down, Fc_up); a batch's from one launch over its P*S columns."""
    lay = [columns(x) for x in (C.a_up, C.b_up, C.src_up_down, C.src_up_up,
                                C.a_low, C.b_low, C.src_low_down,
                                C.src_low_up)]
    rows = [x.reshape(-1) for x in (C.toa, C.boa_refl, C.boa_emis, F_dir0)]
    F_down, F_up, Fc_down, Fc_up = noniso_sweep(
        *lay, *rows, columns(F_up_prev), columns(Fc_up_prev),
        n_passes=n_passes)
    I_shape, L_shape = F_up_prev.shape, Fc_up_prev.shape
    return (F_down.view(I_shape), F_up.view(I_shape), Fc_down.view(L_shape),
            Fc_up.view(L_shape))

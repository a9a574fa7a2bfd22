"""The matrix flux method: the exact coupled flux solve by tridiagonal
(Thomas) elimination (port of :mod:`helios_tpu.ops.thomas`; reference
fband_matrix_iso / fband_matrix_noniso, kernels.cu:1803-2424).

The interleaved up/down flux system of each spectral column is a
tridiagonal system of 2 (L+1) rows (iso) or 4 (L+1) - 2 rows (non-iso).
Its diagonals are assembled here as [n, S] tensors in the flat layout
(S = nbin * ny, one system per column) and solved by
:func:`helios_tpu_torch.kernels.thomas.thomas_solve`, the CUDA kernel on
the card.  As in the reference, the sub-diagonal is the previous row's
super-diagonal (a_i = c_{i-1}, kernels.cu:1928-1950).

Columns whose ``scat_trigger`` is unset take the pure-absorption
recurrences instead (kernels.cu:1969-2022, :2286-2421).  Those are one
pass of the iterative sweeps with the scattering coupling set to zero, so
they run through the sweep kernels (``n_passes=1``, ``b = 0``); both
results are computed for every column and a ``where`` selects.

A batch of P planets ([L, P, S] cells, boundary rows [P, S]) assembles the
same rows over its P*S columns: one Thomas solve and one sweep per flux
solve for the whole batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from helios_tpu_torch import constants as pc
from helios_tpu_torch import fastpath as fp
from helios_tpu_torch.kernels.sweep import iso_sweep, noniso_sweep
from helios_tpu_torch.kernels.thomas import thomas_solve
from helios_tpu_torch.ops.twostream import E_maybe


def toa_incident_flux(planckband_lay, *, dir_beam, f_factor, R_star, a):
    """TOA downward boundary flux (kernels.cu:1420).  [B]."""
    nlayer = planckband_lay.shape[0] - 2
    return ((1.0 - dir_beam) * f_factor * (R_star / a) ** 2 * pc.PI
            * planckband_lay[nlayer])


def _noniso_planck_terms(Bt, Bb, M, N, P, del_tau, epsi, E, w0, g0,
                         delta_tau_limit, up_direction: bool):
    """Linear-in-tau Planck source across a half-layer, with the isothermal
    fallback at small optical depth (kernels.cu:1640-1780), in the
    operation order of helios_tpu.ops.sweep._noniso_planck_terms:
      iso branch: (Bt + Bb)/2 * (N + M - P)
      down:  Bt*(M+N) - Bb*P + epsi/(E(1-w0 g0)) * (P - M + N) * (Bt-Bb)/dtau
      up:    Bt*(M+N) - Bb*P + epsi/(E(1-w0 g0)) * (M - N - P) * (Bb-Bt)/dtau
    """
    iso_term = 0.5 * (Bt + Bb) * (N + M - P)
    grad = (Bt - Bb) / torch.clamp(del_tau, min=1e-30)
    if up_direction:
        noniso_term = (Bt * (M + N) - Bb * P
                       + epsi / (E * (1.0 - w0 * g0)) * (M - N - P) * (-grad))
    else:
        noniso_term = (Bt * (M + N) - Bb * P
                       + epsi / (E * (1.0 - w0 * g0)) * (P - M + N) * grad)
    return torch.where(del_tau < delta_tau_limit, iso_term, noniso_term)


def _interleave(rows):
    """Stack k row-arrays [L, S] into [k*L, S] with row-major interleaving
    (row j of layer l lands at index k*l + j)."""
    stacked = torch.stack(rows, dim=1)            # [L, k, S]
    return stacked.reshape((-1,) + stacked.shape[2:])


def _band_rows(planckband_lay, surf_albedo, S, *, dir_beam, f_factor,
               R_star, a):
    """(toa, B_surf, albedo) per spectral column [S], and ny."""
    ny = S // planckband_lay.shape[-1]
    nlayer = planckband_lay.shape[0] - 2
    toa = toa_incident_flux(planckband_lay, dir_beam=dir_beam,
                            f_factor=f_factor, R_star=R_star, a=a)
    return (fp.band_to_flat(toa, ny),
            fp.band_to_flat(planckband_lay[nlayer + 1], ny),
            fp.band_to_flat(surf_albedo, ny), ny)


def _solve(b_rows, c_rows, d_rows, alb, src_boa, toa):
    """Thomas solve of the assembled rows:
      row 0:          b = -albedo, c = 1, d = src_boa
      rows 1..n-2:    the interleaved layer rows
      row n-1:        b = 0,       c = 0, d = toa."""
    one = torch.ones_like(alb)[None]
    zero = torch.zeros_like(alb)[None]
    b = torch.cat([-alb[None], b_rows, zero])
    c = torch.cat([one, c_rows, zero])
    d = torch.cat([src_boa[None], d_rows, toa[None]])
    return thomas_solve(fp.columns(b), fp.columns(c),
                        fp.columns(d)).view(d.shape)


def fband_matrix_iso(cells: fp.FlatCells, planckband_lay, F_dir,
                     surf_albedo, scat_trigger, *, scat_corr: int,
                     i2s_transition: float, epsi: float, mu_star: float,
                     dir_beam: int, f_factor: float, R_star: float, a: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Isothermal Thomas-method flux solve (kernels.cu:1803-2024).

    cells: FlatCells [L, S]; planckband_lay [L+2, B]; F_dir [L+1, S];
    surf_albedo [B]; scat_trigger [S] bool.  Returns (F_down, F_up):
    [L+1, S].
    """
    L, S = cells.M.shape[0], cells.M.shape[-1]
    w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
    G_pl, G_min = cells.G_pl, cells.G_min
    E = E_maybe(w0, cells.g0, scat_corr, i2s_transition)
    inv_neg_mu = 1.0 / (-mu_star)
    toa, B_surf, alb, ny = _band_rows(planckband_lay, surf_albedo, S,
                                      dir_beam=dir_beam, f_factor=f_factor,
                                      R_star=R_star, a=a)
    zero = torch.zeros((), dtype=M.dtype, device=M.device)

    alpha = P / M
    beta = -N / M
    B_lay = fp.band_to_flat(planckband_lay[:L], ny)
    planck = (2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0)
              * (N + M - P) * B_lay)
    dir_down = torch.minimum(
        zero, F_dir[:-1] * inv_neg_mu * (G_min * M + G_pl * N)
        - F_dir[1:] * inv_neg_mu * P * G_min)
    dir_up = torch.minimum(
        zero, F_dir[1:] * inv_neg_mu * (G_min * N + G_pl * M)
        - F_dir[:-1] * inv_neg_mu * P * G_pl)
    src_down = (planck + dir_down) / M
    src_up = (planck + dir_up) / M
    src_boa = (alb * F_dir[0]
               + (1.0 - alb) * pc.PI * (1.0 - w0[0]) / (E[0] - w0[0])
               * B_surf)

    # matrix rows, n = 2 (L+1) (kernels.cu:1916-1950):
    #   odd i:       b = -beta[j], c = -alpha[j], d = src_down[j], j = (i-1)/2
    #   even i > 0:  b = -beta[j], c = 1,         d = src_up[j],   j = i/2-1
    x = _solve(_interleave([-beta, -beta]),
               _interleave([-alpha, torch.ones_like(alpha)]),
               _interleave([src_down, src_up]), alb, src_boa, toa)

    # pure-absorption fallback (kernels.cu:1969-2022): one pass of the iso
    # sweep without the scattering coupling
    src = 2.0 * pc.PI * epsi * (1.0 - cells.trans) * B_lay
    col = fp.columns
    F_down_abs, F_up_abs = iso_sweep(
        col(cells.trans), col(torch.zeros_like(src)), col(src), col(src),
        toa.reshape(-1), alb.reshape(-1),
        ((1.0 - alb) * pc.PI * B_surf).reshape(-1), F_dir[0].reshape(-1),
        col(torch.zeros_like(F_dir)), n_passes=1)
    F_down_abs = F_down_abs.view(F_dir.shape)
    F_up_abs = F_up_abs.view(F_dir.shape)

    sel = scat_trigger[None]
    return (torch.where(sel, x[0::2], F_down_abs),
            torch.where(sel, x[1::2], F_up_abs))


def fband_matrix_noniso(upper: fp.FlatCells, lower: fp.FlatCells,
                        planckband_lay, planckband_int, F_dir, Fc_dir,
                        surf_albedo, scat_trigger, *, scat_corr: int,
                        i2s_transition: float, epsi: float, mu_star: float,
                        dir_beam: int, f_factor: float, R_star: float,
                        a: float, delta_tau_limit: float):
    """Non-isothermal Thomas-method flux solve (kernels.cu:2028-2424).

    upper/lower: FlatCells [L, S]; planckband_lay [L+2, B];
    planckband_int [L+1, B]; F_dir [L+1, S]; Fc_dir [L, S]; surf_albedo
    [B]; scat_trigger [S] bool.  Returns (F_down, F_up, Fc_down, Fc_up).
    """
    L, S = upper.M.shape[0], upper.M.shape[-1]
    inv_neg_mu = 1.0 / (-mu_star)
    toa, B_surf, alb, ny = _band_rows(planckband_lay, surf_albedo, S,
                                      dir_beam=dir_beam, f_factor=f_factor,
                                      R_star=R_star, a=a)
    zero = torch.zeros((), dtype=upper.M.dtype, device=upper.M.device)

    B_lay = fp.band_to_flat(planckband_lay[:L], ny)
    B_int = fp.band_to_flat(planckband_int, ny)
    B_int_below, B_int_above = B_int[:-1], B_int[1:]

    # per-half coefficient rows j: even j = lower half, odd j = upper half
    halves = {}
    for name, cells in (("low", lower), ("up", upper)):
        w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
        G_pl, G_min = cells.G_pl, cells.G_min
        g0 = cells.g0
        E = E_maybe(w0, g0, scat_corr, i2s_transition)
        del_tau = cells.delta_tau_total
        pref = 2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0)

        if name == "low":
            pl_down = _noniso_planck_terms(
                B_int_below, B_lay, M, N, P, del_tau, epsi, E, w0, g0,
                delta_tau_limit, False)
            pl_up = _noniso_planck_terms(
                B_lay, B_int_below, M, N, P, del_tau, epsi, E, w0, g0,
                delta_tau_limit, True)
            dir_down = torch.minimum(
                zero, F_dir[:-1] * inv_neg_mu * (G_min * M + G_pl * N)
                - Fc_dir * inv_neg_mu * P * G_min)
            dir_up = torch.minimum(
                zero, Fc_dir * inv_neg_mu * (G_min * N + G_pl * M)
                - F_dir[:-1] * inv_neg_mu * P * G_pl)
            w0_low0, E_low0 = w0[0], E[0]
        else:
            pl_down = _noniso_planck_terms(
                B_lay, B_int_above, M, N, P, del_tau, epsi, E, w0, g0,
                delta_tau_limit, False)
            pl_up = _noniso_planck_terms(
                B_int_above, B_lay, M, N, P, del_tau, epsi, E, w0, g0,
                delta_tau_limit, True)
            dir_down = torch.minimum(
                zero, Fc_dir * inv_neg_mu * (G_min * M + G_pl * N)
                - F_dir[1:] * inv_neg_mu * P * G_min)
            dir_up = torch.minimum(
                zero, F_dir[1:] * inv_neg_mu * (G_min * N + G_pl * M)
                - Fc_dir * inv_neg_mu * P * G_pl)

        halves[name] = dict(
            alpha=P / M, beta=-N / M,
            src_down=(pref * pl_down + dir_down) / M,
            src_up=(pref * pl_up + dir_up) / M)

    src_boa = (alb * F_dir[0]
               + (1.0 - alb) * pc.PI * (1.0 - w0_low0) / (E_low0 - w0_low0)
               * B_surf)

    # interleaved half-layer rows [2L]: even = lower, odd = upper; matrix
    # rows, n = 4 (L+1) - 2 (kernels.cu:2218-2252):
    #   odd i:  j = (i-1)/2: b = -beta_r[j], c = -alpha_r[j], d = srcd_r[j]
    #   even i: j = i/2-1:   b = -beta_r[j], c = 1,           d = srcu_r[j]
    lo, up = halves["low"], halves["up"]
    alpha_r = _interleave([lo["alpha"], up["alpha"]])
    beta_r = _interleave([lo["beta"], up["beta"]])
    srcd_r = _interleave([lo["src_down"], up["src_down"]])
    srcu_r = _interleave([lo["src_up"], up["src_up"]])
    x = _solve(_interleave([-beta_r, -beta_r]),
               _interleave([-alpha_r, torch.ones_like(alpha_r)]),
               _interleave([srcd_r, srcu_r]), alb, src_boa, toa)

    abs_ = _absorption_noniso(upper, lower, B_lay, B_int_below, B_int_above,
                              toa, F_dir, alb, B_surf, epsi=epsi,
                              delta_tau_limit=delta_tau_limit)
    # translate (kernels.cu:2272-2283): i%4 == 0 -> F_down[i/4], 1 -> F_up,
    # 2 -> Fc_down, 3 -> Fc_up; the last row n-1 = 4L+1 is 1 mod 4
    sel = scat_trigger[None]
    return tuple(torch.where(sel, x[k::4], f_abs)
                 for k, f_abs in enumerate(abs_))


def _absorption_noniso(upper, lower, B_lay, B_int_below, B_int_above, toa,
                       F_dir, alb, B_surf, *, epsi, delta_tau_limit):
    """Pure-absorption non-isothermal recurrences (kernels.cu:2294-2421),
    as one pass of the non-iso sweep without the scattering coupling:
      down: Fc_down[i] = t_up F_down[i+1] + 2 pi eps pl_up_down
            F_down[i]  = t_low Fc_down[i] + 2 pi eps pl_low_down
      up:   Fc_up[i]   = t_low F_up[i]    + 2 pi eps pl_low_up
            F_up[i+1]  = t_up Fc_up[i]    + 2 pi eps pl_up_up.
    Returns (F_down, F_up, Fc_down, Fc_up)."""
    t_up, dt_up = upper.trans, upper.delta_tau_total
    t_low, dt_low = lower.trans, lower.delta_tau_total

    def planck_down(trans, del_tau, B_from, B_to):
        iso_term = 0.5 * (B_from + B_to) * (1.0 - trans)
        grad = (B_from - B_to) / torch.clamp(del_tau, min=1e-30)
        noniso = B_from - trans * B_to + epsi * (trans - 1.0) * grad
        return torch.where(del_tau < delta_tau_limit, iso_term, noniso)

    pl_up_down = planck_down(t_up, dt_up, B_lay, B_int_above)
    pl_low_down = planck_down(t_low, dt_low, B_int_below, B_lay)
    # the reference's up-path gradients (kernels.cu:2356-2419)
    pl_low_up = torch.where(
        dt_low < delta_tau_limit,
        0.5 * (B_int_below + B_lay) * (1.0 - t_low),
        B_lay - t_low * B_int_below
        + epsi * ((B_int_below - B_lay) / torch.clamp(dt_low, min=1e-30))
        * (1.0 - t_low))
    pl_up_up = torch.where(
        dt_up < delta_tau_limit,
        0.5 * (B_int_above + B_lay) * (1.0 - t_up),
        B_int_above - t_up * B_lay
        + epsi * ((B_lay - B_int_above) / torch.clamp(dt_up, min=1e-30))
        * (1.0 - t_up))

    k = 2.0 * pc.PI * epsi
    col = fp.columns
    no_coupling = col(torch.zeros_like(t_up))
    F_down, F_up, Fc_down, Fc_up = noniso_sweep(
        col(t_up), no_coupling, col(k * pl_up_down), col(k * pl_up_up),
        col(t_low), no_coupling, col(k * pl_low_down), col(k * pl_low_up),
        toa.reshape(-1), alb.reshape(-1),
        ((1.0 - alb) * pc.PI * B_surf).reshape(-1), F_dir[0].reshape(-1),
        col(torch.zeros_like(F_dir)), col(torch.zeros_like(t_up)),
        n_passes=1)
    I_shape, L_shape = F_dir.shape, t_up.shape
    return (F_down.view(I_shape), F_up.view(I_shape), Fc_down.view(L_shape),
            Fc_up.view(L_shape))

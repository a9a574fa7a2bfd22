"""On-the-fly opacity mixing: correlated-k addition and Random Overlap
(port of :mod:`helios_tpu.ops.mixing`; reference add_to_mixed_opac,
kernels.cu:3263-3399, calc_h2o_scat, :3404-3440, and add_to_mixed_scat,
:3444-3459).

:func:`random_overlap_mix` is the plain PyTorch version of the Random
Overlap: a stable sort of the ny*ny pairwise sums, a cumulative sum of
their weights in index order, the rebin-index recurrence and a gather.
On the card, :func:`add_species_opacity` runs it through the CUDA kernel
:func:`helios_tpu_torch.kernels.ro.ro_mix`.
"""

from __future__ import annotations

import torch

from helios_tpu_torch import constants as pc


def correlated_k_add(mixed_opac, new_opac):
    """Correlated-k mixing: plain addition (kernels.cu:3304-3310)."""
    return mixed_opac + new_opac


def _cumsum_in_order(x):
    """Inclusive cumulative sum along the last axis, added left to right in
    the input's dtype, as the CUDA kernel adds.  torch.cumsum associates
    differently on CUDA (and accumulates float32 in float64 on the CPU);
    the rebin interpolation divides by weight differences of ~1e-4
    (ny = 20), which turns such last-bit differences into 1e-12 (fp64) and
    1e-4 (fp32) relative differences of the result."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
        out[..., k] = acc
    return out


def _rebin_indices(yg, gauss_y):
    """Interval index w(y) used to rebin the sorted k-function onto each
    Gauss point (kernels.cu:3379-3396).

    The reference walks w upward and advances y when yg[w] first exceeds
    gauss_y[y]; because w keeps moving, the interval used for y is
    max(first crossing, w(y-1)+1).  The recurrence
    w_y = clip(max(first_y, w_{y-1}+1), 1, n2-1) has the closed form
    w_y = clip(max(y+1, y + max_{j<=y}(first_j - j)), 1, n2-1)
    (helios_tpu/ops/mixing.py:32-57), computed here with a cummax over the
    Gauss axis.

    yg: [..., n2]; gauss_y: [ny].  Returns w: [..., ny] int64 in [1, n2-1].
    """
    n2 = yg.shape[-1]
    first = (yg[..., None] <= gauss_y).sum(dim=-2)       # #{yg <= g_y}
    yi = torch.arange(gauss_y.shape[0], device=yg.device)
    m = torch.cummax(first - yi, dim=-1).values
    w = torch.maximum(yi + m, yi + 1)
    return torch.clamp(w, 1, n2 - 1)


def random_overlap_mix(mixed_opac, new_opac, gauss_weight, gauss_y):
    """Random Overlap of two k-distributions (kernels.cu:3311-3397).

    mixed_opac, new_opac: [..., ny] k-coefficients (ascending in y);
    gauss_weight, gauss_y: [ny] quadrature weights and shifted nodes.
    Returns the re-binned mixed k-coefficients [..., ny].

    The sort is stable, as jax.lax.sort is: tied sums keep the order of
    their flat index i*ny + j, so every tie gets the same yg in both.
    """
    ny = gauss_y.shape[0]
    lead = mixed_opac.shape[:-1]
    sums = (mixed_opac[..., :, None] + new_opac[..., None, :]).reshape(
        lead + (ny * ny,))
    w2 = ((0.5 * gauss_weight[:, None])
          * (0.5 * gauss_weight[None, :])).reshape(ny * ny)

    sorted_k, order = torch.sort(sums, dim=-1, stable=True)
    sorted_w = w2[order]

    # cumulative y positions: yg[w] = sum_{v<w} wt[v] + 0.5*wt[w]
    yg = _cumsum_in_order(sorted_w) - 0.5 * sorted_w

    w = _rebin_indices(yg, gauss_y)                # [..., ny]
    yg_lo, yg_hi = yg.gather(-1, w - 1), yg.gather(-1, w)
    k_lo, k_hi = sorted_k.gather(-1, w - 1), sorted_k.gather(-1, w)
    return (k_lo * (yg_hi - gauss_y) + k_hi * (gauss_y - yg_lo)) / (
        yg_hi - yg_lo)


def negligible_overlap(mixed_opac, new_opac):
    """The per-cell negligible-overlap test (kernels.cu:3296-3302): one
    opacity's maximum under 1% of the other's minimum.  [..., ny] ->
    [...] bool."""
    ny = mixed_opac.shape[-1]
    return ((0.01 * mixed_opac[..., 0] > new_opac[..., ny - 1])
            | (0.01 * new_opac[..., 0] > mixed_opac[..., ny - 1]))


def add_species_opacity(mixed_opac, opac_spec, vmr, mass_spec,
                        meanmolmass, gauss_weight, gauss_y, *,
                        species_index: int, ro_method: int):
    """Mix one species into the running opacity (add_to_mixed_opac,
    kernels.cu:3263-3399).

    mixed_opac: [L, B, Y] running mixed opacity [cm^2/g]; opac_spec:
    [L, B, Y] species opacity [cm^2/g of species]; vmr: [L] volume mixing
    ratio; mass_spec: species mass [g]; meanmolmass: [L] [g].
    species_index: position in the mixing order (0 => correlated-k);
    ro_method: 1 for Random Overlap, 0 for correlated-k.

    Returns the updated mixed opacity [L, B, Y].  Random Overlap runs as
    one :func:`helios_tpu_torch.kernels.ro.ro_mix` call over the L*B
    cells, which keeps the plain sum in cells of negligible overlap.  A
    batch of P planets ([L, P, B, Y], vmr and meanmolmass [L, P]) mixes its
    L*P*B cells in the same one call.
    """
    # imported here: kernels.ro takes its plain version from this module
    from helios_tpu_torch.kernels.ro import ro_mix

    ny = mixed_opac.shape[-1]
    new_opac = (vmr * mass_spec / meanmolmass)[..., None, None] * opac_spec

    if ro_method == 0 or species_index == 0 or ny == 1:
        return correlated_k_add(mixed_opac, new_opac)
    return ro_mix(mixed_opac.reshape(-1, ny), new_opac.reshape(-1, ny),
                  gauss_weight, gauss_y).reshape(mixed_opac.shape)


# --------------------------------------------------------------------------- #
# Rayleigh scattering accumulation
# --------------------------------------------------------------------------- #

def add_species_scat(mixed_scat, scat_cross_spec, vmr):
    """scat += vmr * sigma_species (add_to_mixed_scat, kernels.cu:3444-3459).

    mixed_scat: [L, B]; scat_cross_spec: [B] or [L, B]; vmr: [L] (a
    batch: [L, P, B], [L, P, B] and [L, P]).
    """
    return mixed_scat + vmr[..., None] * scat_cross_spec


def h2o_refractive_index(wave, press, temp, f_h2o, mass_h2o):
    """Density-dependent H2O refractive index (calc_index_h2o,
    kernels.cu:3174-3205; Schiebener et al. 1990 formulation).

    wave: [B]; press/temp/f_h2o: [L].  Returns [L, B] (a batch: wave [P,
    B], the others [L, P], returns [L, P, B]).
    """
    dens = f_h2o * press * mass_h2o / (pc.K_B * temp)       # [L]
    lamda = (wave / 0.589e-4)[None]                         # [1, B]
    delta = torch.clamp(dens, max=1.0)[..., None]
    theta = (temp / 273.15)[..., None]

    lamda_UV, lamda_IR = 0.229202, 5.432937
    a0, a1, a2, a3 = 0.244257733, 0.974634476e-2, -0.373234996e-2, \
        0.268678472e-3
    a4, a5, a6, a7 = 0.158920570e-2, 0.245934259e-2, 0.900704920, \
        -0.166626219e-1

    A = delta * (a0 + a1 * delta + a2 * theta + a3 * lamda ** 2 * theta
                 + a4 * lamda ** -2
                 + a5 / (lamda ** 2 - lamda_UV ** 2)
                 + a6 / (lamda ** 2 - lamda_IR ** 2)
                 + a7 * delta ** 2)
    return torch.sqrt((2.0 * A + 1.0) / (1.0 - A))


def h2o_scat_cross(wave, press, temp, vmr_h2o, mass_h2o):
    """On-the-fly H2O Rayleigh cross section (calc_h2o_scat,
    kernels.cu:3404-3440).  Returns [L, B]."""
    index = h2o_refractive_index(wave, press, temp, vmr_h2o, mass_h2o)
    n_ref = (vmr_h2o * press / (pc.K_B * temp))[..., None]  # [L, 1]
    King = (6.0 + 3.0 * 3e-4) / (6.0 - 7.0 * 3e-4)
    lamda_limit = 2.5e-4
    cross = (24.0 * pc.PI ** 3 / (n_ref ** 2 * wave[None] ** 4)
             * ((index ** 2 - 1.0) / (index ** 2 + 2.0)) ** 2 * King)
    return torch.where(wave[None] < lamda_limit, cross,
                       torch.zeros_like(cross))

"""The flux integration of a flux solve in one pass: wrapper of the CUDA
kernel ``csrc/band_integrate.cu`` and its plain PyTorch version.

:func:`band_integrate` launches the kernel for CUDA tensors and runs
:func:`band_integrate_reference` for CPU tensors; there is no fallback from
one to the other.  ``band_integrate.launches`` counts kernel launches.  The
plain version is the chain of PyTorch ops and fixed-order sums that the
kernel fuses (on the card 14 launches, and F_net a 15th); with
``in_order=True`` its sums are :func:`ordered.in_order_reference`, the
kernel's arithmetic on any device, for the comparison on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from helios_tpu_torch.kernels import _launch
from helios_tpu_torch.kernels.ordered import in_order_reference, ordered_sum


class BandTotals(NamedTuple):
    """The band fluxes [.., nbin] and the totals over the bins [..]."""
    F_down_band: torch.Tensor
    F_up_band: torch.Tensor
    F_dir_band: torch.Tensor
    F_up_tot: torch.Tensor
    F_down_tot: torch.Tensor
    F_net: torch.Tensor


def band_integrate(F_down, F_up, F_dir, gauss_weight, delta_lambda,
                   carry=None) -> BandTotals:
    """Gauss and band integration of the three fluxes
    (helios_tpu.fastpath.gauss_band_flat and the band totals of
    helios_tpu.forward.integrate_flux_flat).

    F_down, F_up, F_dir: [L+1, S] fluxes of a planet, or [L+1, P, S] of a
    batch (S = nbin * ny, s = b * ny + y); gauss_weight [ny];
    delta_lambda [nbin], or [P, nbin] for a batch (an expanded view
    shared by the members is read as it is); ``carry``: (F_up_tot,
    F_down_tot) [L+1] or [L+1, P] of the bins before these (a sliced
    model's earlier slices), which the totals start from.  One dtype
    (float32/float64), one device.  Returns :class:`BandTotals`.
    """
    if F_up.is_cpu:
        return band_integrate_reference(F_down, F_up, F_dir, gauss_weight,
                                        delta_lambda, carry)
    fluxes = (F_down.contiguous(), F_up.contiguous(), F_dir.contiguous())
    lead, S = F_up.shape[:-1], F_up.shape[-1]
    Y = gauss_weight.shape[-1]
    if gauss_weight.dim() != 1 or len(lead) not in (1, 2) or S % Y:
        raise ValueError(f"band_integrate takes [L+1, S] or [L+1, P, S] "
                         f"fluxes with S a multiple of ny and gauss_weight "
                         f"[ny], got {tuple(F_up.shape)} and "
                         f"{tuple(gauss_weight.shape)}")
    B = S // Y
    dl = delta_lambda
    if dl.dim() == 1:
        P, dl_stride, dl_shape = 1, 0, (B,)
    else:
        P, dl_stride, dl_shape = dl.shape[0], dl.stride(0), (lead[-1], B)
    if (dl.shape != dl_shape or len(lead) < dl.dim() or dl.stride(-1) != 1
            or dl.dtype is not F_up.dtype or dl.device != F_up.device):
        raise ValueError(f"delta_lambda must be a {F_up.dtype} [nbin] or "
                         f"[P, nbin] tensor on {F_up.device} with unit "
                         f"stride along nbin for fluxes "
                         f"{tuple(F_up.shape)}, got {dl.dtype} "
                         f"{tuple(dl.shape)} on {dl.device}")
    args = fluxes + (gauss_weight,)
    want = [F_up.shape] * 3 + [(Y,)]
    if carry is not None:
        args += tuple(carry)
        want += [lead] * 2
    _launch.check_tensors(args, want)
    R = _launch.check_count("rows x S", F_up.numel()) // S
    bands = F_up.new_empty((3,) + lead + (B,))
    tots = F_up.new_empty((3,) + lead)
    carries = tuple(carry) if carry is not None else (tots, tots)
    _launch.launch("band_integrate",
                   fluxes + (gauss_weight, dl) + carries + (bands, tots),
                   (R, B, Y, P, dl_stride, int(carry is not None)))
    band_integrate.launches += 1
    return BandTotals(*bands.unbind(0), *tots.unbind(0))


band_integrate.launches = 0


def _in_order_sum(x, dim):
    return in_order_reference(x, dim, scan=False)


def band_integrate_reference(F_down, F_up, F_dir, gauss_weight,
                             delta_lambda, carry=None, *,
                             in_order: bool = False) -> BandTotals:
    """Plain PyTorch version of :func:`band_integrate`: per flux
    0.5 * sum_y w_y f, the band products and the totals over the bins as a
    chain of ops; the sums by :func:`ordered_sum` (torch.sum for CPU
    tensors, the fixed-order kernel on the card), or with ``in_order`` by
    the in-order loop.  A carry is put in front of the bins and summed from
    zero like them."""
    total = _in_order_sum if in_order else ordered_sum
    ny = gauss_weight.shape[0]

    def band(f):
        return 0.5 * total(f.reshape(f.shape[:-1] + (-1, ny))
                           * gauss_weight, -1)

    F_down_band, F_up_band, F_dir_band = band(F_down), band(F_up), band(F_dir)
    up = F_up_band * delta_lambda
    down = (F_dir_band + F_down_band) * delta_lambda
    if carry is not None:
        up, down = (torch.cat([c.unsqueeze(-1), x], -1)
                    for c, x in zip(carry, (up, down)))
    up, down = total(up, -1), total(down, -1)
    return BandTotals(F_down_band, F_up_band, F_dir_band, up, down,
                      up - down)

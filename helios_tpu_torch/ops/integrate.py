"""Spectral integration results (port of the RCE part of
:mod:`helios_tpu.ops.integrate`; reference kernels.cu:2428-2513, :3119-3139).

The band and total integration itself is
:func:`helios_tpu_torch.forward.integrate_flux_flat`; the post-processing
diagnostics of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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

"""Random Overlap opacity mixing: wrapper of the CUDA kernel
``csrc/ro_mix.cu`` and its plain PyTorch version.

:func:`ro_mix` launches the kernel for CUDA tensors and runs
:func:`ro_mix_reference` for CPU tensors; there is no fallback from one to
the other.  ``ro_mix.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from helios_tpu_torch.kernels import _launch
from helios_tpu_torch.ops.mixing import (correlated_k_add, negligible_overlap,
                                         random_overlap_mix)

# the kernel holds a cell's ny*ny pairwise sums in one warp's shared memory
MAX_NY = 32


def ro_mix(mixed, new, gauss_weight, gauss_y):
    """Mix the k-distribution ``new`` into ``mixed`` by Random Overlap, per
    cell (helios_tpu.ops.mixing.add_species_opacity after the VMR
    weighting): the plain sum where the overlap is negligible, else
    :func:`helios_tpu_torch.ops.mixing.random_overlap_mix`.

    mixed, new: [C, ny] k-coefficients ascending in y; gauss_weight,
    gauss_y: [ny]; one dtype (float32/float64), contiguous, one device;
    2 <= ny <= 32.  Returns [C, ny].
    """
    C, ny = _launch.matrix_shape(mixed, "mixed", "[C, ny]")
    if not 2 <= ny <= MAX_NY:
        raise ValueError(f"ro_mix takes 2 <= ny <= {MAX_NY}, got ny = {ny}")
    args = (mixed, new, gauss_weight, gauss_y)
    _launch.check_tensors(args, [(C, ny), (C, ny), (ny,), (ny,)])
    if mixed.device.type == "cpu":
        return ro_mix_reference(*args)
    out = torch.empty_like(mixed)
    _launch.launch("ro_mix", args + (out,), (C, ny))
    ro_mix.launches += 1
    return out


ro_mix.launches = 0


def ro_mix_reference(mixed, new, gauss_weight, gauss_y):
    """Plain PyTorch version of :func:`ro_mix`: the select of
    helios_tpu.ops.mixing.add_species_opacity (mixing.py:180-192)."""
    return torch.where(negligible_overlap(mixed, new)[..., None],
                       correlated_k_add(mixed, new),
                       random_overlap_mix(mixed, new, gauss_weight, gauss_y))

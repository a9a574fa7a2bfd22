"""Random Overlap opacity mixing: wrapper of the CUDA kernel
``csrc/ro_mix.cu`` and its plain PyTorch version.

:func:`ro_mix` launches the kernel for CUDA tensors and runs
:func:`ro_mix_reference` for CPU tensors; there is no fallback from one to
the other.  ``ro_mix.launches`` counts kernel launches.
:func:`ro_general_cells` says which cells the kernel sends through its
general branch instead of its streaming merge.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from helios_tpu_torch.kernels import _launch
from helios_tpu_torch.ops.mixing import (_cumsum_in_order, correlated_k_add,
                                         negligible_overlap,
                                         random_overlap_mix)

# a warp's loser-tree scratch must hold the general branch's 2 ny^2 bytes of
# permutation (fp32 the tighter), and a tag keeps j in 8 bits
MAX_NY = 126


def ro_mix(mixed, new, gauss_weight, gauss_y):
    """Mix the k-distribution ``new`` into ``mixed`` by Random Overlap, per
    cell (helios_tpu.ops.mixing.add_species_opacity after the VMR
    weighting): the plain sum where the overlap is negligible, else
    :func:`helios_tpu_torch.ops.mixing.random_overlap_mix`.

    mixed, new: [C, ny] k-coefficients (ascending in y as the tables have
    them; any order gives the plain version's result); gauss_weight,
    gauss_y: [ny]; one dtype (float32/float64), contiguous, one device;
    2 <= ny <= 126.  Returns [C, ny].
    """
    C, ny = _launch.matrix_shape(mixed, "mixed", "[C, ny]")
    if not 2 <= ny <= MAX_NY:
        raise ValueError(f"ro_mix takes 2 <= ny <= {MAX_NY}, got ny = {ny}")
    args = (mixed, new, gauss_weight, gauss_y)
    _launch.check_tensors(args, [(C, ny), (C, ny), (ny,), (ny,)])
    if mixed.is_cpu:
        return ro_mix_reference(*args)
    out = torch.empty_like(mixed)
    _launch.launch("ro_mix", args + (out,), (C, ny))
    ro_mix.launches += 1
    return out


ro_mix.launches = 0


def ro_mix_occupancy(dtype, ny: int) -> dict:
    """How ro_mix launches at ny points on the current CUDA card: threads
    and shared-memory bytes per block, and the blocks one SM holds at once
    (the kernel's own query; launches nothing)."""
    lib = _launch._library("ro_mix", 5, 2)
    shape = (ctypes.c_int * 3)()
    rc = lib.ro_mix_occupancy(64 if dtype == torch.float64 else 32, ny, shape)
    if rc != 0:
        raise RuntimeError("ro_mix_occupancy failed: "
                           + lib.helios_cuda_error_string(rc).decode())
    return dict(threads=shape[0], smem_bytes=shape[1], blocks_per_sm=shape[2])


def ro_mix_reference(mixed, new, gauss_weight, gauss_y):
    """Plain PyTorch version of :func:`ro_mix`: the select of
    helios_tpu.ops.mixing.add_species_opacity (mixing.py:180-192)."""
    return torch.where(negligible_overlap(mixed, new)[..., None],
                       correlated_k_add(mixed, new),
                       random_overlap_mix(mixed, new, gauss_weight, gauss_y))


def stream_weights_ok(gauss_weight, gauss_y) -> bool:
    """The kernel's launch-wide check for its streaming merge, in the
    tensors' dtype: every half-weight w/2 positive and finite, gauss_y
    non-decreasing (``csrc/ro_mix.cu``)."""
    h = (0.5 * gauss_weight).cpu().numpy()
    g = gauss_y.cpu().numpy()
    return bool((h > 0).all() and np.isfinite(h).all()
                and (g[1:] >= g[:-1]).all())


def stream_rises(mixed, new, gauss_weight):
    """[C] bool: whether yg, the weights' running sum less half the
    current weight in the sums' stable sort order, never decreases along
    a cell's stream (the kernel's check at each position; NaN fails)."""
    ny = gauss_weight.shape[0]
    sums = (mixed[:, :, None] + new[:, None, :]).reshape(-1, ny * ny)
    w2 = ((0.5 * gauss_weight[:, None])
          * (0.5 * gauss_weight[None, :])).reshape(ny * ny)
    sorted_w = w2[torch.sort(sums, dim=-1, stable=True)[1]]
    yg = _cumsum_in_order(sorted_w) - 0.5 * sorted_w
    prev = torch.cat([torch.zeros_like(yg[:, :1]), yg[:, :-1]], dim=1)
    return (yg >= prev).all(dim=1)


def ro_general_cells(mixed, new, gauss_weight, gauss_y):
    """[C] bool: the cells that :func:`ro_mix`'s kernel sends through its
    general branch (a warp-cooperative sort) instead of its streaming
    merge: cells of non-negligible overlap whose ``new`` is not
    non-decreasing, whose ``mixed`` or ``new`` is not finite or whose
    stream's yg decreases (:func:`stream_rises`); all cells of
    non-negligible overlap when :func:`stream_weights_ok` fails."""
    live = ~negligible_overlap(mixed, new)
    if not stream_weights_ok(gauss_weight, gauss_y):
        return live
    sorted_ = ((new[:, 1:] >= new[:, :-1]).all(dim=1)
               & torch.isfinite(mixed).all(dim=1)
               & torch.isfinite(new).all(dim=1))
    return live & ~(sorted_ & stream_rises(mixed, new, gauss_weight))

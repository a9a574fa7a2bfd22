"""Bytes and operations of one call of each CUDA kernel of the program at
its shape, and its bound on the H100 (copied from ``chip_smoke.py``'s
bound functions).  Every input byte is counted read once and every output
byte written once.  Peaks: NVIDIA's data sheet of the H100 SXM, 3.35 TB/s
of HBM and 34 / 67 TFLOP/s fp64 / fp32 outside the tensor cores, at the
full 700 W."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 34e12, 4: 67e12}      # by element size in bytes


def _bound(n_bytes, flops, size):
    """{bytes, flops, bound_s, by}: the larger of the two times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[size]
    return dict(bytes=n_bytes, flops=flops, bound_s=max(t_bytes, t_ops),
                by="bytes" if t_bytes >= t_ops else "operations")


def noniso_sweep(L: int, S: int, n_passes: int, size: int = 8) -> dict:
    """14 L + 7 values per column moved once; 16 operations per layer,
    column and pass."""
    return _bound((14 * L + 7) * S * size, 16 * L * S * n_passes, size)


def iso_sweep(L: int, S: int, n_passes: int, size: int = 8) -> dict:
    """7 L + 7 values per column moved once; 8 operations per layer,
    column and pass."""
    return _bound((7 * L + 7) * S * size, 8 * L * S * n_passes, size)


def thomas_solve(n: int, S: int, size: int = 8) -> dict:
    """b, c, d read and x written once; 8 operations per row and
    column."""
    return _bound(4 * n * S * size, 8 * n * S, size)


def band_integrate(R: int, S: int, B: int, Y: int, dl_values: int,
                   size: int = 8) -> dict:
    """The three fluxes, the weights and delta_lambda read once, three
    bands and three totals written once; 2 operations per flux value, 8
    per bin and row."""
    n_bytes = ((3 * R * S + Y + dl_values) + (3 * R * B + 3 * R)) * size
    return _bound(n_bytes, 2 * 3 * R * S + 8 * R * B, size)


def ro_mix(C: int, ny: int, n_negligible: int, size: int = 8) -> dict:
    """mixed, new read and out written once; per cell ny^2 (4 + log2 ny)
    operations, ny where the overlap is negligible."""
    ops = ((C - n_negligible) * ny * ny * (4 + math.log2(ny))
           + n_negligible * ny)
    return _bound(3 * C * ny * size, ops, size)

"""The batched tridiagonal (Thomas) solve: wrapper of the CUDA kernel
``csrc/thomas.cu`` and its plain PyTorch version.

:func:`thomas_solve` launches the kernel for CUDA tensors and runs
:func:`thomas_solve_reference` for CPU tensors; there is no fallback from
one to the other.  ``thomas_solve.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from helios_tpu_torch.kernels import _launch


def thomas_solve(b, c, d):
    """Solve, per column s, the tridiagonal system with diagonal b,
    super-diagonal c and sub-diagonal a_i = c_{i-1}, right-hand side d
    (helios_tpu.ops.thomas.thomas_solve).

    b, c, d: [n, S] of one dtype (float32/float64), contiguous, on one
    device.  Returns x [n, S].
    """
    n, S = _launch.matrix_shape(b, "b", "[n, S]")
    _launch.check_tensors((b, c, d), [(n, S)] * 3)
    if b.device.type == "cpu":
        return thomas_solve_reference(b, c, d)
    x = torch.empty_like(b)
    dp = torch.empty_like(b)       # scratch; cp lives in x
    _launch.launch("thomas", (b, c, d, x, dp), (n, S))
    thomas_solve.launches += 1
    return x


thomas_solve.launches = 0


def thomas_solve_reference(b, c, d):
    """Plain PyTorch version of :func:`thomas_solve`: the two recurrences
    of the JAX oracle (helios_tpu/ops/thomas.py:53-73) as row loops, in the
    same operation order."""
    n = b.shape[0]
    cp = torch.empty_like(b)
    dp = torch.empty_like(b)
    c_prev = cp_prev = dp_prev = torch.zeros_like(b[0])
    for i in range(n):
        denom = b[i] - c_prev * cp_prev
        cp_prev = c[i] / denom
        dp_prev = (d[i] - c_prev * dp_prev) / denom
        cp[i] = cp_prev
        dp[i] = dp_prev
        c_prev = c[i]
    x = torch.empty_like(b)
    x_next = torch.zeros_like(b[0])
    for i in range(n - 1, -1, -1):
        x_next = dp[i] - cp[i] * x_next
        x[i] = x_next
    return x

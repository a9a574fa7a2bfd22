"""The two-stream sweeps: wrappers of the CUDA kernels
``csrc/noniso_sweep.cu`` and ``csrc/iso_sweep.cu`` and their plain PyTorch
versions.

:func:`noniso_sweep` and :func:`iso_sweep` launch their kernel for CUDA
tensors and run their plain version (:func:`noniso_sweep_reference`,
:func:`iso_sweep_reference`) for CPU tensors; there is no fallback from one
to the other.  ``noniso_sweep.launches`` and ``iso_sweep.launches`` count
kernel launches.
"""

from __future__ import annotations

import torch

from helios_tpu_torch.kernels import _launch


def _check(args, want, n_passes) -> int:
    """Validate the inputs (shape, one dtype and device, contiguous) and
    return n_passes as an int in [1, 2**31 - 1]; nothing is adjusted."""
    _launch.check_tensors(args, want)
    return _launch.check_count("n_passes", n_passes)


def _run(name, args, out_shapes, L, S, n_passes):
    """Launch ``<name>`` on the inputs' CUDA device; returns the outputs,
    allocated here."""
    outs = tuple(args[0].new_empty(shape) for shape in out_shapes)
    _launch.launch(name, args + outs, (L, S, n_passes))
    return outs


# --------------------------------------------------------------------------- #
# non-isothermal sweep
# --------------------------------------------------------------------------- #

def noniso_sweep(a_up, b_up, src_up_down, src_up_up, a_low, b_low,
                 src_low_down, src_low_up, toa, boa_refl, boa_emis, F_dir0,
                 F_up_prev, Fc_up_prev, *, n_passes: int):
    """Iterative non-isothermal flux solve (fastpath.fband_noniso_flat).

    Coefficients and sources [L, S], boundary rows [S], the previous
    solve's F_up_prev [L+1, S] and Fc_up_prev [L, S]; all of one dtype
    (float32/float64), contiguous, on one device.  Returns
    (F_down, F_up [L+1, S], Fc_down, Fc_up [L, S]).
    """
    args = (a_up, b_up, src_up_down, src_up_up, a_low, b_low, src_low_down,
            src_low_up, toa, boa_refl, boa_emis, F_dir0, F_up_prev,
            Fc_up_prev)
    L, S = _launch.matrix_shape(a_up, "a_up", "[L, S]")
    n = _check(args, [(L, S)] * 8 + [(S,)] * 4 + [(L + 1, S), (L, S)],
               n_passes)
    if a_up.is_cpu:
        return noniso_sweep_reference(*args, n_passes=n)
    outs = _run("noniso_sweep", args, [(L + 1, S)] * 2 + [(L, S)] * 2,
                   L, S, n)
    noniso_sweep.launches += 1
    return outs


noniso_sweep.launches = 0


def noniso_sweep_reference(a_up, b_up, src_up_down, src_up_up, a_low, b_low,
                           src_low_down, src_low_up, toa, boa_refl,
                           boa_emis, F_dir0, F_up_prev, Fc_up_prev, *,
                           n_passes: int):
    """Plain PyTorch version of :func:`noniso_sweep`: the layer loops of
    the JAX oracle (fastpath.py:645-685) in the same operation order."""
    L = a_up.shape[0]
    F_up = F_up_prev.clone()
    Fc_up = Fc_up_prev.clone()
    F_down = torch.empty_like(F_up_prev)
    Fc_down = torch.empty_like(Fc_up_prev)
    F_down[L] = toa
    for _ in range(n_passes):
        carry = toa
        for i in range(L - 1, -1, -1):
            fc = a_up[i] * carry + b_up[i] * Fc_up[i] + src_up_down[i]
            carry = a_low[i] * fc + b_low[i] * F_up[i] + src_low_down[i]
            Fc_down[i] = fc
            F_down[i] = carry
        carry = boa_refl * (F_dir0 + F_down[0]) + boa_emis
        F_up[0] = carry
        for i in range(L):
            fc = a_low[i] * carry + b_low[i] * Fc_down[i] + src_low_up[i]
            carry = a_up[i] * fc + b_up[i] * F_down[i + 1] + src_up_up[i]
            Fc_up[i] = fc
            F_up[i + 1] = carry
    return F_down, F_up, Fc_down, Fc_up


# --------------------------------------------------------------------------- #
# isothermal sweep
# --------------------------------------------------------------------------- #

def iso_sweep(a, b_nm, src_down, src_up, toa, boa_refl, boa_emis, F_dir0,
              F_up_prev, *, n_passes: int):
    """Iterative isothermal flux solve (fastpath.fband_iso_flat).

    Coefficients a = P/M, b_nm = -N/M and sources [L, S], boundary rows
    [S], the previous solve's F_up_prev [L+1, S]; all of one dtype
    (float32/float64), contiguous, on one device.  Returns
    (F_down, F_up), both [L+1, S].
    """
    args = (a, b_nm, src_down, src_up, toa, boa_refl, boa_emis, F_dir0,
            F_up_prev)
    L, S = _launch.matrix_shape(a, "a", "[L, S]")
    n = _check(args, [(L, S)] * 4 + [(S,)] * 4 + [(L + 1, S)], n_passes)
    if a.is_cpu:
        return iso_sweep_reference(*args, n_passes=n)
    outs = _run("iso_sweep", args, [(L + 1, S)] * 2, L, S, n)
    iso_sweep.launches += 1
    return outs


iso_sweep.launches = 0


def iso_sweep_reference(a, b_nm, src_down, src_up, toa, boa_refl, boa_emis,
                        F_dir0, F_up_prev, *, n_passes: int):
    """Plain PyTorch version of :func:`iso_sweep`: the layer loops of the
    JAX oracle (fastpath.py:385-411) in the same operation order."""
    L = a.shape[0]
    F_up = F_up_prev.clone()
    F_down = torch.empty_like(F_up_prev)
    F_down[L] = toa
    for _ in range(n_passes):
        carry = toa
        for i in range(L - 1, -1, -1):
            carry = a[i] * carry + b_nm[i] * F_up[i] + src_down[i]
            F_down[i] = carry
        carry = boa_refl * (F_dir0 + F_down[0]) + boa_emis
        F_up[0] = carry
        for i in range(L):
            carry = a[i] * carry + b_nm[i] * F_down[i + 1] + src_up[i]
            F_up[i + 1] = carry
    return F_down, F_up

"""The non-isothermal two-stream sweep: wrapper of the CUDA kernel
``csrc/noniso_sweep.cu`` and its plain PyTorch version.

:func:`noniso_sweep` launches the kernel for CUDA tensors and runs
:func:`noniso_sweep_reference` for CPU tensors; there is no fallback from
one to the other.  ``noniso_sweep.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from helios_tpu_torch.kernels import _build

_ENTRY = {torch.float64: "noniso_sweep_f64", torch.float32: "noniso_sweep_f32"}
_N_TENSORS = 14


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("noniso_sweep")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * (_N_TENSORS + 4)
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.helios_cuda_error_string.argtypes = [ctypes.c_int]
    lib.helios_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(args, n_passes):
    """Validate the 14 inputs; returns (L, S)."""
    a_up = args[0]
    if a_up.dim() != 2:
        raise ValueError(f"a_up must be [L, S], got {tuple(a_up.shape)}")
    L, S = a_up.shape
    if L < 1 or S < 1:
        raise ValueError(f"empty sweep shape {(L, S)}")
    want = [(L, S)] * 8 + [(S,)] * 4 + [(L + 1, S), (L, S)]
    for k, (t, shape) in enumerate(zip(args, want)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"argument {k} is not a tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"argument {k} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != a_up.dtype:
            raise TypeError(f"argument {k} is {t.dtype}, a_up is "
                            f"{a_up.dtype}: all must share one dtype")
        if t.device != a_up.device:
            raise ValueError(f"argument {k} is on {t.device}, a_up on "
                             f"{a_up.device}")
        if not t.is_contiguous():
            raise ValueError(f"argument {k} is not contiguous")
    if a_up.dtype not in _ENTRY:
        raise TypeError(f"unsupported dtype {a_up.dtype} "
                        "(float32 or float64)")
    if int(n_passes) < 1:
        raise ValueError(f"n_passes must be >= 1, got {n_passes}")
    return L, S


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
    L, S = _check(args, n_passes)
    dev = a_up.device
    if dev.type == "cpu":
        return noniso_sweep_reference(*args, n_passes=n_passes)
    if dev.type != "cuda":
        raise ValueError(f"noniso_sweep runs on cuda or cpu, not {dev}")

    lib = _library()
    outs = (torch.empty((L + 1, S), dtype=a_up.dtype, device=dev),
            torch.empty((L + 1, S), dtype=a_up.dtype, device=dev),
            torch.empty((L, S), dtype=a_up.dtype, device=dev),
            torch.empty((L, S), dtype=a_up.dtype, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _ENTRY[a_up.dtype])(
            *(t.data_ptr() for t in args + outs), L, S, int(n_passes),
            stream)
    if rc != 0:
        raise RuntimeError("noniso_sweep launch failed: "
                           + lib.helios_cuda_error_string(rc).decode())
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

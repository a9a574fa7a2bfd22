"""What every kernel wrapper of the port shares: the argument check and the
launch of a ``csrc/<name>.cu`` entry point through ctypes.

Each source exports ``<name>_f64`` and ``<name>_f32``, which take the
tensors' data pointers, then some ints, then the CUDA stream, launch on
that stream without synchronising and return ``cudaGetLastError()``; and
``helios_cuda_error_string``.  A source whose launch can refuse a shape
also exports ``helios_launch_error_detail``, which says why.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import Sequence

import torch

from helios_tpu_torch.kernels import _build

SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library(name: str, n_tensors: int, n_ints: int) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, with the argument types of its
    entry points: n_tensors pointers, n_ints ints, then the stream."""
    lib = _build.load(name)
    for suffix in SUFFIX.values():
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * n_tensors
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.helios_cuda_error_string.argtypes = [ctypes.c_int]
    lib.helios_cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "helios_launch_error_detail"):
        lib.helios_launch_error_detail.argtypes = []
        lib.helios_launch_error_detail.restype = ctypes.c_char_p
    return lib


def matrix_shape(first, name: str, dims: str) -> tuple:
    """The (rows, columns) of a non-empty 2-D tensor, the first argument
    of a wrapper; ``dims`` names them in the error ("[L, S]")."""
    if not isinstance(first, torch.Tensor) or first.dim() != 2 \
            or 0 in first.shape:
        shape = tuple(first.shape) if isinstance(first, torch.Tensor) else None
        raise ValueError(f"{name} must be a non-empty {dims} tensor, got "
                         f"shape {shape}")
    return tuple(first.shape)


def check_tensors(args: Sequence, want: Sequence[tuple]) -> None:
    """Validate the inputs against their expected shapes: one dtype
    (float32/float64), one device, contiguous.  Nothing is adjusted."""
    first = args[0]
    for k, (t, shape) in enumerate(zip(args, want)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"argument {k} is not a tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"argument {k} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != first.dtype:
            raise TypeError(f"argument {k} is {t.dtype}, argument 0 is "
                            f"{first.dtype}: all must share one dtype")
        if t.device != first.device:
            raise ValueError(f"argument {k} is on {t.device}, argument 0 on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"argument {k} is not contiguous")
    if first.dtype not in SUFFIX:
        raise TypeError(f"unsupported dtype {first.dtype} "
                        "(float32 or float64)")


def check_count(name: str, value) -> int:
    """An integer argument in [1, 2**31 - 1], returned as an int."""
    n = operator.index(value)
    if not 1 <= n <= INT_MAX:
        raise ValueError(f"{name} must be in [1, {INT_MAX}], got {n}")
    return n


def launch(name: str, tensors: Sequence[torch.Tensor],
           ints: Sequence[int]) -> None:
    """Launch ``<name>`` on the current stream of the tensors' CUDA device.
    ``tensors`` are the inputs followed by the outputs and scratch, which
    the caller allocated.  Raises on any other device and on a failed
    launch."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    lib = _library(name, len(tensors), len(ints))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{name}_{SUFFIX[tensors[0].dtype]}")(
            *(t.data_ptr() for t in tensors), *ints, stream)
    if rc != 0:
        msg = f"{name} launch failed: " + lib.helios_cuda_error_string(
            rc).decode()
        if hasattr(lib, "helios_launch_error_detail"):
            detail = lib.helios_launch_error_detail().decode()
            msg += f" ({detail})" if detail else ""
        raise RuntimeError(msg)

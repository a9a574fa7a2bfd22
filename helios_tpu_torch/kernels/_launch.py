"""What every kernel wrapper of the port shares: the argument check and the
launch of a ``csrc/<name>.cu`` entry point through ctypes.

Each source exports ``<name>_f64`` and ``<name>_f32``, which take the
tensors' data pointers, then some ints, then the CUDA stream, launch on
that stream without synchronising and return ``cudaGetLastError()``; and
``helios_cuda_error_string``.  A source whose launch can refuse a shape
also exports ``helios_launch_error_detail``, which says why.

The launch path runs several times per radiation iteration, and on the
card its host time, not the kernels', sets the pace of a one-planet run.
So each check is one pass over the arguments that raises nothing and
falls back to a detailed pass only to name what failed, the typed entry
point is looked up once per (kernel, dtype), and the device is switched
only for a tensor that is not on the current one.
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


@functools.lru_cache(maxsize=None)
def entry(name: str, dtype, n_tensors: int, n_ints: int):
    """The entry point ``<name>_f64`` or ``<name>_f32`` for ``dtype``,
    built, loaded and typed at its first use."""
    if dtype not in SUFFIX:
        raise TypeError(f"unsupported dtype {dtype} (float32 or float64)")
    return getattr(_library(name, n_tensors, n_ints),
                   f"{name}_{SUFFIX[dtype]}")


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
    try:
        if ([t.shape for t in args] == list(want)
                and len({(t.dtype, t.device) for t in args}) == 1
                and all(map(torch.Tensor.is_contiguous, args))
                and args[0].dtype in SUFFIX):
            return
    except (AttributeError, TypeError):     # an argument is no tensor
        pass
    _explain(args, want)


def _explain(args: Sequence, want: Sequence[tuple]) -> None:
    """Raise for the first argument that :func:`check_tensors` refuses."""
    first = args[0]
    if len(args) != len(want):
        raise ValueError(f"{len(args)} arguments, expected {len(want)}")
    for k, (t, shape) in enumerate(zip(args, want)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"argument {k} is not a tensor")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"argument {k} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
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
    the caller allocated and checked.  Raises on any other device and on a
    failed launch."""
    first = tensors[0]
    if not first.is_cuda:
        raise ValueError(f"{name} runs on cuda or cpu, not {first.device}")
    fn = entry(name, first.dtype, len(tensors), len(ints))
    index = first.get_device()
    if index != torch.cuda.current_device():
        # a slice of a mesh on another card: launch there, then switch back
        with torch.cuda.device(index):
            return launch(name, tensors, ints)
    rc = fn(*[t.data_ptr() for t in tensors], *ints,
            torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        lib = _library(name, len(tensors), len(ints))
        msg = f"{name} launch failed: " + lib.helios_cuda_error_string(
            rc).decode()
        if hasattr(lib, "helios_launch_error_detail"):
            detail = lib.helios_launch_error_detail().decode()
            msg += f" ({detail})" if detail else ""
        raise RuntimeError(msg)

"""ctypes loader for the native ktable accelerators.

``kdistr.cpp`` is compiled by ``g++`` at first use into
``helios_tpu_torch/_build/kdistr-<hash>.so``, keyed by a hash of the source
and the flags (as ``kernels/_build.py`` keys the CUDA libraries), so an
edited source rebuilds and an unchanged one is reused.  The flags name no
host CPU (no ``-march=native``) and turn off the contraction of a*b + c
into fma, so a library built on one machine computes the same on another.
A failed build or load raises with the compiler's output; callers that
want the numpy path pass ``use_native=False`` (it is also the oracle of
the tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "kdistr.cpp"
BUILD_DIR = SOURCE.parents[2] / "_build"
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library built from kdistr.cpp with GXX_FLAGS lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"kdistr-{h.hexdigest()[:16]}.so"


def build() -> None:
    """Compile kdistr.cpp unless its library exists.  Raises with the
    compiler's output when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native ktable accelerators "
                           "need a C++ compiler (use_native=False takes the "
                           "numpy path)")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, out)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(str(library_path()))
        d = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.c_int64
        lib.kdistr_tp.argtypes = [d, d, i64, d, i64, d, d, i64, d]
        lib.kdistr_tp.restype = None
        lib.bilinear_tp.argtypes = [d, i64, i64, i64, d, d, d, i64, d,
                                    i64, d]
        lib.bilinear_tp.restype = None
        _lib = lib
        return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def kdistr_native(lamda_hk, opac_hk, lamda_int, delta_lamda, y_gauss):
    """Per-(T,P) k-distribution over all bins; returns [nbin * ny]."""
    lib = _load()
    lam = np.ascontiguousarray(lamda_hk, np.float64)
    opa = np.ascontiguousarray(opac_hk, np.float64)
    edges = np.ascontiguousarray(lamda_int, np.float64)
    dl = np.ascontiguousarray(delta_lamda, np.float64)
    y = np.ascontiguousarray(y_gauss, np.float64)
    nbin = len(edges) - 1
    out = np.empty(nbin * len(y), np.float64)
    lib.kdistr_tp(_ptr(lam), _ptr(opa), len(lam), _ptr(edges), nbin,
                  _ptr(dl), _ptr(y), len(y), _ptr(out))
    return out


def bilinear_tp_native(values, temp_old, press_old, temp_new, press_new):
    """Edge-clamped bilinear (T, log P) regrid of [nt, np, ...]."""
    lib = _load()
    v = np.ascontiguousarray(values, np.float64)
    nt_old, np_old = v.shape[0], v.shape[1]
    inner = int(np.prod(v.shape[2:], dtype=np.int64)) if v.ndim > 2 else 1
    to = np.ascontiguousarray(temp_old, np.float64)
    po = np.ascontiguousarray(press_old, np.float64)
    tn = np.ascontiguousarray(temp_new, np.float64)
    pn = np.ascontiguousarray(press_new, np.float64)
    out = np.empty((len(tn), len(pn)) + v.shape[2:], np.float64)
    lib.bilinear_tp(_ptr(v), nt_old, np_old, inner, _ptr(to), _ptr(po),
                    _ptr(tn), len(tn), _ptr(pn), len(pn), _ptr(out))
    return out

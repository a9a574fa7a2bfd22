"""The port's non-isothermal sweep (helios_tpu_torch.kernels.sweep) against
the JAX package: its plain version against the lax.scan oracle
(fastpath.fband_noniso_flat, use_pallas=False) and against the Pallas
kernels in interpret mode, plus the wrapper's argument checks.  The CUDA
kernel itself runs only on the card (tests/test_torch_package.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helios_tpu import fastpath as jfp
from helios_tpu_torch.kernels import _build
from helios_tpu_torch.kernels.sweep import (noniso_sweep,
                                            noniso_sweep_reference)

NAMES = ("a_up", "b_up", "src_up_down", "src_up_up", "a_low", "b_low",
         "src_low_down", "src_low_up", "toa", "boa_refl", "boa_emis")


def _inputs(seed, L, S, dtype):
    """Physically shaped random sweep inputs (as tests/test_df64.py)."""
    rng = np.random.default_rng(seed)
    mk = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(dtype)
    C = dict(a_up=mk(0.8, 1.0, L, S), b_up=mk(0.0, 0.02, L, S),
             src_up_down=mk(1e2, 1e4, L, S), src_up_up=mk(1e2, 1e4, L, S),
             a_low=mk(0.8, 1.0, L, S), b_low=mk(0.0, 0.02, L, S),
             src_low_down=mk(1e2, 1e4, L, S), src_low_up=mk(1e2, 1e4, L, S),
             toa=mk(0.0, 1e3, S), boa_refl=mk(0.0, 0.4, S),
             boa_emis=mk(1e2, 1e4, S))
    return C, mk(0.0, 1e3, S), mk(0.0, 1e3, L + 1, S), mk(0.0, 1e3, L, S)


def _jax(C, F_dir0, F_up0, Fc_up0, n_passes, use_pallas):
    JC = jfp.FlatNonIsoCoeffs(**{k: jnp.asarray(v) for k, v in C.items()})
    out = jfp.fband_noniso_flat(JC, jnp.asarray(F_dir0), jnp.asarray(F_up0),
                                jnp.asarray(Fc_up0), n_passes=n_passes,
                                use_pallas=use_pallas)
    return [np.asarray(x) for x in out]


def _port(C, F_dir0, F_up0, Fc_up0, n_passes, fn=noniso_sweep):
    t = torch.from_numpy
    out = fn(*(t(C[k]) for k in NAMES), t(F_dir0), t(F_up0), t(Fc_up0),
             n_passes=n_passes)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("n_passes", [1, 4])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_fp64_matches_jax(n_passes, use_pallas):
    """fp64 at rtol 1e-12: the lax.scan oracle, and the df64 Pallas kernel
    (interpret mode), which agrees with the oracle to 1e-12 itself."""
    args = _inputs(0, 10, 40, np.float64)
    want = _jax(*args, n_passes, use_pallas)
    got = _port(*args, n_passes)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-12)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fp32_matches_jax(use_pallas):
    """fp32 at rtol 2e-5 (the bound of tests/test_df64.py for the fp32
    Pallas kernel against the scan oracle)."""
    args = _inputs(1, 8, 32, np.float32)
    want = _jax(*args, 2, use_pallas)
    got = _port(*args, 2)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=2e-5)


def test_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors the wrapper returns exactly the plain version's
    result and launches nothing."""
    args = _inputs(2, 6, 24, np.float64)
    before = noniso_sweep.launches
    got = _port(*args, 4)
    want = _port(*args, 4, fn=noniso_sweep_reference)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert noniso_sweep.launches == before


def _tensors(dtype=torch.float64, L=5, S=16):
    C, F_dir0, F_up0, Fc_up0 = _inputs(3, L, S, np.float64)
    ts = [torch.from_numpy(C[k]) for k in NAMES]
    ts += [torch.from_numpy(F_dir0), torch.from_numpy(F_up0),
           torch.from_numpy(Fc_up0)]
    return [t.to(dtype) for t in ts]


def test_wrapper_rejects_a_wrong_shape():
    ts = _tensors()
    ts[12] = ts[12][:-1].contiguous()      # F_up_prev [L, S], not [L+1, S]
    with pytest.raises(ValueError, match="shape"):
        noniso_sweep(*ts, n_passes=1)


def test_wrapper_rejects_mixed_dtypes():
    ts = _tensors()
    ts[3] = ts[3].float()
    with pytest.raises(TypeError, match="dtype"):
        noniso_sweep(*ts, n_passes=1)


def test_wrapper_rejects_non_contiguous_input():
    ts = _tensors()
    ts[0] = ts[0].t().contiguous().t()     # same shape, column-major
    assert not ts[0].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        noniso_sweep(*ts, n_passes=1)


def test_wrapper_rejects_other_dtypes_and_pass_counts():
    with pytest.raises(TypeError, match="unsupported dtype"):
        noniso_sweep(*_tensors(torch.float16), n_passes=1)
    with pytest.raises(ValueError, match="n_passes"):
        noniso_sweep(*_tensors(), n_passes=0)


def test_build_is_keyed_by_the_sources():
    """Every CUDA source is known to kernels/_build.py, and its library path
    is a stable function of the source text and the flags."""
    assert "noniso_sweep" in _build.kernel_names()
    p = _build.library_path("noniso_sweep")
    assert p == _build.library_path("noniso_sweep")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("noniso_sweep-")

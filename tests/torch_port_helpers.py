"""Shared inputs and comparisons for the tests of the PyTorch port
(helios_tpu_torch) against the JAX package (helios_tpu).

The small run follows the multichip dry run's scenario
(__graft_entry__.py:95-116): 12 layers, 65 bins x 4 Gauss points, a
premixed synthetic table (seed 1) made optically thick so that both the
radiation and the convection loop run.
"""

import numpy as np
import torch

from helios_tpu.io.opacity import synthetic_premixed_table

# One intra-op thread for the port's CPU tests.  In a process that had run
# the JAX package's Pallas-interpret tests, torch's first large
# multi-threaded computation came out wrong about one run in ten (rows of
# the Planck table off by up to 50%, a fresh recomputation right); with
# one thread it was not seen in 24 runs (ROADMAP C).
torch.set_num_threads(1)

SMALL_RUN = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                 R_star=30.0, T_star=30.0, T_intern=700.0,
                 scattering="yes", direct_beam="no", convection="yes",
                 kappa_value=0.1, run_type="iterative", nlayer=12,
                 p_boa=1e9, p_toa=1e3, adapt_interval=6)


def small_table(nbin=65):
    table = synthetic_premixed_table(nbin=nbin, ny=4, ntemp=8, npress=6,
                                     seed=1)
    table.kpoints *= 10.0          # optically thick -> convective
    return table


def start_profile(nlayer):
    """A non-isothermal start [L+1]; the surface ghost takes layer 0's T."""
    T = np.linspace(1500.0, 500.0, nlayer)
    return np.append(T, T[0])


def write_tp_file(path, T):
    """T [L+1] as a "helios"-format TP file (BOA row, then the layers)."""
    L = len(T) - 1
    with open(path, "w") as f:
        f.write("start profile\nlayer T[K]\n")
        f.write(f"BOA {float(T[L])!r}\n")
        for i in range(L):
            f.write(f"{i} {float(T[i])!r}\n")


def nested_numpy(x):
    """NamedTuple tree -> nested {field: np.ndarray} (numbers as arrays)."""
    if hasattr(x, "_asdict"):
        return {k: nested_numpy(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def native_planck(arrays):
    """JAX ModelArrays whose Planck lookups take the native fp64 branch of
    helios_tpu.planck.interpolate_planck (pairs=None) instead of the
    two-float32 pairs that build_model stores for the TPU."""
    return arrays._replace(planck_grid_pairs=None)


# Below the smallest normal number the packages may differ outright:
# whether denormal results are flushed to zero depends on the thread's
# floating-point mode, which XLA's CPU runtime may leave set.
TINY = float(np.finfo(np.float64).tiny)


def assert_close(got, want, rtol, scale_atol=0.0, err_msg=""):
    """|got - want| <= rtol*|want| + scale_atol*max|want| + TINY."""
    got = np.asarray(got)
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
        return
    atol = TINY + (scale_atol * float(np.max(np.abs(want)))
                   if want.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)

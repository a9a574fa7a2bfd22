"""Shared inputs and comparisons for the tests of the PyTorch port
(helios_tpu_torch) against the JAX package (helios_tpu).

The small run follows the multichip dry run's scenario
(__graft_entry__.py:95-116): 12 layers, 65 bins x 4 Gauss points, a
premixed synthetic table (seed 1) made optically thick so that both the
radiation and the convection loop run.
"""

import dataclasses
import os

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


def native_build(monkeypatch):
    """Make helios_tpu.pipeline.run use the native fp64 Planck lookup."""
    from helios_tpu import pipeline as jax_pipeline
    build = jax_pipeline.build_model
    monkeypatch.setattr(
        jax_pipeline, "build_model",
        lambda *a, **k: (lambda pa: (pa[0], native_planck(pa[1])))(
            build(*a, **k)))


def assert_same_state(got, want, label):
    """Every tensor and counter of two loop states (of the port), bit for
    bit."""
    assert type(got) is type(want), label
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if hasattr(g, "_fields"):
            assert_same_state(g, w, f"{label}.{f}")
        elif isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, (label, f)
            assert torch.equal(g, w), f"{label}.{f} differs"
        else:
            assert type(g) is type(w) and g == w, (label, f, g, w)


def file_rows(path):
    with open(path) as f:
        return [line.split() for line in f]


def file_number(tok):
    try:
        return float(tok)
    except ValueError:
        return None


def assert_same_files(got_dir, want_dir, rtol=1e-5, col_atol=1e-9,
                      names=None):
    """The same file names, and in each file (of ``names``, default all)
    the same tokens: numbers at rtol plus col_atol of the largest number in
    the same column (the same position in its row), other tokens equal."""
    if names is None:
        names = sorted(os.listdir(want_dir))
        assert sorted(os.listdir(got_dir)) == names
    for name in names:
        got = file_rows(os.path.join(got_dir, name))
        want = file_rows(os.path.join(want_dir, name))
        assert [len(r) for r in got] == [len(r) for r in want], name
        scale = {}
        for row in want:
            for j, tok in enumerate(row):
                x = file_number(tok)
                if x is not None:
                    scale[j] = max(scale.get(j, 0.0), abs(x))
        for i, (gr, wr) in enumerate(zip(got, want)):
            for j, (g, w) in enumerate(zip(gr, wr)):
                gx, wx = file_number(g), file_number(w)
                where = f"{name} row {i} column {j}"
                if wx is None:
                    assert g == w, where
                else:
                    assert gx is not None, where
                    tol = rtol * abs(wx) + col_atol * scale[j]
                    assert abs(gx - wx) <= tol, (where, g, w)


def _result_fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name not in ("output_dir",)}


def assert_same_results(got, want, rtol, scale_atol, net_atol):
    """Every field of two RunResults: arrays at rtol plus scale_atol of the
    array's scale (net_atol of the flux scale for the net fluxes)."""
    g, w = _result_fields(got), _result_fields(want)
    assert sorted(g) == sorted(w)
    flux_scale = float(np.abs(want.F_up_tot).max())
    for k, wv in w.items():
        gv = g[k]
        if wv is None or isinstance(wv, (str, int, float)):
            assert gv == wv or (isinstance(wv, float)
                                and np.isclose(gv, wv, rtol=rtol)), k
            continue
        wv = np.asarray(wv, dtype=float)
        gv = np.asarray(gv, dtype=float)
        assert gv.shape == wv.shape, k
        atol = scale_atol * float(np.abs(wv).max()) if wv.size else 0.0
        if k.startswith("F_net"):
            atol = net_atol * flux_scale
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol + TINY,
                                   err_msg=k)


def zenith_weights(L, mu_star):
    """The geometric zenith correction's mu(i, j) [L+1, L] of both packages
    for a rising altitude profile of a Jupiter-sized planet, and the masked
    1/mu weights and mu(i, i) that compute_cells builds from it."""
    import jax.numpy as jnp
    from helios_tpu.ops import beam as jbeam
    from helios_tpu_torch import fastpath as tfp
    z = np.cumsum(np.full(L, 4e7)) - 2e8
    R_planet = 7.0e9
    want = jbeam._mu_star_matrix(jnp.asarray(z), mu_star, R_planet, 1,
                                 L + 1, jnp.float64)
    got = tfp.mu_star_matrix(torch.tensor(z), mu_star, R_planet, L + 1)
    assert_close(got.numpy(), want, rtol=1e-15)
    mask = np.arange(L)[None, :] >= np.arange(L + 1)[:, None]
    weights = np.where(mask, 1.0 / np.asarray(want), 0.0)
    return weights, np.diagonal(np.asarray(want)[:L])

"""The port's on-the-fly opacity mixing (helios_tpu_torch.kernels.ro,
.ops.mixing, .chem, the on-the-fly branches of .forward, .rce and
.pipeline) against the JAX package and the numpy oracle of the reference's
Random Overlap (tests/reference_mixing.py) on the CPU.

Tolerances: 1e-12 throughout, but for the small isothermal run to
convergence, which is held at the 1e-8 of tests/test_torch_iso.py (no
convection loop: the final T carries where each run stopped inside its
criterion).  Iso runs and forward solves compare against the JAX package's
native fp64 Planck branch (ROADMAP C).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helios_tpu import chem as jchem
from helios_tpu import forward as jf
from helios_tpu import pipeline as jax_pipeline
from helios_tpu.config import HeliosConfig as JaxConfig
from helios_tpu.io.opacity import gauss_legendre_ypoints, save_opacity_file
from helios_tpu.io.opacity import synthetic_premixed_table
from helios_tpu.ops import mixing as jmix
from helios_tpu_torch import chem as tchem
from helios_tpu_torch import constants as pc
from helios_tpu_torch import convert
from helios_tpu_torch import forward as tf
from helios_tpu_torch import pipeline as torch_pipeline
from helios_tpu_torch.config import HeliosConfig as TorchConfig
from helios_tpu_torch.kernels.ro import (MAX_NY, ro_general_cells, ro_mix,
                                         ro_mix_reference, stream_weights_ok)
from helios_tpu_torch.ops import mixing as tmix

import reference_mixing as refm
import torch_port_helpers as H


def _gauss(ny):
    y, w = gauss_legendre_ypoints(ny)
    return np.asarray(y, float), np.asarray(w, float)


def _cells(seed, C, ny):
    """[C, ny] ascending k-distributions: random, some cells with exact
    ties (new == mixed, and gray distributions, all sums equal), some
    negligible in either direction."""
    rng = np.random.default_rng(seed)
    mixed = np.sort(10.0 ** rng.uniform(-4, 1, (C, ny)), axis=1)
    new = np.sort(10.0 ** rng.uniform(-3, 0.5, (C, ny)), axis=1)
    new[0::7] = mixed[0::7]                        # m_i + n_j == m_j + n_i
    mixed[1::7] = 0.3
    new[1::7] = 0.05                               # gray: all sums tie
    new[2::7] *= 1e-7                              # negligible new
    mixed[3::7] *= 1e-8                            # negligible mixed
    return mixed, new


# --------------------------------------------------------------------------- #
# the Random Overlap
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ny", [4, 20])
def test_random_overlap_mix_matches_jax_and_oracle(ny):
    """random_overlap_mix against JAX's random_overlap_mix and ro_mix
    (negligible cells kept as the plain sum) against the per-cell oracle
    of the reference's kernel, at 1e-12, with tied sums."""
    y, w = _gauss(ny)
    mixed, new = _cells(ny, 28, ny)
    t = torch.from_numpy
    got = tmix.random_overlap_mix(t(mixed), t(new), t(w), t(y)).numpy()
    want = np.asarray(jmix.random_overlap_mix(
        jnp.asarray(mixed), jnp.asarray(new), jnp.asarray(w), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-12)

    got = ro_mix(t(mixed), t(new), t(w), t(y)).numpy()
    neg = tmix.negligible_overlap(t(mixed), t(new)).numpy()
    assert 0 < neg.sum() < len(neg)
    for c in range(len(mixed)):
        oracle = refm.add_to_mixed_opac_cell(mixed[c].copy(), new[c], w, y,
                                             s=1, ro_method=1)
        np.testing.assert_allclose(got[c], oracle, rtol=1e-12,
                                   err_msg=f"cell {c}")


def test_add_species_opacity_matches_jax():
    """add_species_opacity (VMR weighting, negligible test, RO) on an
    [L, B, ny] grid against JAX at 1e-12; correlated-k for the first
    species and for ro_method 0."""
    ny, L, B = 20, 3, 7
    y, w = _gauss(ny)
    mixed, new = _cells(5, L * B, ny)
    mixed, new = mixed.reshape(L, B, ny), new.reshape(L, B, ny)
    rng = np.random.default_rng(6)
    vmr = rng.uniform(1e-4, 1e-2, L)
    mmm = rng.uniform(2.0, 3.0, L) * pc.AMU
    mass = 18.0153 * pc.AMU
    for index, method in ((1, 1), (0, 1), (1, 0)):
        kw = dict(species_index=index, ro_method=method)
        got = tmix.add_species_opacity(
            *(torch.from_numpy(x) for x in (mixed, new, vmr)), mass,
            torch.from_numpy(mmm), torch.from_numpy(w),
            torch.from_numpy(y), **kw).numpy()
        want = np.asarray(jmix.add_species_opacity(
            *(jnp.asarray(x) for x in (mixed, new, vmr)), mass,
            jnp.asarray(mmm), jnp.asarray(w), jnp.asarray(y), **kw))
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=str(kw))


def test_ro_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors ro_mix returns exactly the plain version's result and
    launches nothing; fp32 runs in fp32, within 1e-4 of fp64 (the
    interpolation divides by yg differences of ~1e-3 at ny = 8, which
    amplifies fp32's rounding of yg; 2.8e-5 measured)."""
    y, w = _gauss(8)
    mixed, new = _cells(7, 14, 8)
    ts = [torch.from_numpy(x) for x in (mixed, new, w, y)]
    before = ro_mix.launches
    torch.testing.assert_close(ro_mix(*ts), ro_mix_reference(*ts), rtol=0,
                               atol=0)
    assert ro_mix.launches == before
    got = ro_mix(*(t.float() for t in ts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(),
                               ro_mix(*ts).numpy(), rtol=1e-4)


def _ro_args(C=6, ny=4):
    y, w = _gauss(ny)
    mixed, new = _cells(8, C, ny)
    return [torch.from_numpy(x) for x in (mixed, new, w, y)]


RO_BAD_ARGUMENTS = [
    ("ny_one", lambda ts: ts.__setitem__(slice(None), _ro_args(ny=1)),
     ValueError, "ny"),
    ("ny_above_the_kernel", lambda ts: ts.__setitem__(
        slice(None), _ro_args(ny=MAX_NY + 1)), ValueError, "ny"),
    ("one_dim", lambda ts: ts.__setitem__(0, ts[0][0]), ValueError,
     r"\[C, ny\]"),
    ("shape", lambda ts: ts.__setitem__(1, ts[1][:-1].contiguous()),
     ValueError, "shape"),
    ("gauss_shape", lambda ts: ts.__setitem__(3, ts[3][:-1].contiguous()),
     ValueError, "shape"),
    ("dtypes", lambda ts: ts.__setitem__(2, ts[2].float()), TypeError,
     "dtype"),
    ("contiguous", lambda ts: ts.__setitem__(
        0, ts[0].t().contiguous().t()), ValueError, "contiguous"),
    ("device", lambda ts: ts.__setitem__(slice(None),
                                         [t.to("meta") for t in ts]),
     ValueError, "cuda or cpu"),
]


@pytest.mark.parametrize("spoil,exc,match",
                         [b[1:] for b in RO_BAD_ARGUMENTS],
                         ids=[b[0] for b in RO_BAD_ARGUMENTS])
def test_ro_wrapper_rejects_bad_arguments(spoil, exc, match):
    """Shapes, dtypes, devices, layouts and an ny outside what the kernel
    takes (2..126) raise, on any device; nothing is adjusted."""
    ts = _ro_args()
    spoil(ts)
    with pytest.raises(exc, match=match):
        ro_mix(*ts)


# --------------------------------------------------------------------------- #
# the kernel's per-cell algorithm (csrc/ro_mix.cu), transcribed
# --------------------------------------------------------------------------- #

_TAG_BITS = 8


def _interpolate(k_lo, yg_lo, k_hi, yg_hi, g):
    return (k_lo * (yg_hi - g) + k_hi * (g - yg_lo)) / (yg_hi - yg_lo)


def _stream_cell(m, n, hw, gy):
    """The kernel's streaming branch for one cell, in numpy scalars of the
    cell's dtype: the loser-tree merge of the ny rows (node q at [q], leaf
    i at q = ny + i; tag i << 8 | j, (i + ny) << 8 once row i is used up),
    the weight sum in pop order, and the streaming rebin with its queue of
    known nodes (head y_out with w_head, w consecutive behind it), and the
    check at each position that yg did not decrease.  Returns (out, flat
    indices in pop order, nodes past the last yg, yg never decreased)."""
    ny = len(m)
    n2 = ny * ny
    dt = m.dtype.type
    key, tag = [None] * ny, [0] * ny

    def node(c):
        if c >= ny:
            return m[c - ny] + n[0], (c - ny) << _TAG_BITS
        return key[c], tag[c]

    def before(a, b):
        return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])

    for q in range(ny - 1, 0, -1):              # winners, bottom-up
        left, right = node(2 * q), node(2 * q + 1)
        key[q], tag[q] = right if before(right, left) else left
    win = key[1], tag[1]
    for q in range(1, ny):                      # losers, top-down
        left, right = node(2 * q), node(2 * q + 1)
        key[q], tag[q] = left if before(right, left) else right

    out = np.full(ny, np.nan, m.dtype)
    order = []
    acc = prev_k = prev_yg = dt(0)
    rising = True
    y_next = y_out = w_last = w_head = past = 0
    for t in range(n2):
        r, j = win[1] >> _TAG_BITS, win[1] & ((1 << _TAG_BITS) - 1)
        order.append(r * ny + j)
        wgt = hw[r] * hw[j]
        acc = acc + wgt
        yg = acc - dt(0.5) * wgt
        rising = rising and bool(yg >= prev_yg)
        while y_next < ny and (yg > gy[y_next] or t == n2 - 1):
            past += not yg > gy[y_next]
            w_last = min(max(t, w_last + 1), n2 - 1)
            if y_next == y_out:
                w_head = w_last
            y_next += 1
        while y_out < y_next and w_head == t:
            out[y_out] = _interpolate(prev_k, prev_yg, win[0], yg, gy[y_out])
            y_out += 1
            w_head = min(w_head + 1, n2 - 1)
        prev_k, prev_yg = win[0], yg
        j1 = j + 1
        carry = ((m[r] + n[j1], r << _TAG_BITS | j1) if j1 < ny
                 else (dt(np.inf), (r + ny) << _TAG_BITS))
        q = (ny + r) >> 1
        while q >= 1:                           # replay the leaf's path
            if before((key[q], tag[q]), carry):
                (key[q], tag[q]), carry = carry, (key[q], tag[q])
            q >>= 1
        win = carry
    assert y_out == ny
    return out, order, past, rising


def _general_cell(m, n, hw, gy):
    """The kernel's general branch for one cell: each flat index ranked
    against all others in (key, index) order with NaN last, the weight sum
    along that permutation, first_y = #(yg <= g_y), the w recurrence and
    the interpolation."""
    ny = len(m)
    n2 = ny * ny
    dt = m.dtype.type
    keys = (m[:, None] + n[None, :]).ravel()
    idx = np.arange(n2)
    ka, kb = keys[:, None], keys[None, :]
    na, nb = np.isnan(ka), np.isnan(kb)
    lower = idx[:, None] < idx[None, :]
    before = np.where(na | nb, ~na | (nb & lower),
                      (ka < kb) | ((ka == kb) & lower))
    perm = np.empty(n2, int)
    perm[before.sum(axis=0)] = idx
    wgt = hw[perm // ny] * hw[perm % ny]
    yg = np.empty(n2, m.dtype)
    acc = dt(0)
    for t in range(n2):
        acc = acc + wgt[t]
        yg[t] = acc - dt(0.5) * wgt[t]
    first = (yg[:, None] <= gy[None, :]).sum(axis=0)
    out = np.empty(ny, m.dtype)
    w_prev = 0
    for y in range(ny):
        w = min(max(int(first[y]), w_prev + 1), n2 - 1)
        out[y] = _interpolate(keys[perm[w - 1]], yg[w - 1], keys[perm[w]],
                              yg[w], gy[y])
        w_prev = w
    return out


def _kernel_cells(mixed, new, gauss_weight, gauss_y):
    """The kernel's choice of branch and its result, cell by cell: the plain
    sum where the overlap is negligible; the stream where new is
    non-decreasing, mixed and new are finite, the weights pass the
    launch's check and yg never decreased along the stream; else the
    general branch.  Returns (out, branch names, {cell: pop order}, nodes
    past the last yg)."""
    dt = mixed.dtype.type
    hw = dt(0.5) * gauss_weight
    weights_ok = stream_weights_ok(torch.from_numpy(gauss_weight),
                                   torch.from_numpy(gauss_y))
    out = np.empty_like(mixed)
    branch, orders, past = [], {}, 0
    for c, (m, n) in enumerate(zip(mixed, new)):
        if dt(0.01) * m[0] > n[-1] or dt(0.01) * n[0] > m[-1]:
            out[c] = m + n
            branch.append("negligible")
        elif (weights_ok and np.isfinite(m).all() and np.isfinite(n).all()
              and (n[1:] >= n[:-1]).all()
              and (streamed := _stream_cell(m, n, hw, gauss_y))[3]):
            out[c], orders[c], p, _ = streamed
            past += p
            branch.append("stream")
        else:
            out[c] = _general_cell(m, n, hw, gauss_y)
            branch.append("general")
    return out, branch, orders, past


def _transcription_cells(rng, ny, dtype):
    """One cell of each kind the transcription test needs, ascending unless
    said: random; exact ties (new == mixed); gray (all sums tie); rounding
    ties within a row (new spans less than half an ulp of mixed); ties
    across rows among unequal weights (mixed and new arithmetic with steps
    0.5 and 1); mixed unsorted (still the stream); new unsorted (the
    general branch); non-finite (general); negligible either way; a +0 sum
    tied with a later -0 sum."""
    eps = np.finfo(dtype).eps
    rand = lambda lo, hi: np.sort(10.0 ** rng.uniform(lo, hi, ny))
    kinds = [
        (rand(-4, 1), rand(-3, 0.5)),
        (rand(-2, 1),) * 2,
        (np.full(ny, 0.3), np.full(ny, 0.05)),
        (1.0 + 1e-3 * np.arange(ny), np.sort(rng.uniform(0, eps / 4, ny))),
        (0.5 * np.arange(ny) + 1.0, 1.0 * np.arange(ny) + 2.0),
        (rng.permutation(rand(-4, 1)), rand(-3, 0.5)),
        (rand(-4, 1), rng.permutation(rand(-3, 0.5))),
        (np.where(np.arange(ny) == 1, np.nan, rand(-2, 0)), rand(-2, 0)),
        (rand(-2, 0), np.where(np.arange(ny) == ny - 1, np.inf, rand(-2, 0))),
        (rand(-4, -3), rand(0, 1)),
        (rand(0, 1), rand(-4, -3)),
        (np.r_[0.0, -0.0, rand(-2, 0)[2:]], np.r_[-0.0, rand(-2, 0)[1:]]),
    ]
    mixed = np.array([m for m, _ in kinds], dtype)
    new = np.array([n for _, n in kinds], dtype)
    return mixed, new


def _assert_bitwise(got, want, msg):
    ints = {np.dtype(np.float64): np.int64, np.dtype(np.float32): np.int32}
    bad = (got.view(ints[got.dtype]) != want.view(ints[want.dtype])).any(-1)
    assert not bad.any(), f"{msg}: cells {np.flatnonzero(bad)} differ"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ny", [2, 3, 4, 5, 16, 17, 20, 32])
def test_ro_kernel_transcription_matches_plain_bitwise(ny, dtype):
    """A transcription of csrc/ro_mix.cu's per-cell algorithm (the branch
    choice, the loser-tree merge, the in-order weight sum, the streaming
    rebin with its queue, the general branch) equals random_overlap_mix
    (with negligible cells kept as the plain sum) bit for bit, rtol 0, on
    ties, gray cells, rounding ties in a row, ties across rows, unsorted
    and non-finite cells; the merge pops the sums in torch.sort's stable
    order; ro_general_cells names the cells of the general branch.  Also
    with the last Gauss node past the last yg, with nodes closer together
    than a yg step (and two equal), with a weight far below the others
    (the stream still takes the sorted cells), with a zero weight (the
    launch's check fails: every live cell general) and with a weight whose
    square overflows (yg turns NaN on every live cell's stream: every live
    cell general by the check at each position)."""
    y, w = (a.astype(dtype) for a in _gauss(ny))
    rng = np.random.default_rng(ny)
    mixed, new = _transcription_cells(rng, ny, dtype)
    past_end = y.copy()
    past_end[-1] = dtype(1 - 1e-7)
    clustered = y.copy()
    clustered[1::2] = clustered[0::2][:ny // 2] + dtype(1e-12)
    clustered[-1] = clustered[-2]
    tiny, zero, huge = w.copy(), w.copy(), w.copy()
    tiny[0] = dtype(1e-30)
    zero[0] = dtype(0)
    huge[0] = np.sqrt(np.finfo(dtype).max) * dtype(4)
    past = 0
    every_branch = {"negligible", "stream", "general"}
    for label, gw, gy, want in (
            ("gauss", w, y, every_branch),
            ("past the last yg", w, past_end, every_branch),
            ("clustered", w, np.sort(clustered), every_branch),
            ("tiny weight", tiny, y, every_branch),
            ("zero weight", zero, y, {"negligible", "general"}),
            ("overflowing weight", huge, y, {"negligible", "general"})):
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            got, branch, orders, p = _kernel_cells(mixed, new, gw, gy)
        past += p if label == "past the last yg" else 0
        ts = [torch.from_numpy(a) for a in (mixed, new, gw, gy)]
        _assert_bitwise(got, ro_mix_reference(*ts).numpy(), label)
        for c, order in orders.items():
            keys = torch.from_numpy(np.add.outer(mixed[c], new[c]).ravel())
            assert order == torch.sort(keys, stable=True)[1].tolist(), \
                f"{label}: cell {c} merge order"
        assert ro_general_cells(*ts).tolist() == [b == "general"
                                                  for b in branch], label
        assert set(branch) == want, (label, branch)
    assert past > 0      # some node lies past the last yg


def test_h2o_rayleigh_matches_jax():
    """h2o_scat_cross on a grid of wavelengths, pressures, temperatures and
    VMRs, both sides of the 2.5 um limit, at 1e-12 plus 1e-10 of the
    array's scale: XLA's and PyTorch's sqrt differ in the last bit, and
    (n^2 - 1) of a refractive index n = 1 + O(1e-12) at low water density
    amplifies that (4.3e-11 of the scale measured, ROADMAP C)."""
    wave = np.geomspace(0.3e-4, 4e-4, 9)
    press = np.geomspace(1e2, 1e9, 6)
    temp = np.linspace(300.0, 2500.0, 6)
    vmr = np.geomspace(1e-5, 1e-1, 6)
    mass = 18.0153 * pc.AMU
    got = tmix.h2o_scat_cross(*(torch.from_numpy(x)
                                for x in (wave, press, temp, vmr)), mass)
    want = jmix.h2o_scat_cross(*(jnp.asarray(x)
                                 for x in (wave, press, temp, vmr)), mass)
    H.assert_close(got.numpy(), want, rtol=1e-12, scale_atol=1e-10)
    assert (got[:, wave >= 2.5e-4] == 0).all()


# --------------------------------------------------------------------------- #
# species sets and the mixing pass
# --------------------------------------------------------------------------- #

FC_T = np.linspace(200.0, 4000.0, 7)
FC_PBAR = np.geomspace(1e-6, 1e3, 5)


def _fastchem_data():
    """A FastChem table in the load_fastchem_table convention: column ->
    [nT * nP] (P fastest), with the grids (P in cgs)."""
    Tg, Pg = np.meshgrid(FC_T, FC_PBAR, indexing="ij")
    data = {"H2O1": 1e-3 * (Tg / 1000.0) ** -0.5 * (1 + 0.01 * np.log10(Pg)),
            "C1O2": 1e-4 * (Tg / 1000.0) ** 0.3, "H2": np.full_like(Tg, 0.85),
            "He": np.full_like(Tg, 0.15)}
    return {k: v.ravel() for k, v in data.items()}, FC_T, FC_PBAR * 1e6


def _species(L, donor, source):
    """Two absorbers (H2O scattering by its own Rayleigh formula, CO2),
    H2 scattering from a table, He; VMRs from ``source``."""
    press = np.geomspace(1e10, 1e1, 25)
    srcs = {"constant": ("1e-3", "1e-4", "0.9", "0.1"),
            "file": ("file", "file", "0.9", "0.1"),
            "FastChem": ("FastChem",) * 4}[source]
    # He listed first: the set moves the first absorber (H2O) to the front
    specs = [("He", False, False, srcs[3]), ("H2O", True, True, srcs[0]),
             ("CO2", True, False, srcs[1]), ("H2", False, True, srcs[2])]
    kw = dict(ktemps=donor.temperatures, kpress=donor.pressures,
              nbin=donor.nbin, ny=donor.ny, nlayer=L,
              opacity_tables={"H2O": donor.kpoints,
                              "CO2": donor.kpoints * 3.0},
              scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4},
              vmr_file_table={"H2O": 1e-3 * (press / 1e9) ** 0.1,
                              "CO2": np.full(25, 1e-4)},
              vmr_file_press=press,
              fastchem_data=_fastchem_data(),
              p_lay=np.geomspace(1e8, 1e3, L),
              p_int=np.geomspace(1.2e8, 0.8e3, L + 1))
    jset = jchem.build_species_set(
        [jchem.SpeciesSpec(*s) for s in specs], **kw)
    tset = tchem.build_species_set(
        [tchem.SpeciesSpec(*s) for s in specs], device="cpu", **kw)
    return jset, tset


def _converted(jset):
    return convert.species_set_from_numpy(
        jset.specs, [H.nested_numpy(d) for d in jset.data],
        np.asarray(jset.ktemps), np.asarray(jset.kpress), device="cpu")


@pytest.mark.parametrize("source", ["constant", "file", "FastChem"])
def test_species_sets_match(source):
    """build_species_set (host part copied) gives the JAX set's tensors, in
    its order (first absorber first); species_set_from_numpy carries the
    JAX set over unchanged."""
    donor = synthetic_premixed_table(nbin=8, ny=4, ntemp=8, npress=6, seed=1)
    jset, tset = _species(6, donor, source)
    for got in (tset, _converted(jset)):
        assert [s.name for s in got.specs] == [s.name for s in jset.specs]
        assert got.specs[0].name == "H2O"
        for gs, js in zip(got.specs, jset.specs):
            assert (gs.absorbing, gs.scattering, gs.source_for_vmr,
                    gs.weight, gs.fc_name) == (
                        js.absorbing, js.scattering, js.source_for_vmr,
                        js.weight, js.fc_name)
        for gd, jd in zip(got.data, jset.data):
            for f in tchem.SpeciesDeviceData._fields:
                np.testing.assert_array_equal(getattr(gd, f).numpy(),
                                              np.asarray(getattr(jd, f)),
                                              err_msg=f)
        np.testing.assert_array_equal(got.ktemps.numpy(), jset.ktemps)


@pytest.mark.parametrize("source", ["constant", "file", "FastChem"])
def test_mixed_opacities_match(source):
    """One mixing pass (opacity, Rayleigh cross sections with H2O's own
    formula, mean molecular mass) on layers and on interfaces, RO and
    correlated-k, at 1e-12; the cross sections plus 1e-11 of their scale
    (H2O's last-bit sqrt, test_h2o_rayleigh_matches_jax)."""
    ny, L = 20, 6
    donor = synthetic_premixed_table(nbin=8, ny=ny, ntemp=8, npress=6,
                                     seed=1)
    jset, _ = _species(L, donor, source)
    tset = _converted(jset)
    y, w = _gauss(ny)
    wave = donor.wave_centers
    for n in (L, L + 1):
        T = np.linspace(1800.0, 600.0, n)
        p = np.geomspace(1e8, 1e3, n)
        for ro in (1, 0):
            want = jchem.mixed_opacities(
                jset, jnp.asarray(T), jnp.asarray(p), jnp.asarray(wave),
                jnp.asarray(w), jnp.asarray(y), ro_method=ro, scat=1)
            got = tchem.mixed_opacities(
                tset, *(torch.from_numpy(x) for x in (T, p, wave, w, y)),
                ro_method=ro, scat=1)
            for g, wt, name in zip(got, want, ("opac", "scat", "mmm")):
                H.assert_close(g.numpy(), wt, rtol=1e-12,
                               scale_atol=1e-11 if name == "scat" else 0.0,
                               err_msg=f"{name} n={n} ro={ro}")


# --------------------------------------------------------------------------- #
# the forward model and the runs
# --------------------------------------------------------------------------- #

OTF = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0, R_star=1.0,
           T_star=4000.0, T_intern=100.0, scattering="yes",
           direct_beam="no", convection="no", run_type="iterative",
           p_boa=1e8, p_toa=1e3, opacity_mixing="on-the-fly",
           k_mixing_method="RO")


@pytest.mark.parametrize("iso", [True, False], ids=["iso", "noniso"])
def test_on_the_fly_forward_fluxes_match(iso):
    """forward_fluxes with on-the-fly RO mixing (layers, and interfaces for
    non-isothermal layers) from identical model arrays and species sets:
    the mixed cells and the totals at 1e-12."""
    L, ny = 8, 20
    donor = synthetic_premixed_table(nbin=8, ny=ny, ntemp=8, npress=6,
                                     seed=1)
    kw = dict(OTF, nlayer=L, iso_input="yes" if iso else "no")
    jphys, jarr = jf.build_model(JaxConfig(**kw).finalize(), donor)
    jarr = H.native_planck(jarr)
    d = {k: v for k, v in H.nested_numpy(jarr).items()
         if k != "planck_grid_pairs"}
    tarr = convert.model_arrays_from_numpy(d, device="cpu")
    tphys = tf.Phys.from_config(TorchConfig(**kw).finalize(), nbin=8, ny=ny)
    assert tphys.opacity_mixing == "on-the-fly" and tphys.ro_method == 1
    jset, _ = _species(L, donor, "file")
    tset = _converted(jset)

    T = np.linspace(1500.0, 700.0, L + 1)
    want = jax.jit(lambda t: jf.forward_fluxes(jphys, jarr, t, sset=jset))(
        jnp.asarray(T))
    got = tf.forward_fluxes(tphys, tarr, torch.tensor(T), sset=tset)
    for f in ("opac_lay", "scat_cross_lay", "meanmolmass_lay"):
        H.assert_close(getattr(got[2], f).numpy(), getattr(want[2], f),
                       rtol=1e-12, err_msg=f)
    for f in ("F_up_tot", "F_down_tot"):
        H.assert_close(getattr(got[1], f).numpy(), getattr(want[1], f),
                       rtol=1e-12, err_msg=f)
    with pytest.raises(ValueError, match="species set"):
        tf.forward_fluxes(tphys, tarr, torch.tensor(T))


BASE = dict(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
            R_star=1.0, T_star=4000.0, T_intern=200.0,
            direct_beam="no", nlayer=12, p_boa=1e8, p_toa=1e3,
            rad_convergence_limit=1e-6)


@pytest.mark.parametrize("k_mixing", ["RO", "correlated-k"])
def test_baseline_config3_matches_jax_pipeline(monkeypatch, k_mixing):
    """BASELINE config 3 as tests/test_parity_configs.py runs it
    (on-the-fly mixing, VMR profiles from a file, isothermal layers), with
    Random Overlap and with correlated-k, through both packages'
    pipeline.run to convergence: final T at 1e-8, against the JAX run with
    native fp64 Planck lookups."""
    B, ny, L = 16, 4, 12
    donor = synthetic_premixed_table(nbin=B, ny=ny, ntemp=8, npress=6,
                                     seed=1)
    press = np.geomspace(1e9, 1e2, 25)
    specs = [("H2O", True, False, "file"), ("CO2", True, False, "file"),
             ("H2", False, False, "0.9"), ("He", False, False, "0.1")]
    kw = dict(ktemps=donor.temperatures, kpress=donor.pressures, nbin=B,
              ny=ny, nlayer=L,
              opacity_tables={"H2O": donor.kpoints,
                              "CO2": donor.kpoints * 3.0},
              vmr_file_table={"H2O": 1e-3 * (press / 1e9) ** 0.1,
                              "CO2": np.full(25, 1e-4)},
              vmr_file_press=press, p_lay=np.geomspace(1e8, 1e3, L),
              p_int=np.geomspace(1e8, 1e3, L + 1))
    jset = jchem.build_species_set(
        [jchem.SpeciesSpec(*s) for s in specs], **kw)
    tset = tchem.build_species_set(
        [tchem.SpeciesSpec(*s) for s in specs], device="cpu", **kw)
    cfg = dict(scattering="no", convection="no", run_type="iterative",
               iso_input="yes", opacity_mixing="on-the-fly",
               k_mixing_method=k_mixing, **BASE)

    got = torch_pipeline.run(TorchConfig(**cfg), donor, sset=tset,
                             write_output=False, device="cpu")
    assert got.phys.opacity_mixing == "on-the-fly" and got.conv is None
    assert bool(got.rad.abort.all()) and not got.rad.aborted
    mmm = got.result.meanmolmass_lay
    assert mmm.std() / mmm.mean() > 1e-7      # the VMR profile reached it

    build = jax_pipeline.build_model
    monkeypatch.setattr(
        jax_pipeline, "build_model",
        lambda *a, **k: (lambda pa: (pa[0], H.native_planck(pa[1])))(
            build(*a, **k)))
    native = jax_pipeline.run(JaxConfig(**cfg), table=donor, sset=jset,
                              write_output=False)
    assert bool(jnp.all(native.rad.abort))
    np.testing.assert_allclose(got.T_lay.numpy(),
                               np.asarray(native.rad.T_lay), rtol=1e-8)
    H.assert_close(mmm, native.result.meanmolmass_lay, rtol=1e-12)


def _write_species_inputs(tmp_path, donor):
    """Species file, per-species opacity files (save_opacity_file with
    premixed=False), Rayleigh cross sections and a VMR file."""
    import h5py

    d = tmp_path / "opac"
    d.mkdir()
    for name, k in (("H2O", donor.kpoints), ("CO2", donor.kpoints * 3.0)):
        t = synthetic_premixed_table(nbin=donor.nbin, ny=donor.ny, ntemp=8,
                                     npress=6, seed=1)
        t.kpoints = k
        save_opacity_file(str(d / f"{name}_opac_ip_kdistr.h5"), t,
                          premixed=False)
    with h5py.File(d / "scat_cross_sections.h5", "w") as f:
        f.create_dataset("rayleigh_H2",
                         data=8.49e-45 / donor.wave_centers ** 4)
    species = tmp_path / "species.dat"
    species.write_text("species absorbing scattering mixing_ratio\n"
                       "H2O yes yes file\nCO2 yes no 1e-4\n"
                       "H2 no yes 0.9\nHe no no 0.1\n")
    vmr = tmp_path / "vmr.dat"
    press = np.geomspace(1e3, 1e-4, 20)          # bar
    with open(vmr, "w") as f:
        f.write("vertical mixing ratios\nPressure H2O\n")
        for p in press:
            f.write(f"{float(p)!r} {float(1e-3 * (p / 1e3) ** 0.1)!r}\n")
    return dict(species_path=str(species), species_opacity_dir=str(d),
                vmr_file_path=str(vmr), vmr_file_press_unit="bar")


def test_species_set_from_files_matches_jax(tmp_path):
    """build_species_set_from_files against the JAX loader on files written
    to disk: the same donor grids and the same set, bit for bit."""
    donor = synthetic_premixed_table(nbin=8, ny=4, ntemp=8, npress=6, seed=1)
    files = _write_species_inputs(tmp_path, donor)
    kw = dict(OTF, nlayer=6, iso_input="yes", **files)
    jset, jdonor = jax_pipeline.build_species_set_from_files(
        JaxConfig(**kw).finalize())
    tset, tdonor = torch_pipeline.build_species_set_from_files(
        TorchConfig(**kw).finalize(), device="cpu")
    for f in ("kpoints", "temperatures", "pressures", "wave_centers"):
        np.testing.assert_array_equal(getattr(tdonor, f),
                                      getattr(jdonor, f))
    assert [s.name for s in tset.specs] == [s.name for s in jset.specs]
    for gd, jd in zip(tset.data, jset.data):
        for f in tchem.SpeciesDeviceData._fields:
            np.testing.assert_array_equal(getattr(gd, f).numpy(),
                                          np.asarray(getattr(jd, f)),
                                          err_msg=f)
    assert tset.data[-2].scat_cross.abs().max() > 0     # H2 from the file

    # run() builds the same set from the config's files when none is given
    got = torch_pipeline.run(TorchConfig(**kw), write_output=False,
                             device="cpu")
    assert got.phys.nbin == 8 and bool(torch.isfinite(got.T_lay).all())

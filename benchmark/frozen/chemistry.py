"""The analytic C-H-O equilibrium chemistry of Heng & Lyons (2016, ApJ
817, 149) as extended by Heng & Tsai (2016, ApJ 829, 104), HELIOS's own
validation chemistry (Malik et al. 2017, Fig. 4): a copy of
``helios_tpu_torch.chem_analytic`` (JANAF Gibbs free energies of the three
net reactions on 500-3000 K, the methane quintic, the mole fractions and
their table in FastChem's convention), kept here so that a change to the
program's chemistry cannot move what a cell measures.
``benchmark/tests/test_bench_onthefly_inputs.py`` holds its table bit for
bit to the program's on the same grid."""

from __future__ import annotations

import numpy as np

R_UNIV = 8.3144621          # [J / K / mol]

_T_GRID = np.arange(500.0, 3100.0, 100.0)

# delta G_1 [J/mol]: CH4 + H2O -> CO + 3 H2 (JANAF / Heng & Lyons 2016)
_DG1 = np.array([
    96378.0, 72408.0, 47937.0, 23114.0, -1949.0, -27177.0, -52514.0,
    -77918.0, -103361.0, -128821.0, -154282.0, -179733.0, -205166.0,
    -230576.0, -255957.0, -281308.0, -306626.0, -331911.0, -357162.0,
    -382380.0, -407564.0, -432713.0, -457830.0, -482916.0, -507970.0,
    -532995.0])

# delta G_2 [J/mol]: CO2 + H2 -> CO + H2O
_DG2 = np.array([
    20474.0, 16689.0, 13068.0, 9593.0, 6249.0, 3021.0, -107.0, -3146.0,
    -6106.0, -8998.0, -11828.0, -14600.0, -17323.0, -20000.0, -22634.0,
    -25229.0, -27789.0, -30315.0, -32809.0, -35275.0, -37712.0,
    -40123.0, -42509.0, -44872.0, -47211.0, -49528.0])

# delta G_3 [J/mol]: 2 CH4 -> C2H2 + 3 H2
_DG3 = np.array([
    262934.0, 237509.0, 211383.0, 184764.0, 157809.0, 130623.0,
    103282.0, 75840.0, 48336.0, 20797.0, -6758.0, -34315.0, -61865.0,
    -89403.0, -116921.0, -144422.0, -171898.0, -199353.0, -226786.0,
    -254196.0, -281586.0, -308953.0, -336302.0, -363633.0, -390945.0,
    -418243.0])


def k1(temp, pbar):
    """Normalized equilibrium constant K1' of CH4 + H2O <-> CO + 3 H2."""
    dg = np.interp(temp, _T_GRID, _DG1)
    return np.exp(-dg / (R_UNIV * np.asarray(temp, float))) / pbar ** 2


def k2(temp):
    """Normalized equilibrium constant K2' of CO2 + H2 <-> CO + H2O
    (pressure-free: equal moles on both sides)."""
    dg = np.interp(temp, _T_GRID, _DG2)
    return np.exp(-dg / (R_UNIV * np.asarray(temp, float)))


def k3(temp, pbar):
    """Normalized equilibrium constant K3' of 2 CH4 <-> C2H2 + 3 H2."""
    dg = np.interp(temp, _T_GRID, _DG3)
    return np.exp(-dg / (R_UNIV * np.asarray(temp, float))) / pbar ** 2


def _methane_quintic(K1, K2, K3, n_o, n_c):
    """Coefficients (constant..x^5) of the methane quintic obtained by
    eliminating H2O/CO/CO2/C2H2 from carbon conservation
    (Heng & Tsai 2016, eqs. 20-27)."""
    d = n_o - n_c
    return [
        -2.0 * n_c,
        8.0 * K1 / K2 * d * d + 1.0 + 2.0 * K1 * d,
        8.0 * K1 / K2 * d + 2.0 * K3 + K1,
        2.0 * K1 / K2 * (1.0 + 8.0 * K3 * d) + 2.0 * K1 * K3,
        8.0 * K1 * K3 / K2,
        8.0 * K1 * K3 * K3 / K2,
    ]


def _pick_root(coeffs, K3, d, n_c):
    """The single physical root: real, positive, below the carbon
    budget, with a non-negative implied water abundance."""
    roots = np.polynomial.polynomial.polyroots(coeffs)
    best = None
    for r in roots:
        if abs(r.imag) > 1e-10 * max(1.0, abs(r.real)):
            continue
        x = float(r.real)
        if x <= 0.0 or x > 2.0 * n_c * (1.0 + 1e-9):
            continue
        if 2.0 * K3 * x * x + x + 2.0 * d < 0.0:
            continue
        if best is None or x < best:
            best = x
    if best is None:      # numerically degenerate corner: least-bad root
        best = float(max(r.real for r in roots if abs(r.imag) < 1e-6))
    return best


def solve_cho(n_o, n_c, temp, pbar=1.0):
    """Equilibrium abundances (relative to H2) of the C-H-O system.

    n_o, n_c : elemental oxygen / carbon abundances relative to H2
               (solar: n_o ~ 5e-4, n_c ~ 2.5e-4).
    temp     : temperature [K] (model valid ~500-3000 K).
    pbar     : pressure [bar].

    All arguments broadcast; returns a dict of arrays (or scalars) for
    'CH4', 'H2O', 'CO', 'CO2', 'C2H2'.
    """
    b = np.broadcast(np.asarray(n_o, float), np.asarray(n_c, float),
                     np.asarray(temp, float), np.asarray(pbar, float))
    shape = b.shape
    ch4 = np.empty(b.size)
    K1a = np.empty(b.size)
    K2a = np.empty(b.size)
    K3a = np.empty(b.size)
    da = np.empty(b.size)
    for i, (o, c, T, p) in enumerate(b):
        K1v, K2v, K3v = k1(T, p), k2(T), k3(T, p)
        K1a[i], K2a[i], K3a[i] = K1v, K2v, K3v
        da[i] = o - c
        ch4[i] = _pick_root(_methane_quintic(K1v, K2v, K3v, o, c),
                            K3v, o - c, c)
    h2o = 2.0 * K3a * ch4 ** 2 + ch4 + 2.0 * da
    co = K1a * ch4 * h2o
    co2 = co * h2o / K2a
    c2h2 = K3a * ch4 ** 2
    out = {"CH4": ch4, "H2O": h2o, "CO": co, "CO2": co2, "C2H2": c2h2}
    if shape == ():
        return {s: float(v[0]) for s, v in out.items()}
    return {s: v.reshape(shape) for s, v in out.items()}


def mole_fractions(nd, n_he=0.0):
    """Convert H2-normalized abundances to mole fractions.

    nd   : dict from `solve_cho` (values relative to n_H2).
    n_he : helium abundance relative to H2 (0 for a pure-H2O-CH4-... gas;
           ~0.19 for solar He/H2).

    Returns the dict extended with 'H2' (and 'He' when n_he > 0), all
    normalized so the fractions sum to 1.
    """
    total = 1.0 + n_he
    for v in nd.values():
        total = total + v
    out = {s: v / total for s, v in nd.items()}
    out["H2"] = (np.ones_like(total) if np.ndim(total) else 1.0) / total
    if np.any(np.asarray(n_he) > 0):
        out["He"] = n_he / total
    return out


# FastChem-style species designations for the computed set
_FC_NAMES = {"CH4": "C1H4", "H2O": "H2O1", "CO": "C1O1", "CO2": "C1O2",
             "C2H2": "C2H2", "H2": "H2", "He": "He"}


def as_fastchem_table(temps, pbars, n_o=5.0e-4, n_c=2.5e-4, n_he=0.19):
    """Pretabulate analytic equilibrium mole fractions on a (T, P) grid
    in the `chem.load_fastchem_table` return convention.

    Returns (data, temps, press_cgs) where ``data`` maps FastChem column
    names to [nT * nP] arrays ordered P-fastest -- a drop-in for the
    FastChem triple consumed by `chem.build_species_set(fastchem_data=)`
    and `fastchem_vmr_to_opacity_grid`.
    """
    temps = np.asarray(temps, float)
    pbars = np.asarray(pbars, float)
    Tg, Pg = np.meshgrid(temps, pbars, indexing="ij")
    nd = solve_cho(n_o, n_c, Tg.ravel(), Pg.ravel())
    frac = mole_fractions(nd, n_he=n_he)
    data = {_FC_NAMES[s]: np.asarray(v, float).ravel()
            for s, v in frac.items()}
    return data, temps, pbars * 1.0e6        # P in cgs like chem.dat

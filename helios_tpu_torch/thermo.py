"""Thermodynamics tables: adiabatic coefficient (kappa/delad), heat
capacity, entropy, and water phase state on a (T, P) grid (a copy of the
JAX-free :mod:`helios_tpu.thermo`).

Loader for the reference's ASCII entropy/kappa tables
(source/read.py:1105-1193, read_kappa_table_or_use_constant_kappa):

- ``kappa_value = "file"`` -- "standard format": 2 header lines, then
  columns T[K], P[10^-6 bar], kappa, c_p, and optionally log10(entropy);
  rows missing the entropy column store entropy 0 (-> written as
  "not_calculated", write.py:205-207).
- ``kappa_value = "water_atmo"`` -- water-atmosphere format: 5 header
  lines, then columns T, P, kappa, c_p, log10(entropy), ..., with the
  water phase-state number in column 7.

The reference trusts the file's row ordering to match its flat
``[p + npress * t]`` indexing; here rows are placed explicitly by their
(T, P) values so any row order round-trips identically.

The interpolation rules per quantity follow kernels.cu:703-919 exactly:
kappa and phase state bilinear in (T, log10 P); c_p and entropy bilinear
in (log10 T, log10 P) -- implemented in ops/interp.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class EntropyTable(NamedTuple):
    """(T, P)-gridded thermodynamic quantities, T-major layout."""
    temps: np.ndarray              # [nt]  [K]
    press: np.ndarray              # [np]  [10^-6 bar]
    kappa: np.ndarray              # [nt, np] adiabatic coefficient
    cp: np.ndarray                 # [nt, np] [erg mol^-1 K^-1]
    entropy: np.ndarray            # [nt, np] [erg g^-1 K^-1] (0 = absent)
    phase: Optional[np.ndarray]    # [nt, np] water phase state, or None


def load_entropy_table(path: str, fmt: str = "file") -> EntropyTable:
    """Parse an ASCII kappa/c_p/entropy table (read.py:1105-1193).

    ``fmt``: "file" (standard) or "water_atmo".
    """
    if fmt == "file":
        skip, want_phase = 2, False
    elif fmt == "water_atmo":
        skip, want_phase = 5, True
    else:
        raise ValueError(f"unknown entropy-table format {fmt!r}")

    T_rows, P_rows, kap_rows, cp_rows, s_rows, ph_rows = ([], [], [], [],
                                                          [], [])
    with open(path) as f:
        for _ in range(skip):
            next(f)
        for line in f:
            col = line.split()
            if not col:
                continue
            T_rows.append(float(col[0]))
            P_rows.append(float(col[1]))
            kap_rows.append(float(col[2]))
            cp_rows.append(float(col[3]))
            if want_phase:
                s_rows.append(10.0 ** float(col[4]))
                ph_rows.append(float(col[7]))
            else:
                # standard format: entropy column optional per row
                # (read.py:1137-1140)
                try:
                    s_rows.append(10.0 ** float(col[4]))
                except IndexError:
                    s_rows.append(0.0)

    temps = np.unique(np.asarray(T_rows))
    press = np.unique(np.asarray(P_rows))
    nt, npress = len(temps), len(press)
    if nt * npress != len(T_rows):
        raise ValueError(
            f"entropy table {path}: {len(T_rows)} rows do not fill the "
            f"{nt} x {npress} (T, P) grid")

    ti = np.searchsorted(temps, np.asarray(T_rows))
    pi = np.searchsorted(press, np.asarray(P_rows))

    def grid(vals):
        out = np.zeros((nt, npress))
        out[ti, pi] = np.asarray(vals)
        return out

    return EntropyTable(
        temps=temps, press=press, kappa=grid(kap_rows), cp=grid(cp_rows),
        entropy=grid(s_rows),
        phase=grid(ph_rows) if want_phase else None)

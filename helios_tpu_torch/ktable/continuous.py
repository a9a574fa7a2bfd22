"""Continuum opacities: H- bound-free / free-free (John 1988) and
He- free-free (John 1994).

Parity with reference ktable/source_ktable/continuous.py:29-151;
vectorized over wavelength, and the He- table interpolated with a manual
bilinear in (T, log10 lambda[um]) instead of the removed
scipy.interpolate.interp2d.
"""

from __future__ import annotations

import numpy as np


def h_min_bf_cross_sect(lamda_cm):
    """H- bound-free cross-section per H- ion [cm^2] (John 1988;
    continuous.py:29-63)."""
    lam = np.asarray(lamda_cm, float) * 1e4     # micron
    lamda_0 = 1.6419
    c = [152.519, 49.534, -118.858, 92.536, -34.194, 4.982]
    with np.errstate(invalid="ignore"):
        x = np.maximum(1.0 / lam - 1.0 / lamda_0, 0.0)
        f = sum(c[i] * x ** (i / 2.0) for i in range(6))
        sigma = 1e-18 * lam ** 3 * x ** 1.5 * f
    return np.where((lam < 0.125) | (lam > lamda_0), 0.0, sigma)


_FF_A = [[518.1021, 473.2636, -482.2089, 115.5291, 0, 0],
         [0, 2483.3460, -3449.8890, 2200.0400, -696.2710, 88.2830]]
_FF_B = [[-734.8666, 1443.4137, -737.1616, 169.6374, 0, 0],
         [0, 285.8270, -1158.3820, 2427.7190, -1841.4000, 444.5170]]
_FF_C = [[1021.1775, -1977.3395, 1096.8827, -245.6490, 0, 0],
         [0, -2054.2910, 8746.5230, -13651.1050, 8624.9700, -1863.8640]]
_FF_D = [[-479.0721, 922.3575, -521.1341, 114.2430, 0, 0],
         [0, 2827.7760, -11485.6320, 16755.5240, -10051.5300, 2095.2880]]
_FF_E = [[93.1373, -178.9275, 101.7963, -21.9972, 0, 0],
         [0, -1341.5370, 5303.6090, -7510.4940, 4400.0670, -901.7880]]
_FF_F = [[-6.4285, 12.3600, -7.0571, 1.5097, 0, 0],
         [0, 208.9520, -812.9390, 1132.7380, -655.0200, 132.9850]]


def h_min_ff_cross_sect(lamda_cm, temp, press):
    """H- free-free cross-section per electron per H atom, times pressure
    [cm^5 dyn cm^-2 ... reference units] (John 1988; continuous.py:65-97).
    Broadcasts over lamda/temp/press."""
    lam = np.asarray(lamda_cm, float) * 1e4
    temp = np.asarray(temp, float)
    press = np.asarray(press, float)

    def regime(j):
        s = 0.0
        for i in range(6):
            s = s + (5040.0 / temp) ** ((i + 2) / 2.0) * (
                lam ** 2 * _FF_A[j][i] + _FF_B[j][i] + _FF_C[j][i] / lam
                + _FF_D[j][i] / lam ** 2 + _FF_E[j][i] / lam ** 3
                + _FF_F[j][i] / lam ** 4)
        return s

    k_ff = 1e-29 * np.where(lam < 0.3645, regime(0), regime(1))
    sigma = k_ff * press
    return np.where(lam < 0.1823, 0.0, sigma)


def _he_min_table():
    """John (1994) He- free-free table extended in wavelength and
    temperature (continuous.py:100-148).

    Returns (temp_grid [12] ascending, log10_lam_grid [22] ascending,
    log10_k [12, 22])."""
    lamda_0 = [0.5063, 0.5695, 0.6509, 0.7594, 0.9113, 1.1391, 1.5188,
               1.8225, 2.2782, 3.0376, 3.6451, 4.5564, 6.0751, 9.1127,
               11.3909, 15.1878]
    lamda_plus = [30, 50, 80, 120, 160, 200]
    lamda_all = lamda_0 + lamda_plus

    theta_0 = [0.5, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6, 1.8, 2.0, 2.8, 3.6, 100.8]
    temp_unsorted = [5040.0 / t for t in theta_0]   # descending
    # k_ff rows are ordered by theta (i.e. descending temperature)
    k_ff = np.array([
        [0.121, 0.145, 0.178, 0.227, 0.305, 0.444, 0.737, 1.030, 1.574, 2.765, 3.979, 6.234, 11.147, 25.268, 39.598, 70.580],
        [0.100, 0.120, 0.148, 0.190, 0.258, 0.380, 0.643, 0.910, 1.405, 2.490, 3.592, 5.632, 10.059, 22.747, 35.606, 63.395],
        [0.078, 0.094, 0.117, 0.152, 0.210, 0.316, 0.547, 0.782, 1.218, 2.167, 3.126, 4.897, 8.728, 19.685, 30.782, 54.757],
        [0.072, 0.087, 0.109, 0.143, 0.198, 0.300, 0.522, 0.747, 1.165, 2.073, 2.990, 4.681, 8.338, 18.795, 29.384, 52.262],
        [0.066, 0.081, 0.102, 0.133, 0.186, 0.283, 0.495, 0.710, 1.108, 1.971, 2.842, 4.448, 7.918, 17.838, 27.882, 49.583],
        [0.061, 0.074, 0.094, 0.124, 0.173, 0.266, 0.466, 0.670, 1.045, 1.860, 2.681, 4.193, 7.460, 16.798, 26.252, 46.678],
        [0.055, 0.067, 0.086, 0.114, 0.160, 0.247, 0.435, 0.625, 0.977, 1.737, 2.502, 3.910, 6.955, 15.653, 24.461, 43.488],
        [0.049, 0.061, 0.077, 0.103, 0.147, 0.227, 0.400, 0.576, 0.899, 1.597, 2.299, 3.593, 6.387, 14.372, 22.456, 39.921],
        [0.043, 0.053, 0.069, 0.092, 0.131, 0.204, 0.360, 0.518, 0.808, 1.435, 2.065, 3.226, 5.733, 12.897, 20.151, 35.882],
        [0.036, 0.045, 0.059, 0.079, 0.113, 0.176, 0.311, 0.447, 0.698, 1.239, 1.783, 2.784, 4.947, 11.128, 17.386, 30.907],
        [0.033, 0.041, 0.053, 0.072, 0.102, 0.159, 0.282, 0.405, 0.632, 1.121, 1.614, 2.520, 4.479, 10.074, 15.739, 27.979],
    ])
    upper_limit = [0.307, 0.275, 0.238, 0.227, 0.215, 0.202, 0.189, 0.173,
                   0.155, 0.134, 0.121]

    # the reference maps sorted-ascending temperature index t to table row
    # t-1 (row 0 reused for the two coldest entries, continuous.py:127-142)
    n_t, n_l = len(temp_unsorted), len(lamda_all)
    k_plus = np.zeros((n_t, n_l))
    for t in range(n_t):
        row = 0 if t == 0 else t - 1
        # table rows are theta-ordered = descending T; ascending-T index t
        # corresponds to table row (11 - 1 - row)... the reference indexes
        # k_ff with the ascending-sorted list directly, reusing row t-1
        for x in range(n_l):
            if x < 16:
                k_plus[t, x] = k_ff[row, x]
            else:
                k_plus[t, x] = upper_limit[row] * lamda_all[x] ** 2
    k_plus *= 1e-26

    temp_grid = np.sort(np.asarray(temp_unsorted))
    return temp_grid, np.log10(np.asarray(lamda_all, float)), np.log10(k_plus)


_HE_TEMP, _HE_LOGLAM, _HE_LOGK = _he_min_table()


def he_min_log_k(temp, log10_lam_um):
    """Bilinear lookup of log10 k_ff(T, log10 lambda[um]) with -30 fill
    outside the wavelength range (continuous.py:149)."""
    t = np.asarray(temp, float)
    l = np.asarray(log10_lam_um, float)
    ti = np.clip(np.searchsorted(_HE_TEMP, t) - 1, 0, len(_HE_TEMP) - 2)
    li = np.clip(np.searchsorted(_HE_LOGLAM, l) - 1, 0,
                 len(_HE_LOGLAM) - 2)
    wt = np.clip((t - _HE_TEMP[ti]) / (_HE_TEMP[ti + 1] - _HE_TEMP[ti]),
                 0.0, 1.0)
    wl = (l - _HE_LOGLAM[li]) / (_HE_LOGLAM[li + 1] - _HE_LOGLAM[li])
    out = ((1 - wt) * (1 - wl) * _HE_LOGK[ti, li]
           + (1 - wt) * wl * _HE_LOGK[ti, li + 1]
           + wt * (1 - wl) * _HE_LOGK[ti + 1, li]
           + wt * wl * _HE_LOGK[ti + 1, li + 1])
    oob = (l < _HE_LOGLAM[0]) | (l > _HE_LOGLAM[-1])
    return np.where(oob, -30.0, out)


def he_min_opacity(lamda_cm, temp, press):
    """He- opacity per He atom and electron VMR [cm^2/g-ish per reference
    convention] (combination.py:752-788)."""
    from helios_tpu_torch import constants as pc
    log_lam = np.log10(np.asarray(lamda_cm, float) * 1e4)
    k = 10.0 ** he_min_log_k(temp, log_lam)
    return k * press / (4.0026 * pc.AMU)

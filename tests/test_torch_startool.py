"""The star tool of the PyTorch port (helios_tpu_torch.startool) against
the JAX package's (helios_tpu.startool): the scenarios of
tests/test_cli_tools.py:111-177 and tests/test_tools_readers.py:162 --
the ascii conversion with the blackbody extrapolation, the command line
(in this process and as ``python -m helios_tpu_torch.startool`` in a
subprocess) and the PHOENIX error that lists the download URLs.  The two
modules are the same numpy code: every star file the port writes equals
the JAX package's, dataset by dataset.  Nothing is downloaded:
download_phoenix_file is not called.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from helios_tpu.startool import functions as jst
from helios_tpu.startool.__main__ import main as jst_main
from helios_tpu_torch import constants as pc
from helios_tpu_torch import host_physics as hp
from helios_tpu_torch import tools
from helios_tpu_torch.io.opacity import (save_opacity_file,
                                         synthetic_premixed_table)
from helios_tpu_torch.startool import functions as st
from helios_tpu_torch.startool.__main__ import main as st_main

import torch_port_helpers  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent
T_STAR = 4500.0


def same_h5(got_path, want_path):
    with h5py.File(got_path) as g, h5py.File(want_path) as w:
        names = lambda f: sorted(n for n in _walk(f))
        assert names(g) == names(w)
        for k in names(w):
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


def _walk(f):
    out = []
    f.visititems(lambda n, o: out.append(n)
                 if isinstance(o, h5py.Dataset) else None)
    return out


def star_inputs(tmp_path, nbin, n_points):
    """An opacity table (its wavelength grid) and a truncated 4500 K
    blackbody spectrum at 1 AU in the reference ascii layout."""
    table = synthetic_premixed_table(nbin=nbin, ny=4, ntemp=8, npress=6,
                                     lambda_min=0.3e-4, lambda_max=50e-4)
    opac_path = str(tmp_path / "table.h5")
    save_opacity_file(opac_path, table)
    lam_um = np.geomspace(0.2, 6.0, n_points)
    flux_1au = (np.pi * hp.planck_lambda_np(lam_um * 1e-4, T_STAR)
                / (pc.AU / pc.R_SUN) ** 2)
    src = tmp_path / "star.dat"
    with open(src, "w") as f:
        f.write("#\n" * 8)
        for lam, fl in zip(lam_um, flux_1au):
            f.write(f"{lam:.6e} {fl:.6e}\n")
    star = dict(name="test", data_format="ascii", temp=T_STAR,
                source_file=str(src), w_conversion_factor=1e-4,
                flux_conversion_factor=1.0)
    return table, opac_path, star


@pytest.mark.parametrize("mode,bb", [("automatic", None), ("manual", None),
                                     ("manual", 4000.0)])
def test_startool_ascii_conversion(tmp_path, mode, bb):
    table, opac_path, star = star_inputs(tmp_path, nbin=24, n_points=4000)
    out_h5, jout_h5 = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    lam, conv = st.convert_star(star, "r50", opac_path, out_h5, mode=mode,
                                BB_temp=bb)
    jlam, jconv = jst.convert_star(star, "r50", opac_path, jout_h5,
                                   mode=mode, BB_temp=bb)
    np.testing.assert_array_equal(lam, jlam)
    np.testing.assert_array_equal(conv, jconv)
    same_h5(out_h5, jout_h5)
    with h5py.File(out_h5) as f:
        np.testing.assert_allclose(np.asarray(f["/r50/ascii/test"]), conv)
    if mode == "automatic":
        edges = table.wave_edges
        want = np.pi * tools.calc_analyt_planck_in_interval(
            T_STAR, edges[:-1], edges[1:])
        np.testing.assert_allclose(conv, want, rtol=0.05)


def test_phoenix_missing_files_error_lists_urls(tmp_path):
    grid = [(3000, 5.0, 0.0), (3100, 4.5, -0.5)]
    with pytest.raises(FileNotFoundError) as e:
        st.ensure_phoenix_files(str(tmp_path), "gj1214", grid,
                                download=False)
    with pytest.raises(FileNotFoundError) as je:
        jst.ensure_phoenix_files(str(tmp_path), "gj1214", grid,
                                 download=False)
    msg = str(e.value)
    assert msg == str(je.value)
    assert "lte03000-5.00-0.0.PHOENIX-ACES-AGSS-COND-2011-HiRes.fits" in msg
    assert "WAVE_PHOENIX-ACES-AGSS-COND-2011.fits" in msg
    assert "ftp://phoenix.astro.physik.uni-goettingen.de" in msg
    assert str(tmp_path) in msg and "lte03100-4.50-0.5" in msg


def cli_inputs(tmp_path):
    table, opac_path, star = star_inputs(tmp_path, nbin=16, n_points=2000)
    star = dict(star, name="cli")
    star_json = str(tmp_path / "star.json")
    with open(star_json, "w") as f:
        json.dump(star, f)
    flags = ["-data_format", "ascii", "-name", "cli2", "-temp", str(T_STAR),
             "-source_file", star["source_file"], "-w_conversion_factor",
             "1e-4", "-flux_conversion_factor", "1.0"]
    return table, opac_path, star_json, flags


def test_startool_cli(tmp_path):
    """main() with a JSON star file, then with flags into the same file:
    both star files equal to the JAX package's command line's."""
    table, opac_path, star_json, flags = cli_inputs(tmp_path)
    outs = {}
    for name, main in (("port", st_main), ("jax", jst_main)):
        out_h5 = str(tmp_path / f"{name}.h5")
        common = ["-opac_file", opac_path, "-output_file", out_h5,
                  "-convert_to", "r50"]
        assert main(["-star_file", star_json] + common) == 0
        assert main(flags + common) == 0
        outs[name] = out_h5
    same_h5(outs["port"], outs["jax"])
    with h5py.File(outs["port"]) as f:
        stored = np.asarray(f["/r50/ascii/cli"])
        assert "/r50/ascii/cli2" in f
        np.testing.assert_allclose(np.asarray(f["/r50/lambda"]),
                                   table.wave_centers)
    assert len(stored) == table.nbin and np.all(stored > 0)


def test_startool_cli_in_a_subprocess(tmp_path):
    """``python -m helios_tpu_torch.startool``: -h, and a conversion whose
    file equals the JAX package's in-process one."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "helios_tpu_torch.startool", *a],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    proc = run("-h")
    assert proc.returncode == 0, proc.stderr
    assert "python -m helios_tpu_torch.startool" in proc.stdout
    _, opac_path, star_json, _ = cli_inputs(tmp_path)
    common = ["-opac_file", opac_path, "-convert_to", "r50"]
    proc = run("-star_file", star_json, "-output_file", "port.h5", *common)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "cli: 16 bins" in proc.stdout
    assert jst_main(["-star_file", star_json, "-output_file",
                     str(tmp_path / "jax.h5")] + common) == 0
    same_h5(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))


def test_startool_cli_refuses_a_star_without_name(tmp_path):
    with pytest.raises(SystemExit):
        st_main(["-data_format", "ascii", "-opac_file", "x.h5"])

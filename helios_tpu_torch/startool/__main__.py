"""startool CLI: ``python -m helios_tpu_torch.startool`` (reference
star_tool/run.py:46-53).

The reference tool is a script whose star parameters are edited in
place; here the star is described either by CLI flags or by a JSON file
holding one star dict (or a list of them), with the same keys the
reference dicts use: data_format, name, temp, log_g, m, source_file,
w_conversion_factor, flux_conversion_factor, distance_from_Earth,
R_star.

Examples::

    python -m helios_tpu_torch.startool -data_format phoenix -name gj1214 \
        -temp 3026 -log_g 4.944 -m 0.39 \
        -opac_file H2O_opac_ip_kdistr.h5 -output_file star.h5
    python -m helios_tpu_torch.startool -star_file mystars.json \
        -opac_file mixed_opac_kdistr.h5 -output_file star.h5
"""

from __future__ import annotations

import argparse
import json


# star-dict keys settable from the command line (reference run.py:18-44)
_STAR_KEYS = ("data_format", "name", "source_file")
_STAR_FLOAT_KEYS = ("temp", "log_g", "m", "w_conversion_factor",
                    "flux_conversion_factor", "distance_from_Earth",
                    "R_star")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m helios_tpu_torch.startool")
    ap.add_argument("-star_file", default=None,
                    help="JSON file with a star dict (or list of dicts)")
    for k in _STAR_KEYS:
        ap.add_argument("-" + k, default=None)
    for k in _STAR_FLOAT_KEYS:
        ap.add_argument("-" + k, type=float, default=None)
    ap.add_argument("-skip_header", type=int, default=None,
                    help="ASCII format: header lines to skip (default 8)")
    ap.add_argument("-convert_to", default="r50_kdistr",
                    help="HDF5 group name for the rebinned spectrum")
    ap.add_argument("-opac_file", required=True,
                    help="opacity HDF5 providing the wavelength grid")
    ap.add_argument("-output_file", default="star.h5")
    ap.add_argument("-mode", choices=["automatic", "manual"],
                    default="automatic",
                    help="automatic = Newton-Raphson BB-extrapolation fit")
    ap.add_argument("-BB_temp", type=float, default=None,
                    help="manual blackbody extrapolation temperature")
    ap.add_argument("-phoenix_dir", default="./input/phoenix/")
    ap.add_argument("-download_phoenix", default="no",
                    help="yes: fetch missing PHOENIX grid FITS files "
                    "from the Goettingen server (reference wget path)")
    args = ap.parse_args(argv)

    if args.star_file:
        with open(args.star_file) as f:
            loaded = json.load(f)
        stars = loaded if isinstance(loaded, list) else [loaded]
    else:
        star = {}
        for k in _STAR_KEYS + _STAR_FLOAT_KEYS + ("skip_header",):
            v = getattr(args, k)
            if v is not None:
                star[k] = v
        if "data_format" not in star or "name" not in star:
            ap.error("either -star_file or -data_format plus -name "
                     "(and format-specific keys) is required")
        stars = [star]

    from helios_tpu_torch.startool import functions as st

    for star in stars:
        lam, flux = st.convert_star(
            star, convert_to=args.convert_to, opac_file=args.opac_file,
            output_file=args.output_file, mode=args.mode,
            BB_temp=args.BB_temp, phoenix_dir=args.phoenix_dir,
            download=args.download_phoenix.lower() in ("yes", "1",
                                                       "true"))
        print(f"{star['name']}: {len(lam)} bins -> {args.output_file} "
              f"(/{args.convert_to}/{star['data_format']}/{star['name']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Command-line entry point: ``python -m helios_tpu_torch [-parameter_file
param.dat] [-<flag> value ...]`` (port of :mod:`helios_tpu.__main__`).

The reference is run as ``python helios.py`` with param.dat and ~70
command-line overrides (helios.py:140-145); the flags are those of
:func:`helios_tpu_torch.config.config_from_cli`.  The run goes on the CUDA
card; without one the command exits non-zero with the message.
"""

from __future__ import annotations

import sys


def main(argv=None, *, device="cuda"):
    """Parse ``argv`` (default: the command line), run it with
    :func:`helios_tpu_torch.pipeline.run` and print the "Done!" line, the
    global energy imbalance and the output directory; with
    ``-planet_ensemble_file`` run its planets as one batch
    (:func:`helios_tpu_torch.parallel.ensemble.run_ensemble`) and print a
    line per planet.  ``device`` defaults
    to CUDA (``device="cpu"`` runs on the CPU).  Returns the exit code."""
    from helios_tpu_torch import host_physics as hp
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import config_from_cli
    from helios_tpu_torch.device import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    try:
        resolve_device(device)
    except RuntimeError as e:
        print(f"helios_tpu_torch: {e}", file=sys.stderr)
        return 1

    cfg_raw = config_from_cli(argv, finalize=False)
    if cfg_raw.planet_ensemble_file:
        # planet-ensemble mode: N planets as one batch, each kernel launch
        # shared by all of them
        from helios_tpu_torch.parallel import ensemble as ens

        rows = ens.parse_ensemble_file(cfg_raw.planet_ensemble_file)
        cfgs = ens.configs_from_ensemble(cfg_raw, rows)
        outs = ens.run_ensemble(cfgs, device=device)
        print(f"\nDone! Ensemble of {len(outs)} planets finished in "
              f"{outs[0].wall_seconds:.1f} s.")
        for o in outs:
            state = o.conv if o.conv is not None else o.rad
            print(f"  {o.result.name}: {int(state.it)} iterations -> "
                  f"{o.result.out}")
        return 0
    cfg = cfg_raw.finalize()

    out = pipeline.run(cfg, device=device)
    r = out.result
    state = out.conv if out.conv is not None else out.rad
    print(f"\nDone! Run '{cfg.name}' finished in {out.wall_seconds:.1f} s "
          f"({int(state.it)} iterations).")
    if not cfg.singlewalk:
        imbalance = hp.global_energy_balance(
            r.F_net, r.F_add_heat_sum, r.F_smooth_sum, r.F_intern,
            r.F_down_tot[r.nlayer])
        print(f"Global energy imbalance: {imbalance * 1e6:.3f} ppm")
    print(f"Output written to {r.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

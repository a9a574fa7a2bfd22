"""Time variants of the staged kernels of helios_tpu_torch
(``csrc/noniso_sweep.cu``, ``csrc/thomas.cu``, ``csrc/iso_sweep.cu``), and
another version of them or of ``csrc/ro_mix.cu`` beside the shipped one, on
one CUDA card.

    python3 scripts/torch_ring_tuning.py
        [--kernels noniso_sweep,thomas,iso_sweep,ro_mix,band_integrate]
        [--depths 8,12,16,24] [--steady 2,4,8]
        [--iso-variants 0:8:3:32,1:8:3:32,1:8:5:30] [--iso-columns 32,4224]
        [--ro-warps 1,4] [--ro-cells 8448,16896] [--ro-ny 87,100,126]
        [--bi-variants 4:24576,2:49152]
        [--rounds 5] [--reference-csrc DIR] [--out FILE]

A variant is the source with some of its ``constexpr int`` constants
replaced (both precisions' where the source sets one for each), built with
the port's nvcc flags into ``helios_tpu_torch/_build/tuning/`` and loaded
with ctypes.  The ring kernels vary their ring depth ``kRingDepth`` (the
steps whose loads are in flight) and the length ``kSteady`` of their
blocks of straight-line steps; the iso sweep varies ``kStreamSourceUp``
(s_up streamed through a ring, 1, or resident in shared memory, 0), its
``kSteady``, its ring's ``kRingBlocks`` and its widest block
``kMaxWidth``, given as stream:steady:ring_blocks:width.  Every variant
runs on the inputs of ``chip_smoke.py`` phase 3 (the non-iso sweep at 105
x 7700 and 4 passes, the Thomas solve at 212 and 422 rows x 7700, the iso
sweep at 105 x 7700 and 4, 31 and 1001 passes), fp64 and fp32, and is
compared bit for bit with the source as it is (the
"shipped" build), which is itself held against its plain PyTorch version
at chip_smoke's limits (the iso sweep at 4 and 31 passes).  Times are
CUDA-event medians of back-to-back launches taken in turns (every build
once per round), so all builds see the same card.  ``--iso-columns`` adds
the shipped iso sweep at 1001 passes on the first S columns only: a time
that does not fall with S is set by one column's chain, not by the SM's
throughput.  ``ro_mix`` varies its block width ``kBlockWarps`` (warps of
32 cells per block); it runs on chip_smoke's flagship cells (40425 x 20)
and on its ragged cells at ny = 32 (ties, gray, unsorted and infinite
entries), and is held bit for bit against its plain version.
``--ro-cells`` adds ``ro_mix`` on the first C flagship cells only: a time
that does not grow with C while the blocks fit on the SMs at once is set
by one cell's chain.  ``--ro-ny`` adds ``ro_mix`` in fp32 on 2000 + ny
of chip_smoke's cells at each of those ny (where the previous design's
launch-wide weight bound sent every live cell to its general branch).
``band_integrate`` (the flux integration,
``csrc/band_integrate.cu``) varies its staging, given as
stages:stage_bytes (a ring of ``kStages`` stages of ``kStageBytes``
each); it runs on
the flagship's fluxes [106, 7700] and path n's batch [106, 8, 7700] and
is held bit for bit against its in-order reference.

``--reference-csrc DIR`` adds the sources of the selected kernels from
another directory (another version of the kernels, with the same C
interface), built as they are: the script times them and reports whether
they agree with the shipped build bit for bit, and their largest
difference.

Prints one line per build and case, then the card's name and power limit,
then one JSON line.  Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import itertools
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (phase-3 inputs, timing, nvidia-smi)
from helios_tpu_torch.kernels import _build, _launch  # noqa: E402
from helios_tpu_torch.kernels.integrate import (  # noqa: E402
    band_integrate_reference)
from helios_tpu_torch.kernels.ro import ro_mix_reference  # noqa: E402
from helios_tpu_torch.kernels.sweep import (  # noqa: E402
    iso_sweep_reference, noniso_sweep_reference)
from helios_tpu_torch.kernels.thomas import thomas_solve_reference  # noqa: E402

TUNING_DIR = _build.BUILD_DIR / "tuning"
KERNELS = ("noniso_sweep", "thomas", "iso_sweep", "ro_mix", "band_integrate")
# pointers and ints of each entry point
ARITY = {"noniso_sweep": (18, 3), "thomas": (5, 2), "iso_sweep": (11, 3),
         "ro_mix": (5, 2), "band_integrate": (9, 6)}


def variant_source(name, **constants):
    """The source of ``csrc/<name>.cu`` with the named ``constexpr int``
    constants replaced, each with its per-precision variants
    (``kRingDepth64``, ``kRingDepth32``); each must be defined."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for const, value in constants.items():
        src, count = re.subn(rf"constexpr int {const}(64|32)? = \d+;",
                             rf"constexpr int {const}\g<1> = {value};", src)
        if count == 0:
            raise RuntimeError(f"{name}.cu does not define {const}")
    return src


def build(jobs):
    """Compile {label: (source text, headers directory, output directory)}
    with nvcc, all at once; the ``*.cuh`` headers are copied beside each
    source.  Returns {label: (library path, ptxas lines)}."""
    procs = {}
    for label, (text, headers, out_dir) in jobs.items():
        out_dir.mkdir(parents=True, exist_ok=True)
        for header in headers.glob("*.cuh"):
            (out_dir / header.name).write_bytes(header.read_bytes())
        src = out_dir / f"{label}.cu"
        src.write_text(text)
        lib = out_dir / f"{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        built[label] = (lib, [line.strip() for line in log.splitlines()
                              if "registers" in line or "spill" in line])
    return built


def entry(lib_path, name, dtype, n_tensors, n_ints):
    """The ``<name>_f64|f32`` entry point of a built library, as a function
    of (tensors, ints) that launches on the current stream."""
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, f"{name}_{_launch.SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * n_tensors + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.helios_cuda_error_string.restype = ctypes.c_char_p

    def call(tensors, ints):
        rc = fn(*(t.data_ptr() for t in tensors), *ints,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{lib_path.name}: "
                               + lib.helios_cuda_error_string(rc).decode())
    return call


def _outputs(args, shapes):
    return [torch.empty(shape, dtype=args[0].dtype, device="cuda")
            for shape in shapes]


def cases(kernels, iso_columns, ro_cells=(), ro_ny=()):
    """(label, kernel, dtype, run(call) -> outputs, plain() -> outputs or
    None, rtol, timing (reps, per_event), shipped build only) at
    chip_smoke's phase-3 shapes."""
    out = []
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        name = str(dtype).split(".")[-1]
        if "noniso_sweep" in kernels:
            args = chip_smoke.sweep_inputs(dtype)
            L, S = args[0].shape

            def sweep(call, args=args, L=L, S=S):
                outs = _outputs(args, [(L + 1, S)] * 2 + [(L, S)] * 2)
                call(list(args) + outs, (L, S, chip_smoke.PASSES))
                return outs

            out.append((f"noniso_sweep {name} [{L} x {S}, "
                        f"{chip_smoke.PASSES} passes]", "noniso_sweep", dtype,
                        sweep, lambda args=args: noniso_sweep_reference(
                            *args, n_passes=chip_smoke.PASSES), rtol, (5, 10),
                        False))
        if "thomas" in kernels:
            for n in sorted(chip_smoke.THOMAS_ROWS.values()):
                b, c, d = chip_smoke.thomas_inputs(dtype, n, seed=n)

                def thomas(call, b=b, c=c, d=d, n=n):
                    x, dp = torch.empty_like(b), torch.empty_like(b)
                    call([b, c, d, x, dp], (n, b.shape[1]))
                    return [x]

                out.append((f"thomas {name} [{n} x {b.shape[1]}]", "thomas",
                            dtype, thomas,
                            lambda b=b, c=c, d=d: [thomas_solve_reference(
                                b, c, d)], rtol, (5, 10), False))
        if "iso_sweep" in kernels:
            full = chip_smoke.iso_inputs(dtype)
            runs = [(full, n) for n in (chip_smoke.PASSES, 31,
                                        chip_smoke.PP_PASSES)]
            runs += [([t[..., :S].contiguous() for t in full],
                      chip_smoke.PP_PASSES) for S in iso_columns]
            for k, (args, n) in enumerate(runs):
                L, S = args[0].shape

                def iso(call, args=args, L=L, S=S, n=n):
                    outs = _outputs(args, [(L + 1, S)] * 2)
                    call(list(args) + outs, (L, S, n))
                    return outs

                plain = None
                if n < chip_smoke.PP_PASSES:
                    plain = lambda args=args, n=n: iso_sweep_reference(
                        *args, n_passes=n)
                out.append((f"iso_sweep {name} [{L} x {S}, {n} passes]",
                            "iso_sweep", dtype, iso, plain, rtol,
                            (3, 2) if n == chip_smoke.PP_PASSES else (5, 10),
                            k >= 3))
        if "ro_mix" in kernels:
            full = chip_smoke.ro_inputs(dtype)
            runs = [("flagship", full),
                    ("ragged ny=32",
                     chip_smoke.ro_ragged_inputs(dtype, 32, 1032, 32))]
            runs += [(f"first {C} cells", [full[0][:C].contiguous(),
                                          full[1][:C].contiguous()]
                      + full[2:]) for C in ro_cells]
            if dtype == torch.float32:
                runs += [(f"ny={ny}", chip_smoke.ro_inputs(
                    dtype, C=2000 + ny, ny=ny)) for ny in ro_ny]
            for label, args in runs:
                C, ny = args[0].shape

                def ro(call, args=args, C=C, ny=ny):
                    out = torch.empty_like(args[0])
                    call(list(args) + [out], (C, ny))
                    return [out]

                # bit for bit with the plain version: rtol 0; one call per
                # sample at the wide ny, where a general branch takes seconds
                out.append((f"ro_mix {name} {label} [{C} x {ny}]", "ro_mix",
                            dtype, ro,
                            lambda args=args: [ro_mix_reference(*args)], 0.0,
                            (1, 1) if ny in ro_ny else (5, 10), False))
        if "band_integrate" in kernels:
            out += band_integrate_cases(dtype, name)
    return out


def band_integrate_cases(dtype, name):
    """The flux integration at the flagship [106, 7700] and at path n's
    batch [106, 8, 7700] with a shared delta_lambda, held bit for bit to
    its in-order reference (rtol 0)."""
    L, B, Y, P = (chip_smoke.L_FLAG, chip_smoke.NBIN_FLAG, chip_smoke.NY_FLAG,
                  chip_smoke.ENSEMBLE_P)
    rng = np.random.default_rng(20)
    mk = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s), dtype=dtype,
                                         device="cuda")
    w, dl = mk(0.01, 0.1, Y), mk(1e-7, 1e-5, B)
    out = []
    for label, lead, d, P_dl in (("flagship", (L + 1,), dl, 1),
                                 ("batch", (L + 1, P), dl.expand(P, B), P)):
        f = [mk(0.0, 1e6, *lead, B * Y) for _ in range(3)]
        R = f[0].numel() // (B * Y)

        def run(call, f=f, d=d, lead=lead, R=R, P_dl=P_dl):
            bands = torch.empty((3,) + lead + (B,), dtype=dtype,
                                device="cuda")
            tots = torch.empty((3,) + lead, dtype=dtype, device="cuda")
            call(f + [w, d, tots, tots, bands, tots],
                 (R, B, Y, P_dl, d.stride(0) if d.dim() > 1 else 0, 0))
            return [bands, tots]

        def plain(f=f, d=d):
            res = band_integrate_reference(*f, w, d, in_order=True)
            return [torch.stack(res[:3]), torch.stack(res[3:])]

        out.append((f"band_integrate {name} {label} [{R} x {B * Y}]",
                    "band_integrate", dtype, run, plain, 0.0, (10, 20),
                    False))
    return out


def max_abs_diff(got, want):
    """The largest difference where both values are finite."""
    return max(chip_smoke.row_mismatches(g, w)[1] for g, w in zip(got, want))


def variants(name, opt):
    """{label suffix: constants} of one kernel's variant grid."""
    if name == "ro_mix":
        names = ("kBlockWarps",)
        combos = [(w,) for w in opt.ro_warps]
    elif name == "band_integrate":
        names = ("kStages", "kStageBytes")
        combos = [ints(v.replace(":", ",")) for v in opt.bi_variants]
    elif name == "iso_sweep":
        names = ("kStreamSourceUp", "kSteady", "kRingBlocks", "kMaxWidth")
        combos = [ints(v.replace(":", ",")) for v in opt.iso_variants]
    else:
        names = ("kRingDepth", "kSteady")
        combos = itertools.product(opt.depths, opt.steady)
    out = {}
    for values in combos:
        consts = dict(zip(names, values))
        out["_".join(f"{k}{v}" for k, v in consts.items())] = consts
    return out


def ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--depths", type=ints, default="8,12,16,24")
    ap.add_argument("--steady", type=ints, default="2,4,8")
    ap.add_argument("--iso-variants", type=lambda t: t.split(","),
                    default="0:8:3:32,1:8:3:32,1:8:5:30")
    ap.add_argument("--iso-columns", type=ints, default="")
    ap.add_argument("--ro-warps", type=ints, default="")
    ap.add_argument("--ro-cells", type=ints, default="")
    ap.add_argument("--ro-ny", type=ints, default="")
    ap.add_argument("--bi-variants", type=lambda t: t.split(","),
                    default="4:24576,2:49152,3:32768")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reference-csrc", type=Path)
    ap.add_argument("--out", type=Path)
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ring_tuning: CUDA is not available", file=sys.stderr)
        return 1
    kernels = opt.kernels.split(",")
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")

    jobs, constants = {}, {}
    for name in kernels:
        jobs[name] = ((_build.CSRC / f"{name}.cu").read_text(), _build.CSRC,
                      TUNING_DIR / "shipped")
        for suffix, consts in variants(name, opt).items():
            label = f"{name}_{suffix}"
            jobs[label] = (variant_source(name, **consts), _build.CSRC,
                           TUNING_DIR / "variants")
            constants[label] = consts
        if opt.reference_csrc is not None:
            jobs[f"{name}_reference"] = (
                (opt.reference_csrc / f"{name}.cu").read_text(),
                opt.reference_csrc, TUNING_DIR / "reference")
    built = build(jobs)
    for label, (_, ptxas) in built.items():
        for line in ptxas:
            print(f"ptxas {label}: {line}")
    occupancy = {}
    for label, (lib, _) in built.items():
        query = getattr(ctypes.CDLL(str(lib)), "ro_mix_occupancy", None)
        for bits in (64, 32) if query is not None else ():
            shape = (ctypes.c_int * 3)()
            if query(bits, chip_smoke.NY_FLAG, shape) == 0:
                occupancy[f"{label} fp{bits}"] = list(shape)
                print(f"{label} fp{bits} at ny = {chip_smoke.NY_FLAG}: "
                      f"blocks of {shape[0]}, {shape[1]} B of shared "
                      f"memory, {shape[2]} blocks per SM")

    results = []
    for (label, kernel, dtype, run, plain, rtol, (reps, per_event),
         shipped_only) in cases(kernels, opt.iso_columns, opt.ro_cells,
                                opt.ro_ny):
        builds = {lab: entry(lib, kernel, dtype, *ARITY[kernel])
                  for lab, (lib, _) in built.items()
                  if lab == kernel or (not shipped_only
                                       and lab.startswith(kernel + "_"))}
        shipped = run(builds[kernel])
        torch.cuda.synchronize()
        rel = None
        if plain is not None and kernel == "ro_mix":
            bad, diff = chip_smoke.row_mismatches(shipped[0], plain()[0])
            chip_smoke.check(bad == 0, f"{label}: shipped build differs from "
                             f"its plain version in {bad} cells (max abs "
                             f"{diff:.3e})")
            rel = 0.0
        elif plain is not None and rtol == 0.0:
            chip_smoke.check(all(torch.equal(g, w) for g, w in zip(
                shipped, plain())), f"{label}: shipped build not bit for "
                "bit its plain version")
            rel = 0.0
        elif plain is not None:
            want = plain()
            rel = max(float(((g - w).abs() / w.abs()).max())
                      for g, w in zip(shipped, want))
            chip_smoke.check(rel <= rtol, f"{label}: shipped build "
                             f"{rel:.3e} from its plain version > {rtol:.0e}")
        times = {lab: [] for lab in builds}
        for _ in range(opt.rounds):
            for lab, call in builds.items():
                times[lab].append(chip_smoke.cuda_ms(
                    lambda call=call: run(call), reps=reps, warmup=2,
                    per_event=per_event))
        for lab, call in builds.items():
            got = run(call)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(g, s) or (
                kernel == "ro_mix" and chip_smoke.row_mismatches(g, s)[0] == 0)
                for g, s in zip(got, shipped))
            r = dict(case=label, build=lab, constants=constants.get(lab),
                     ms=statistics.median(times[lab]),
                     ms_rounds=times[lab], bitwise_vs_shipped=bitwise,
                     max_abs_diff_vs_shipped=max_abs_diff(got, shipped))
            if lab == kernel and rel is not None:
                r["max_rel_err_vs_plain"] = rel
            results.append(r)
            print(f"{label} {lab}: {r['ms']:.4f} ms (rounds "
                  f"{min(times[lab]):.4f}..{max(times[lab]):.4f}); bit for "
                  f"bit with the shipped build: {bitwise} (max abs diff "
                  f"{r['max_abs_diff_vs_shipped']:.3e})", flush=True)
    card = chip_smoke.nvidia_smi_line()
    print(card)
    line = json.dumps({"card": card, "results": results,
                       "occupancy": occupancy,
                       "ptxas": {k: v for k, (_, v) in built.items()}})
    if opt.out is not None:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

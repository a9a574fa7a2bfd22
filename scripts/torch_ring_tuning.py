"""Time the ring kernels of helios_tpu_torch (``csrc/noniso_sweep.cu``,
``csrc/thomas.cu``) at other ring depths and steady block lengths, on one
CUDA card.

    python3 scripts/torch_ring_tuning.py [--depths 8,12,16,24]
        [--steady 2,4,8] [--rounds 5] [--reference-csrc DIR] [--out FILE]

A variant is the source with its ring depth ``kRingDepth`` (the steps whose
loads are in flight; both precisions' where the source sets one for each)
and the length ``kSteady`` of its blocks of straight-line steps replaced,
built with the port's nvcc flags into
``helios_tpu_torch/_build/tuning/`` and loaded with ctypes.  Every variant
runs on the inputs of ``chip_smoke.py`` phase 3 (the non-iso sweep at 105 x
7700 and 4 passes, the Thomas solve at 212 and 422 rows x 7700), fp64 and
fp32, and is compared bit for bit with the source as it is (the "shipped"
build), which is itself held against its plain PyTorch version at
chip_smoke's limits.  Times are CUDA-event medians of back-to-back launches
taken in turns (every build once per round), so all builds see the same
card.

``--reference-csrc DIR`` adds the ``noniso_sweep.cu`` and ``thomas.cu`` of
another directory (another version of the kernels, with the same C
interface), built as they are: the script times them and reports whether
they agree with the shipped build bit for bit, and their largest
difference.

Prints one line per build and case, then the card's name and power limit,
then one JSON line.  Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (phase-3 inputs, timing, nvidia-smi)
from helios_tpu_torch.kernels import _build, _launch  # noqa: E402
from helios_tpu_torch.kernels.sweep import noniso_sweep_reference  # noqa: E402
from helios_tpu_torch.kernels.thomas import thomas_solve_reference  # noqa: E402

TUNING_DIR = _build.BUILD_DIR / "tuning"
KERNELS = ("noniso_sweep", "thomas")


def variant_source(name, **constants):
    """The source of ``csrc/<name>.cu`` with the named ``constexpr int``
    constants replaced, each with its per-precision variants
    (``kRingDepth64``, ``kRingDepth32``); each must be defined."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for const, value in constants.items():
        src, count = re.subn(rf"constexpr int {const}(64|32)? = \d+;",
                             rf"constexpr int {const}\1 = {value};", src)
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


def cases():
    """(label, kernel, dtype, inputs, run(call) -> outputs, plain() ->
    outputs, rtol) at chip_smoke's phase-3 shapes."""
    out = []
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        name = str(dtype).split(".")[-1]
        args = chip_smoke.sweep_inputs(dtype)
        L, S = args[0].shape

        def sweep(call, args=args, L=L, S=S):
            outs = [torch.empty(shape, dtype=args[0].dtype, device="cuda")
                    for shape in [(L + 1, S)] * 2 + [(L, S)] * 2]
            call(list(args) + outs, (L, S, chip_smoke.PASSES))
            return outs

        out.append((f"noniso_sweep {name} [{L} x {S}, {chip_smoke.PASSES} "
                    "passes]", "noniso_sweep", dtype, sweep,
                    lambda args=args: noniso_sweep_reference(
                        *args, n_passes=chip_smoke.PASSES), rtol))
        for n in sorted(chip_smoke.THOMAS_ROWS.values()):
            b, c, d = chip_smoke.thomas_inputs(dtype, n, seed=n)

            def thomas(call, b=b, c=c, d=d, n=n):
                x, dp = torch.empty_like(b), torch.empty_like(b)
                call([b, c, d, x, dp], (n, b.shape[1]))
                return [x]

            out.append((f"thomas {name} [{n} x {b.shape[1]}]", "thomas",
                        dtype, thomas,
                        lambda b=b, c=c, d=d: [thomas_solve_reference(b, c,
                                                                      d)],
                        rtol))
    return out


def max_abs_diff(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="8,12,16,24")
    ap.add_argument("--steady", default="2,4,8")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reference-csrc", type=Path)
    ap.add_argument("--out", type=Path)
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ring_tuning: CUDA is not available", file=sys.stderr)
        return 1
    depths = [int(x) for x in opt.depths.split(",")]
    steadies = [int(x) for x in opt.steady.split(",")]

    jobs = {}
    for name in KERNELS:
        jobs[f"{name}"] = ((_build.CSRC / f"{name}.cu").read_text(),
                           _build.CSRC, TUNING_DIR / "shipped")
        for depth in depths:
            for steady in steadies:
                jobs[f"{name}_d{depth}_s{steady}"] = (
                    variant_source(name, kRingDepth=depth, kSteady=steady),
                    _build.CSRC, TUNING_DIR / "ring")
        if opt.reference_csrc is not None:
            jobs[f"{name}_reference"] = (
                (opt.reference_csrc / f"{name}.cu").read_text(),
                opt.reference_csrc, TUNING_DIR / "reference")
    built = build(jobs)
    for label, (_, ptxas) in built.items():
        for line in ptxas:
            print(f"ptxas {label}: {line}")

    results = []
    for label, kernel, dtype, run, plain, rtol in cases():
        n_tensors, n_ints = (18, 3) if kernel == "noniso_sweep" else (5, 2)
        builds = {lab: entry(lib, kernel, dtype, n_tensors, n_ints)
                  for lab, (lib, _) in built.items()
                  if lab == kernel or lab.startswith(kernel + "_")}
        shipped = run(builds[kernel])
        torch.cuda.synchronize()
        want = plain()
        rel = max(float(((g - w).abs() / w.abs()).max())
                  for g, w in zip(shipped, want))
        chip_smoke.check(rel <= rtol, f"{label}: shipped build {rel:.3e} "
                         f"from its plain version > {rtol:.0e}")
        times = {lab: [] for lab in builds}
        for _ in range(opt.rounds):
            for lab, call in builds.items():
                times[lab].append(chip_smoke.cuda_ms(
                    lambda call=call: run(call), reps=5, warmup=2,
                    per_event=10))
        for lab, call in builds.items():
            got = run(call)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(g, s) for g, s in zip(got, shipped))
            m = re.search(r"_d(\d+)_s(\d+)$", lab)
            r = dict(case=label, build=lab,
                     depth=int(m.group(1)) if m else None,
                     steady=int(m.group(2)) if m else None,
                     ms=statistics.median(times[lab]),
                     ms_rounds=times[lab], bitwise_vs_shipped=bitwise,
                     max_abs_diff_vs_shipped=max_abs_diff(got, shipped))
            if lab == kernel:
                r["max_rel_err_vs_plain"] = rel
            results.append(r)
            print(f"{label} {lab}: {r['ms']:.4f} ms (rounds "
                  f"{min(times[lab]):.4f}..{max(times[lab]):.4f}); bit for "
                  f"bit with the shipped build: {bitwise} (max abs diff "
                  f"{r['max_abs_diff_vs_shipped']:.3e})", flush=True)
    card = chip_smoke.nvidia_smi_line()
    print(card)
    line = json.dumps({"card": card, "results": results,
                       "ptxas": {k: v for k, (_, v) in built.items()}})
    if opt.out is not None:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

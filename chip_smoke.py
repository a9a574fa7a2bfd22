"""Drive the PyTorch/CUDA port (helios_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. environment: the card's name and power limit, torch/CUDA/nvcc/triton
     versions;
  2. build: every CUDA source of the port, compiled with nvcc, one process
     per source, all at once;
  3. kernels against their plain PyTorch versions at the flagship shape
     (105 layers x 7700 spectral columns), fp64 and fp32: the non-iso sweep
     at 4 passes, the iso sweep at 4 and 31 passes (and fp32 against fp64
     at 1001 passes); error, CUDA-event times (the iso sweep also at the
     post-processing run's 1001 passes), the card's copy bandwidth and
     each kernel's bound;
  4. the main paths, each with every launch count set to 0 just before it
     and read just after:
     a. the flagship RCE run (105 layers x 385 bins x 20 Gauss points,
        non-isothermal, scattering, convection, fp64) to convergence
        through helios_tpu_torch.pipeline.run; then one forward_fluxes on
        the card against the same call on the CPU, and where a radiation
        iteration's time goes (host wall against device busy time,
        torch.profiler);
     b. the post-processing run of the converged flagship profile, read
        back from a "PT" file, with the direct beam and the output files
        (one solve of 1001 sweep passes); its TOA spectrum against the
        same solve on the CPU;
     c. the isothermal iterative run of the JAX package's iso benchmark
        workload (T_intern 100 K, no convection, no beam), 200 radiation
        iterations, and its time breakdown;
  5. a JSON line of the kernels, the nvidia-smi line, and the result line.

Needs one CUDA card; exits non-zero without one.  Imports neither JAX nor
the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# NVIDIA's data sheet of the H100 SXM: HBM rate and non-tensor peak FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
DEVICE = "cuda"
L_FLAG, NBIN_FLAG, NY_FLAG, PASSES = 105, 385, 20, 4
PP_PASSES = 1001            # 1000*scat+1 passes of a post-processing solve
ISO_RCE_ITERATIONS = 200

# the files write_all writes for an isothermal run without clouds
POSTPROC_FILES = sorted(
    "_" + n + ".dat" for n in (
        "tp", "tp_cut", "colmass_mu_cp_kappa_entropy", "integrated_flux",
        "spec_upflux", "spec_downflux", "TOA_flux_eclipse", "flux_ratio",
        "direct_beamflux", "planck_cent", "opacities",
        "Rayleigh_cross_sect", "g_0", "transmission", "optdepth",
        "contribution", "transweight", "mean_extinct", "surf_albedo"))


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg=""):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# phase 1-2
# --------------------------------------------------------------------------- #

def environment():
    log(f"card: {nvidia_smi_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    from helios_tpu_torch.kernels import _build
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    log(f"nvcc: {ver.strip().splitlines()[-1]}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not importable")


def build():
    from helios_tpu_torch.kernels import _build
    t = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} source(s) compiled in "
        f"{time.perf_counter() - t:.2f} s ({', '.join(logs) or 'cached'})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #

def cuda_ms(fn, reps, warmup):
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def copy_bandwidth():
    """Device-to-device copy rate of a 2 GiB buffer [bytes/s], read +
    write counted."""
    n = 1 << 28
    src = torch.empty(n, dtype=torch.float64, device=DEVICE).fill_(1.0)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=10, warmup=2)
    del src, dst
    return 2 * n * 8 / (ms * 1e-3)


def kernel_counters():
    from helios_tpu_torch.kernels.sweep import iso_sweep, noniso_sweep
    return {"noniso_sweep": noniso_sweep, "iso_sweep": iso_sweep}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def sweep_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    L, S = L_FLAG, NBIN_FLAG * NY_FLAG
    mk = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s),
                                         dtype=dtype, device=DEVICE)
    return [mk(0.8, 1.0, L, S), mk(0.0, 0.02, L, S), mk(1e2, 1e4, L, S),
            mk(1e2, 1e4, L, S), mk(0.8, 1.0, L, S), mk(0.0, 0.02, L, S),
            mk(1e2, 1e4, L, S), mk(1e2, 1e4, L, S), mk(0.0, 1e3, S),
            mk(0.0, 0.4, S), mk(1e2, 1e4, S), mk(0.0, 1e3, S),
            mk(0.0, 1e3, L + 1, S), mk(0.0, 1e3, L, S)]


def max_errors(got, want):
    """(max relative, max absolute) difference over paired outputs."""
    rel = max(float(((g - w).abs() / w.abs()).max())
              for g, w in zip(got, want))
    return rel, max(float((g - w).abs().max()) for g, w in zip(got, want))


def sweep_case(dtype, rtol, bandwidth):
    from helios_tpu_torch.kernels.sweep import (noniso_sweep,
                                                noniso_sweep_reference)
    args = sweep_inputs(dtype)
    L, S = args[0].shape
    got = noniso_sweep(*args, n_passes=PASSES)
    torch.cuda.synchronize()
    max_rel, max_abs = max_errors(
        got, noniso_sweep_reference(*args, n_passes=PASSES))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "noniso_sweep: non-finite output")
    check(max_rel <= rtol, f"noniso_sweep {dtype}: max relative error "
          f"{max_rel:.3e} > {rtol:.0e}")
    ms = cuda_ms(lambda: noniso_sweep(*args, n_passes=PASSES), 30, 3)
    plain_ms = cuda_ms(lambda: noniso_sweep_reference(*args,
                                                      n_passes=PASSES), 20, 1)
    size = args[0].element_size()
    n_bytes = (14 * L + 7) * S * size     # inputs read once, outputs once
    flops = 16 * L * S * PASSES
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    res = dict(max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
               plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bound_ms_measured_bw=n_bytes / bandwidth * 1e3)
    log(f"noniso_sweep {str(dtype).split('.')[-1]} [{L} x {S}, {PASSES} "
        f"passes]: max rel err {max_rel:.3e} (limit {rtol:.0e}), max abs "
        f"err {max_abs:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; "
        f"bound {res['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} MB at "
        f"3.35 TB/s), {res['bound_ms_measured_bw']:.4f} ms at the measured "
        f"{bandwidth / 1e12:.3f} TB/s")
    return res


def iso_inputs(dtype, seed=1):
    """Random iso sweep inputs; the fp32 set is the fp64 set rounded."""
    rng = np.random.default_rng(seed)
    L, S = L_FLAG, NBIN_FLAG * NY_FLAG
    mk = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s),
                                         device=DEVICE).to(dtype)
    return [mk(0.8, 1.0, L, S), mk(0.0, 0.02, L, S), mk(1e2, 1e4, L, S),
            mk(1e2, 1e4, L, S), mk(0.0, 1e3, S), mk(0.0, 0.4, S),
            mk(1e2, 1e4, S), mk(0.0, 1e3, S), mk(0.0, 1e3, L + 1, S)]


def iso_bound_ms(dtype, L, S, n_passes, bandwidth=HBM_BYTES_PER_S):
    """(bound ms, what sets it): (7 L + 7) S values moved once, 8 flops per
    layer, column and pass."""
    size = torch.empty((), dtype=dtype).element_size()
    bytes_ms = (7 * L + 7) * S * size / bandwidth * 1e3
    ops_ms = 8 * L * S * n_passes / PEAK_FLOPS[dtype] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def iso_case(dtype, rtol, bandwidth):
    from helios_tpu_torch.kernels.sweep import iso_sweep, iso_sweep_reference
    args = iso_inputs(dtype)
    L, S = args[0].shape
    name = str(dtype).split(".")[-1]
    res = dict(max_rel_err=0.0, max_abs_err=0.0)
    for n in (PASSES, 31):
        got = iso_sweep(*args, n_passes=n)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"iso_sweep {name}: non-finite output")
        rel, ab = max_errors(got, iso_sweep_reference(*args, n_passes=n))
        check(rel <= rtol, f"iso_sweep {name} {n} passes: max relative "
              f"error {rel:.3e} > {rtol:.0e}")
        log(f"iso_sweep {name} [{L} x {S}, {n} passes] against its plain "
            f"version: max rel err {rel:.3e} (limit {rtol:.0e}), max abs "
            f"err {ab:.3e}")
        res["max_rel_err"] = max(res["max_rel_err"], rel)
        res["max_abs_err"] = max(res["max_abs_err"], ab)
    res["ms"] = cuda_ms(lambda: iso_sweep(*args, n_passes=PASSES), 30, 3)
    res["ms_1001"] = cuda_ms(
        lambda: iso_sweep(*args, n_passes=PP_PASSES), 5, 1)
    res["plain_ms"] = cuda_ms(
        lambda: iso_sweep_reference(*args, n_passes=PASSES), 10, 1)
    res["bound_ms"], res["bound_by"] = iso_bound_ms(dtype, L, S, PASSES)
    res["bound_ms_measured_bw"] = iso_bound_ms(dtype, L, S, PASSES,
                                               bandwidth)[0]
    res["bound_ms_1001"], res["bound_by_1001"] = iso_bound_ms(
        dtype, L, S, PP_PASSES)
    log(f"iso_sweep {name}: kernel {res['ms']:.4f} ms at {PASSES} passes "
        f"(bound {res['bound_ms']:.4f} ms by {res['bound_by']}, "
        f"{res['bound_ms_measured_bw']:.4f} ms at the measured "
        f"{bandwidth / 1e12:.3f} TB/s), {res['ms_1001']:.3f} ms at "
        f"{PP_PASSES} passes (bound {res['bound_ms_1001']:.4f} ms by "
        f"{res['bound_by_1001']}); plain {res['plain_ms']:.3f} ms at "
        f"{PASSES} passes")
    if dtype == torch.float32:
        # fp32 against fp64 on the same (fp32) inputs, at the pass count of
        # the post-processing solve
        got = iso_sweep(*args, n_passes=PP_PASSES)
        want = iso_sweep(*(a.double() for a in args), n_passes=PP_PASSES)
        rel, _ = max_errors([g.double() for g in got], want)
        check(rel <= 1e-4, f"iso_sweep fp32 at {PP_PASSES} passes: max "
              f"relative error against fp64 {rel:.3e} > 1e-4")
        res["max_rel_err_vs_fp64_1001"] = rel
        log(f"iso_sweep float32 at {PP_PASSES} passes against the float64 "
            f"kernel on the same inputs: max rel err {rel:.3e} (limit 1e-4)")
    return res


# --------------------------------------------------------------------------- #
# phase 4: the main paths
# --------------------------------------------------------------------------- #

FLAGSHIP = dict(planet="manual", g=2140.0, a=0.03142, R_planet=1.138,
                R_star=0.805, T_star=5040.0, T_intern=500.0,
                scattering="yes", direct_beam="no", convection="yes",
                kappa_value=0.25, run_type="iterative", iso_input="no",
                adapt_interval=6)


def flagship_table():
    from helios_tpu_torch.io.opacity import synthetic_premixed_table
    table = synthetic_premixed_table(nbin=NBIN_FLAG, ny=NY_FLAG)
    table.kpoints *= 10.0           # optically thick -> convective
    return table


def flagship(tmpdir):
    """The flagship workload: an irradiated hot Jupiter with a thick
    interior, started from a super-adiabatic deep profile so that the run
    goes through both the radiation and the convection loop."""
    from helios_tpu_torch import grid as grid_mod
    from helios_tpu_torch.config import HeliosConfig

    table = flagship_table()
    kw = FLAGSHIP
    cfg = HeliosConfig(**kw).finalize()
    p = grid_mod.build_grid(cfg.p_boa, cfg.p_toa, cfg.nlayer, cfg.g).p_lay
    T0 = np.clip(4300.0 * (p / p[0]) ** 0.30, 900.0, None)
    path = os.path.join(tmpdir, "flagship_start_tp.dat")
    with open(path, "w") as f:
        f.write("flagship start profile\nlayer T[K]\n")
        f.write(f"BOA {float(T0[0])!r}\n")
        for i, t in enumerate(T0):
            f.write(f"{i} {float(t)!r}\n")
    cfg = HeliosConfig(**kw, force_start_tp_from_file="yes",
                       temp_format="helios", temp_path=path).finalize()
    check(cfg.nlayer == L_FLAG, f"flagship has {cfg.nlayer} layers")
    return cfg, table


def main_path(launch_counts):
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.forward import ModelArrays, forward_fluxes

    with tempfile.TemporaryDirectory() as tmpdir:
        cfg, table = flagship(tmpdir)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = pipeline.run(cfg, table, device=DEVICE)
        launch_counts.update(read_counts())
        T_start = pipeline.initial_temperatures(cfg, out.phys, out.arrays)

    rad, conv = out.rad, out.conv
    T = out.T_lay.cpu().numpy()
    check(np.all(np.isfinite(T)), "main path: non-finite temperatures")
    check(conv is not None and conv.steps > 0,
          "main path: the convection loop did not run")
    converged = (not bool(rad.keep_running) and not conv.keep_running
                 and not rad.aborted and not conv.aborted)
    check(converged, "main path: the run did not converge")
    check(launch_counts["noniso_sweep"] == out.n_flux_solves > 0
          and launch_counts["iso_sweep"] == 0,
          f"main path: launches {launch_counts} for {out.n_flux_solves} "
          "flux solves")
    log(f"main path: flagship RCE run [{L_FLAG} layers x {NBIN_FLAG} bins x "
        f"{NY_FLAG} y, fp64] converged: {rad.it} radiation + {conv.it} "
        f"convection iterations ({conv.steps} convection steps), "
        f"{out.n_flux_solves} flux solves = {launch_counts['noniso_sweep']} "
        f"noniso_sweep launches")
    log(f"main path: wall {out.wall_seconds:.3f} s (radiation loop "
        f"{out.rad_seconds:.3f} s = {rad.it / out.rad_seconds:.1f} it/s, "
        f"convection loop {out.conv_seconds:.3f} s = "
        f"{conv.steps / out.conv_seconds:.1f} it/s); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; T "
        f"{T.min():.1f}..{T.max():.1f} K")

    # one forward solve on the card against the same call on the CPU
    arrays_cpu = ModelArrays(*(t.cpu() for t in out.arrays))
    gpu = forward_fluxes(out.phys, out.arrays, out.T_lay)[1]
    cpu = forward_fluxes(out.phys, arrays_cpu, out.T_lay.cpu())[1]
    rel = max(float(((getattr(gpu, f).cpu() - getattr(cpu, f)).abs()
                     / getattr(cpu, f).abs()).max())
              for f in ("F_up_tot", "F_down_tot"))
    check(rel <= 1e-10, f"forward_fluxes cuda vs cpu: {rel:.3e} > 1e-10")
    log(f"forward_fluxes at the flagship shape, cuda vs cpu: max rel "
        f"difference of the totals {rel:.3e} (limit 1e-10)")
    return out, T_start


def time_breakdown(label, phys, arrays, T0, kernel, n=20):
    """Where a radiation iteration's time goes: host wall per iteration
    (unprofiled) against the device's busy time per iteration and the
    sweep kernel's share of it (torch.profiler, CUDA kernels), over
    iterations 10..10+n of a loop started from T0."""
    from torch.profiler import ProfilerActivity, profile
    from helios_tpu_torch.rce import radiative

    s = radiative.init_rad_state(phys, arrays, T0)
    s = radiative.radiation_loop(phys, arrays, None, T0, max_steps=10,
                                 state0=s)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s1 = radiative.radiation_loop(phys, arrays, None, T0, max_steps=n,
                                  state0=s)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n
    check(s1.it == s.it + n, "time breakdown: the radiation loop stopped")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        radiative.radiation_loop(phys, arrays, None, T0, max_steps=n,
                                 state0=s)
        torch.cuda.synchronize()
    device_us, sweep_us, kernels = 0.0, 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        device_us += us
        kernels += e.count
        if f"{kernel}_kernel" in e.key:
            sweep_us += us
    check(sweep_us > 0, f"time breakdown: the profiler saw no {kernel}")
    busy_ms = device_us / 1e3 / n
    log(f"time breakdown, {label} radiation iteration (it {s.it}.."
        f"{s.it + n}): wall {wall_ms:.3f} ms; device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%) in {kernels / n:.0f} "
        f"kernels; {kernel} {sweep_us / 1e3 / n:.3f} ms "
        f"({100 * sweep_us / device_us:.1f}% of device time)")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=kernels / n)


def write_pt_file(path, p_lay, p_int, T):
    """T [L+1] as a "PT" file (pressure in 10^-6 bar, temperature): the
    layers at p_lay and the surface at p_int[0], so that the log-P
    interpolation of load_tp_file gives T back exactly."""
    L = len(p_lay)
    rows = np.column_stack([np.append(p_lay, p_int[0]), T])
    assert rows.shape == (L + 1, 2)
    np.savetxt(path, rows, fmt="%.17g")


def postprocessing_path(flag_out, launch_counts, kernel_ms_1001):
    """The post-processing run of the converged flagship profile, with the
    direct beam and the output files: one iso solve of 1001 passes."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import HeliosConfig
    from helios_tpu_torch.forward import ModelArrays, forward_fluxes

    T_final = flag_out.T_lay.cpu().numpy()
    table = flagship_table()
    with tempfile.TemporaryDirectory() as tmpdir:
        path = os.path.join(tmpdir, "flagship_final_pt.dat")
        write_pt_file(path, flag_out.arrays.p_lay.cpu().numpy(),
                      flag_out.arrays.p_int.cpu().numpy(), T_final)
        kw = dict(FLAGSHIP, run_type="post-processing", iso_input="yes",
                  direct_beam="yes", temp_format="PT", temp_path=path,
                  name="pp", output_dir=tmpdir + "/")
        cfg = HeliosConfig(**kw).finalize()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = pipeline.run(cfg, table, write_output=True, device=DEVICE)
        launch_counts.update(read_counts())
        files = sorted(f[len("pp"):] for f in
                       os.listdir(os.path.join(tmpdir, "pp")))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    phys, L = out.phys, out.phys.nlayer
    check(phys.singlewalk == 1 and phys.iso == 1
          and phys.n_sweep_passes == PP_PASSES,
          f"post-processing: singlewalk {phys.singlewalk}, iso {phys.iso}, "
          f"{phys.n_sweep_passes} passes")
    check(launch_counts == {"noniso_sweep": 0, "iso_sweep": 1},
          f"post-processing: launches {launch_counts}, expected one "
          "iso_sweep")
    check(files == POSTPROC_FILES, f"post-processing: files {files}")
    check(np.array_equal(out.T_lay.cpu().numpy(), T_final),
          "post-processing: the PT file did not give the profile back")
    toa = out.totals.F_up_band[L]
    check(bool(torch.isfinite(toa).all()) and bool((toa > 0).all()),
          "post-processing: TOA spectrum not finite and positive")

    arrays_cpu = ModelArrays(*(t.cpu() for t in out.arrays))
    t = time.perf_counter()
    cpu = forward_fluxes(phys, arrays_cpu, out.T_lay.cpu())[1]
    cpu_s = time.perf_counter() - t
    rel = float(((toa.cpu() - cpu.F_up_band[L]).abs()
                 / cpu.F_up_band[L].abs()).max())
    check(rel <= 1e-10, f"post-processing TOA spectrum cuda vs cpu: "
          f"{rel:.3e} > 1e-10")
    log(f"post-processing path [{L} layers x {NBIN_FLAG} bins x {NY_FLAG} "
        f"y, fp64, beam, {PP_PASSES} passes]: wall {out.wall_seconds:.3f} s "
        f"with {len(files)} output files; {launch_counts['iso_sweep']} "
        f"iso_sweep launch ({kernel_ms_1001:.3f} ms at this shape in phase "
        f"3 = {100 * kernel_ms_1001 / 1e3 / out.wall_seconds:.1f}% of the "
        f"wall); peak device memory {peak_mib:.0f} MiB; TOA spectrum "
        f"{float(toa.min()):.4e}..{float(toa.max()):.4e}, cuda vs cpu max "
        f"rel difference {rel:.3e} (limit 1e-10); the cpu solve took "
        f"{cpu_s:.2f} s")
    return dict(wall_s=out.wall_seconds, peak_mib=peak_mib,
                kernel_share=kernel_ms_1001 / 1e3 / out.wall_seconds,
                toa_rel_cpu=rel, cpu_s=cpu_s)


def iso_rce_path(launch_counts):
    """The isothermal iterative run of the JAX package's iso benchmark
    workload (bench.py:173-186; start profile of __graft_entry__.py):
    ISO_RCE_ITERATIONS radiation iterations, one iso_sweep each."""
    from helios_tpu_torch.config import HeliosConfig
    from helios_tpu_torch.forward import build_model
    from helios_tpu_torch.io.opacity import synthetic_premixed_table
    from helios_tpu_torch.rce import radiative

    table = synthetic_premixed_table(nbin=NBIN_FLAG, ny=NY_FLAG)
    cfg = HeliosConfig(
        planet="manual", g=2140.0, a=0.03142, R_planet=1.138,
        R_star=0.805, T_star=5040.0, T_intern=100.0, scattering="yes",
        direct_beam="no", convection="no", run_type="iterative",
        iso_input="yes").finalize()
    phys, arrays = build_model(cfg, table, device=DEVICE)
    check(phys.iso == 1 and phys.nlayer == L_FLAG,
          "iso RCE: not the isothermal flagship shape")
    T0 = torch.as_tensor(np.linspace(1800.0, 600.0, phys.nlayer + 1),
                         dtype=torch.float64, device=DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    rad = radiative.radiation_loop(phys, arrays, None, T0,
                                   max_steps=ISO_RCE_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launch_counts.update(read_counts())
    check(bool(torch.isfinite(rad.T_lay).all()),
          "iso RCE: non-finite temperatures")
    check(rad.it == ISO_RCE_ITERATIONS or not bool(rad.keep_running),
          f"iso RCE: stopped at {rad.it} iterations")
    check(launch_counts == {"noniso_sweep": 0, "iso_sweep": rad.it},
          f"iso RCE: launches {launch_counts} for {rad.it} iterations")
    log(f"iso RCE path [{L_FLAG} layers x {NBIN_FLAG} bins x {NY_FLAG} y, "
        f"fp64, {phys.n_sweep_passes} passes]: {rad.it} radiation "
        f"iterations = {launch_counts['iso_sweep']} iso_sweep launches in "
        f"{wall:.3f} s ({rad.it / wall:.1f} it/s, model build excluded); "
        f"T {float(rad.T_lay.min()):.1f}..{float(rad.T_lay.max()):.1f} K")
    res = time_breakdown("iso RCE", phys, arrays, T0, "iso_sweep")
    res.update(it=rad.it, it_per_s=rad.it / wall)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    environment()
    build()

    bandwidth = copy_bandwidth()
    log(f"device-to-device copy: {bandwidth / 1e12:.3f} TB/s")
    f64 = sweep_case(torch.float64, 1e-12, bandwidth)
    f32 = sweep_case(torch.float32, 1e-4, bandwidth)

    i64 = iso_case(torch.float64, 1e-12, bandwidth)
    i32 = iso_case(torch.float32, 1e-4, bandwidth)

    counts = {"flagship_rce": {}, "post_processing": {}, "iso_rce": {}}
    out, T_start = main_path(counts["flagship_rce"])
    time_breakdown("flagship", out.phys, out.arrays,
                   torch.as_tensor(T_start, dtype=out.T_lay.dtype,
                                   device=DEVICE), "noniso_sweep")
    postprocessing_path(out, counts["post_processing"], i64["ms_1001"])
    iso_rce_path(counts["iso_rce"])
    for path, c in counts.items():
        log(f"launches on the {path} path: {c}")

    by_path = lambda name: {path: c[name] for path, c in counts.items()}
    noniso = dict(
        name="noniso_sweep", route="cuda",
        source="helios_tpu_torch/csrc/noniso_sweep.cu",
        replaces="helios_tpu/kernels/sweep_pallas.py:234",
        launches=counts["flagship_rce"]["noniso_sweep"],
        max_abs_err=f64["max_abs_err"], ms=f64["ms"],
        plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"],
        bound_by=f64["bound_by"], library_ms=None,
        launches_by_path=by_path("noniso_sweep"), passes=PASSES,
        max_rel_err=f64["max_rel_err"],
        bound_ms_measured_bw=f64["bound_ms_measured_bw"],
        also_replaces="helios_tpu/kernels/sweep_pallas.py:162",
        fp32={k: f32[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "bound_ms_measured_bw")})
    iso = dict(
        name="iso_sweep", route="cuda",
        source="helios_tpu_torch/csrc/iso_sweep.cu",
        replaces="helios_tpu/kernels/sweep_pallas.py:75",
        launches=counts["post_processing"]["iso_sweep"],
        max_abs_err=i64["max_abs_err"], ms=i64["ms"],
        plain_ms=i64["plain_ms"], bound_ms=i64["bound_ms"],
        bound_by=i64["bound_by"], library_ms=None,
        launches_by_path=by_path("iso_sweep"), passes=PASSES,
        max_rel_err=i64["max_rel_err"],
        bound_ms_measured_bw=i64["bound_ms_measured_bw"],
        ms_1001=i64["ms_1001"], bound_ms_1001=i64["bound_ms_1001"],
        bound_by_1001=i64["bound_by_1001"],
        also_replaces="helios_tpu/kernels/sweep_pallas.py:27",
        fp32={k: i32[k] for k in (
            "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_ms_measured_bw", "ms_1001", "bound_ms_1001",
            "bound_by_1001", "max_rel_err_vs_fp64_1001")})
    kernels = [noniso, iso]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

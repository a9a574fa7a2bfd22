"""Drive the PyTorch/CUDA port (helios_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. environment: the card's name and power limit, torch/CUDA/nvcc/triton
     versions;
  2. build: every CUDA source of the port, compiled with nvcc;
  3. kernels against their plain PyTorch versions at the flagship shape
     (105 layers x 7700 spectral columns, 4 sweep passes), fp64 and fp32:
     error, CUDA-event times, the card's copy bandwidth and each kernel's
     bound;
  4. the main path: the flagship RCE run (105 layers x 385 bins x 20 Gauss
     points, non-isothermal, scattering, convection, fp64) to convergence
     through helios_tpu_torch.pipeline.run, with every kernel launch
     counted; then one forward_fluxes on the card against the same call
     on the CPU, and where a radiation iteration's time goes (host wall
     against device busy time, torch.profiler);
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
L_FLAG, NBIN_FLAG, NY_FLAG, PASSES = 105, 385, 20, 4


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
    src = torch.empty(n, dtype=torch.float64, device="cuda").fill_(1.0)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=10, warmup=2)
    del src, dst
    return 2 * n * 8 / (ms * 1e-3)


def sweep_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    L, S = L_FLAG, NBIN_FLAG * NY_FLAG
    mk = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s),
                                         dtype=dtype, device="cuda")
    return [mk(0.8, 1.0, L, S), mk(0.0, 0.02, L, S), mk(1e2, 1e4, L, S),
            mk(1e2, 1e4, L, S), mk(0.8, 1.0, L, S), mk(0.0, 0.02, L, S),
            mk(1e2, 1e4, L, S), mk(1e2, 1e4, L, S), mk(0.0, 1e3, S),
            mk(0.0, 0.4, S), mk(1e2, 1e4, S), mk(0.0, 1e3, S),
            mk(0.0, 1e3, L + 1, S), mk(0.0, 1e3, L, S)]


def sweep_case(dtype, rtol, bandwidth):
    from helios_tpu_torch.kernels.sweep import (noniso_sweep,
                                                noniso_sweep_reference)
    args = sweep_inputs(dtype)
    L, S = args[0].shape
    got = noniso_sweep(*args, n_passes=PASSES)
    torch.cuda.synchronize()
    want = noniso_sweep_reference(*args, n_passes=PASSES)
    max_rel = max(float(((g - w).abs() / w.abs()).max())
                  for g, w in zip(got, want))
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
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


# --------------------------------------------------------------------------- #
# phase 4: the main path
# --------------------------------------------------------------------------- #

def flagship(tmpdir):
    """The flagship workload: an irradiated hot Jupiter with a thick
    interior, started from a super-adiabatic deep profile so that the run
    goes through both the radiation and the convection loop."""
    from helios_tpu_torch import grid as grid_mod
    from helios_tpu_torch.config import HeliosConfig
    from helios_tpu_torch.io.opacity import synthetic_premixed_table

    table = synthetic_premixed_table(nbin=NBIN_FLAG, ny=NY_FLAG)
    table.kpoints *= 10.0           # optically thick -> convective
    kw = dict(planet="manual", g=2140.0, a=0.03142, R_planet=1.138,
              R_star=0.805, T_star=5040.0, T_intern=500.0,
              scattering="yes", direct_beam="no", convection="yes",
              kappa_value=0.25, run_type="iterative", iso_input="no",
              adapt_interval=6)
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
    from helios_tpu_torch.kernels.sweep import noniso_sweep

    with tempfile.TemporaryDirectory() as tmpdir:
        cfg, table = flagship(tmpdir)
        torch.cuda.reset_peak_memory_stats()
        noniso_sweep.launches = 0
        out = pipeline.run(cfg, table, device="cuda")
        launch_counts["noniso_sweep"] = noniso_sweep.launches
        T_start = pipeline.initial_temperatures(cfg, out.phys)

    rad, conv = out.rad, out.conv
    T = out.T_lay.cpu().numpy()
    check(np.all(np.isfinite(T)), "main path: non-finite temperatures")
    check(conv is not None and conv.steps > 0,
          "main path: the convection loop did not run")
    converged = (not bool(rad.keep_running) and not conv.keep_running
                 and not rad.aborted and not conv.aborted)
    check(converged, "main path: the run did not converge")
    check(launch_counts["noniso_sweep"] == out.n_flux_solves > 0,
          f"main path: {launch_counts['noniso_sweep']} sweep launches for "
          f"{out.n_flux_solves} flux solves")
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


def time_breakdown(out, T_start, n=20):
    """Where a flagship radiation iteration's time goes: host wall per
    iteration (unprofiled) against the device's busy time per iteration
    and the sweep kernel's share of it (torch.profiler, CUDA kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from helios_tpu_torch.rce import radiative

    phys, arrays = out.phys, out.arrays
    T0 = torch.as_tensor(T_start, dtype=out.T_lay.dtype, device="cuda")
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
        if "noniso_sweep_kernel" in e.key:
            sweep_us += us
    check(sweep_us > 0, "time breakdown: the profiler saw no sweep kernel")
    busy_ms = device_us / 1e3 / n
    log(f"time breakdown, flagship radiation iteration (it {s.it}..{s.it + n}"
        f"): wall {wall_ms:.3f} ms; device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%) in {kernels / n:.0f} "
        f"kernels; noniso_sweep {sweep_us / 1e3 / n:.3f} ms "
        f"({100 * sweep_us / device_us:.1f}% of device time)")


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

    launch_counts = {}
    out, T_start = main_path(launch_counts)
    time_breakdown(out, T_start)

    kernels = [dict(
        name="noniso_sweep", route="cuda",
        source="helios_tpu_torch/csrc/noniso_sweep.cu",
        replaces="helios_tpu/kernels/sweep_pallas.py:234",
        launches=launch_counts["noniso_sweep"],
        max_abs_err=f64["max_abs_err"], ms=f64["ms"],
        plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"],
        bound_by=f64["bound_by"], library_ms=None,
        max_rel_err=f64["max_rel_err"],
        bound_ms_measured_bw=f64["bound_ms_measured_bw"],
        also_replaces="helios_tpu/kernels/sweep_pallas.py:162",
        fp32={k: f32[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "bound_ms_measured_bw")})]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

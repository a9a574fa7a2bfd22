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
     at 1001 passes), the Thomas solve at the iso and non-iso matrix sizes
     (212 and 422 rows), the Random Overlap mix of 105 x 385 cells of 20
     Gauss points; error, CUDA-event times of back-to-back launches (the
     iso sweep also at the post-processing run's 1001 passes), the card's
     copy bandwidth and
     each kernel's bound; the sweeps and the Thomas solve at ragged
     shapes, shorter than their rings and blocks and with odd S (the iso
     sweep at 1, 4 and 7 passes and at L = 1000, the narrowest blocks its
     shared memory allows; both sweeps at 1001 passes at L = 12, the
     non-iso sweep also at 7); and the chained-pass identity of both
     sweeps at the flagship shape (one call of n passes equals n
     single-pass calls fed each other's upward fluxes, bit for bit, at n =
     7 and 1001); the Random Overlap mix bit for bit with its plain
     version, at the flagship shape and at ragged ny (2 to 126) on cells
     of ties, gray cells, unsorted and infinite entries and negligible
     overlap, with the cells its kernel sends through its general branch
     counted; then, in fp64, each kernel at the width of path n's
     ensemble: 8 x 7700 = 61,600 columns for the sweeps and the Thomas
     solve, 8 x 105 x 385 = 323,400 cells for the Random Overlap mix;
     the fixed-order sums and scans (ordered_sum) at the loops' shapes,
     bit for bit the in-order loop, within rounding of torch.sum /
     torch.cumsum, and every member of a batch of copies bit for bit the
     call alone, fp64 and fp32, timed at the Gauss sum of the flagship
     and of path n's batch; the flux integration (band_integrate) bit for
     bit its in-order reference and the chain it replaced (through
     ordered_sum) at the flagship [106, 7700], path n's batch [106, 8,
     7700] with the members' shared delta_lambda and the flagship as 2
     slices with the carry (the totals the flagship's), fp64 and fp32,
     timed against that chain of 15 launches and its bound; the convective
     adjustment (conv_adjust) bit for bit the chain of ops it replaces at
     4 rounds, a flagship column and an 8-planet batch, fp64 and fp32,
     both timed back to back, as CUDA graphs and on the device; the host time
     of a kernel wrapper's launch, step by step, at the Gauss sum; then
     the host tools: the port's ktable
     library (kdistr.cpp) built by g++ on this machine, its
     k-distribution of a 4.1-million-point line list (0.01 cm^-1 over
     0.244-500 um) into 385 bins x 20 and its bilinear regrid onto the
     final (T, P) grid, each against the numpy version at rtol 1e-12,
     with both host CPU times;
  4. the paths, each with every launch count set to 0 just before it and
     read just after (ordered_sum and band_integrate: at least once
     wherever a flux solve runs); every flux integration on the card, on
     every path run in this process, launches band_integrate once per
     spectral slice (once on a whole model) and no ordered_sum (checked
     at each integration).  One planet's loops run as replayed CUDA
     graphs (helios_tpu_torch.rce.graphs): a path's launches are its
     solves' and those of the loop iterations that changed nothing
     (replayed past the stop, a redone chunk's first try), which the
     runners count apart; each path logs its graphs, capture and eager
     seconds, replays, reads, redos and idle launches, and paths a, d, e,
     h and m run again through the per-iteration loop, bit for bit:
     a. the flagship RCE run (105 layers x 385 bins x 20 Gauss points,
        non-isothermal, scattering, convection, fp64) to convergence
        through helios_tpu_torch.pipeline.run; then one forward_fluxes on
        the card against the same call on the CPU, and where a radiation
        iteration's time goes (host wall against device busy time,
        torch.profiler), the same with torch's sums in place of the
        fixed-order ones;
     b. the post-processing run of the converged flagship profile, read
        back from a "PT" file, with the direct beam and the output files
        (one solve of 1001 sweep passes); its TOA spectrum against the
        same solve on the CPU;
     c. the isothermal iterative run of the JAX package's iso benchmark
        workload (T_intern 100 K, no convection, no beam), 200 radiation
        iterations, and its time breakdown;
     d. the matrix flux method: the flagship RCE run of path a with
        flux_calc_method="matrix" through both loops and its time
        breakdown, one forward_fluxes on the card against the CPU, and path
        b's post-processing run with the matrix method (one Thomas solve in
        place of the 1001 passes);
     e. on-the-fly Random Overlap mixing: the JAX package's on-the-fly
        benchmark workload (bench.py:329-354: H2O and CO2 absorbing, H2
        Rayleigh, He; isothermal), 200 radiation iterations and their time
        breakdown; one non-isothermal forward_fluxes of the same species on
        the card against the CPU; the post-processing run of the final
        profile with the output files; and the cells of its ro_mix calls
        that take the kernel's general branch (forward solves at the
        start and final profiles);
     f. cloud decks and the geometric zenith correction (BASELINE config
        4): path a's flagship RCE run with the direct beam at 80 degrees
        and one Mie cloud deck (a synthetic LX-Mie directory written into
        a temporary directory), to convergence; one forward_fluxes on the
        card against the CPU; its time breakdown;
     g. the post-processing run of path f's converged profile with the
        output files, the four cloud files among them (one solve of 1001
        sweep passes); its TOA spectrum against the CPU;
     h. a rocky surface (BASELINE config 5) at 105 layers x 385 x 20: the
        surface albedo and additional heating from files, the Koll
        f-factor, a physical timestep (exactly runtime_limit /
        physical_tstep radiation iterations, then one convective
        adjustment), with the output files; one forward_fluxes against the
        CPU; its time breakdown;
     i. the bare rock (planet_type="no_atmosphere", 2 layers x 385 x 20)
        to convergence, against the analytic surface temperature;
     j. one forward_fluxes of path f's workload with the matrix method on
        the card against the CPU;
     k. the quickstart through the command line: the inputs of
        `python3 -m helios_tpu_torch.examples` (385 bins x 20, 105
        layers), then `helios_tpu_torch.__main__.main` in a new process
        with progress lines, metrics and a checkpoint every 100
        iterations; its final T and iteration counts bit for bit those of
        an unmonitored pipeline.run of the same param.dat in this process,
        its files, checkpoints and metrics, the checkpoint's size and time;
        without h5py the table stays in memory (the HDF5 readers are named
        as not run);
     l. preempt and resume: path k's config stopped after the radiation
        checkpoint at iteration 200 and resumed from the file through the
        command line; then the checkpoint pair that this resumed run
        wrote at convection iteration 200 (what a run stopped there
        leaves) resumed from the _conv file; both bit for bit path k's;
     m. the flagship with real-gas thermodynamics (a synthetic
        water-atmosphere table), a synthetic stellar spectrum file, the
        beam and coupling (on-the-fly mixing of path e's species),
        coupling iterations 0 and 1 to convergence; entropy and phase
        inside the table's range, kappa, c_p, entropy and phase against a
        plain numpy lookup, coupling convergence "1", the forward totals
        against the CPU; then its post-processing run with the same table
        (one iso_sweep of 1001 passes); and path a's flagship with the
        same table through both loops, its convection loop running on the
        table (the lookups against the plain one, the convection step's
        wall against path a's, the device time of one step's lookups);
     n. a flagship ensemble: helios_tpu_torch.parallel.ensemble.
        run_ensemble of 8 planets with path a's config and start profile,
        surface albedos 0.0, 0.1, ..., 0.7, the table in memory, to
        convergence: every member finite and converged, one noniso_sweep
        launch per batched flux solve over the 61,600 columns (not one per
        member); where a member's bits could part from its run alone: one
        forward solve and one convective adjustment of path a's planet,
        alone and as 8 copies in a batch, every op's output compared
        member by member, with torch's sums (the first op that differs
        and its slots are logged) and with the fixed-order ones (no op may
        differ); the 8 copies run to convergence, each bit for bit path
        a; member 0's forward solve bit for bit its solve alone, and
        member 0 bit for bit path a's run (T and both iteration counts);
        the batch's wall against 8 x path a's, planets per hour, the peak
        device memory per member, a batched radiation iteration's time
        breakdown with the fixed-order sums and with torch's, and one
        batched forward_fluxes on the card against the CPU;
     o. the ensemble command line: the quickstart's param.dat with the
        shipped planets.dat (dark, gray and bright, surface albedo 0.0,
        0.25, 0.5) through helios_tpu_torch.__main__.main in this process
        with progress lines and a checkpoint every 100 iterations: each
        member's file set, the ensemble checkpoint pair, one launch per
        batched flux solve, the dark member bit for bit path k's
        unmonitored run; then the same command again, which
        resumes from the converged checkpoints, solves no flux (only
        the restore's sums run) and leaves the files unchanged;
     p. meshes of spectral slices on the one card: path a's flagship
        through pipeline.run with n_spectral_shards 2 and 4 and the device
        list cuda:0 x n (385 bins padded to 386 and 388): each run bit
        for bit path a (final T, both iteration counts, the TOA band
        fluxes), or else the forward fields that differ named and the run
        held to rtol 1e-6; one noniso_sweep launch per slice and flux
        solve; the walls and a radiation iteration's host and device time
        against path a's; with one card, device="cuda" and 2 slices raise
        the JAX package's RuntimeError;
     q. the planet x spectral ensemble mesh: path n's first 4 members
        through run_ensemble with n_planet_batch 2 and n_spectral_shards 2
        on cuda:0 x 4 (two groups of two members, each over 2 slices):
        each member bit for bit its path-n result (T, both counts), or else
        held to rtol 1e-6; one noniso_sweep launch per slice and batched
        flux solve of each group;
  5. a JSON line of the kernels, the nvidia-smi line, and the result line.

Needs one CUDA card; exits non-zero without one.  Imports neither JAX nor
the JAX package.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# NVIDIA's data sheet of the H100 SXM: HBM rate and non-tensor peak FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
DEVICE = "cuda"
L_FLAG, NBIN_FLAG, NY_FLAG, PASSES = 105, 385, 20, 4
PP_PASSES = 1001            # 1000*scat+1 passes of a post-processing solve
ISO_RCE_ITERATIONS = 200
# rows of the matrix method's tridiagonal systems at the flagship depth
THOMAS_ROWS = {"iso": 2 * (L_FLAG + 1), "noniso": 4 * (L_FLAG + 1) - 2}

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

def cuda_ms(fn, reps, warmup, per_event=1):
    """Median CUDA-event time of one fn() in milliseconds, over `reps`
    samples of `per_event` back-to-back calls each: with several calls
    between the events, the host's time to launch the next call overlaps
    the device's work on the last one and is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_event):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_event)
    return statistics.median(times)


def copy_bandwidth():
    """Device-to-device copy rate of a 2 GiB buffer [bytes/s], read +
    write counted."""
    n = 1 << 28
    src = torch.empty(n, dtype=torch.float64, device=DEVICE).fill_(1.0)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=10, warmup=2, per_event=5)
    del src, dst
    return 2 * n * 8 / (ms * 1e-3)


def kernel_counters():
    from helios_tpu_torch.kernels.adjust import conv_adjust
    from helios_tpu_torch.kernels.integrate import band_integrate
    from helios_tpu_torch.kernels.ordered import ordered_sum
    from helios_tpu_torch.kernels.ro import ro_mix
    from helios_tpu_torch.kernels.sweep import iso_sweep, noniso_sweep
    from helios_tpu_torch.kernels.thomas import thomas_solve
    return {"noniso_sweep": noniso_sweep, "iso_sweep": iso_sweep,
            "thomas_solve": thomas_solve, "ro_mix": ro_mix,
            "ordered_sum": ordered_sum, "band_integrate": band_integrate,
            "conv_adjust": conv_adjust}


# the loops block (graphs.loops) of the path that runs: its runners serve
# the path's runs and are dropped, graphs and buffers, at the next reset
PATH_LOOPS = contextlib.ExitStack()
PATH = {}


def reset_counts():
    """Every launch count to 0, the last path's loops block closed and a
    new one opened, its runners and the kept ones (graphs.clear_kept)
    dropped with their graphs and buffers, and the peak memory reset, so
    that a path's graphs, replays, reads, idle launches and peak are its
    own."""
    from helios_tpu_torch.rce import graphs
    for fn in kernel_counters().values():
        fn.launches = 0
    PATH_LOOPS.close()
    graphs.clear_kept()
    PATH["loops"] = PATH_LOOPS.enter_context(graphs.loops())
    torch.cuda.reset_peak_memory_stats()


def read_idle():
    """Per kernel, the launches of the path's loop iterations that changed
    nothing (replayed past the stop, or the first try of a redone chunk),
    as its runners counted them."""
    idle = dict.fromkeys(kernel_counters(), 0)
    for st in PATH["loops"].stats.values():
        for name, n in st.idle_launches.items():
            idle[name] += n
    return idle


def read_counts():
    """The launch counts since the last reset, and under "idle" those of
    them that changed nothing (read_idle)."""
    counts = {name: fn.launches for name, fn in kernel_counters().items()}
    counts["idle"] = read_idle()
    return counts


class AtLeastOnce:
    """A launch count that has to be positive: the fixed-order sums and
    scans run at each cell refresh, radiation step and convective
    adjustment, and the flux integration once per flux solve and per state
    built or restored, numbers the paths' checks do not pin (each
    integration's own launches are checked by checked_integrations)."""

    def __eq__(self, n):
        return isinstance(n, int) and n > 0

    def __repr__(self):
        return ">= 1"


def only(idle=None, **counts):
    """The launch counts of a path that runs just the named kernels; with
    any flux solve (a named count), also the flux integration and the
    fixed-order sums and scans, at least once; none of the convective
    adjustment unless named (a path with a convection loop names its
    loops' count, adjust_count).  ``idle``: the launches of the iterations
    that changed nothing (read_idle), added to the counts and expected
    under "idle"."""
    idle = idle or dict.fromkeys(kernel_counters(), 0)
    sums = AtLeastOnce() if any(counts.values()) else 0
    want = {name: (sums if name in ("ordered_sum", "band_integrate")
                   and name not in counts
                   else counts.get(name, 0) + idle[name])
            for name in kernel_counters()}
    want["idle"] = idle
    return want


def adjust_count(label, stats):
    """The convective adjustment's launches that a path's loops counted
    (Stats.adjust_launches, ``stats`` as loop_stats gives them; 0 where no
    convection loop ran), less those of the iterations that changed
    nothing, which only() adds from the counts' idle ones.  Each loop is
    held to its iterations: the radiation loop launches none; a
    convection loop that redid no chunk and read no round launches one
    per iteration run or replayed past the stop (its bounded
    adjustments), one that replayed nothing (the per-iteration loop) one
    per read of its unbounded adjustments, and one that redid a chunk
    more than one per iteration."""
    total = 0
    for kind, st in stats.items():
        if st is None:
            continue
        n, its = st["adjust_launches"], st["iterations"] + st["past_stop"]
        if kind != "convection":
            check(n == 0, f"{label}: {n} conv_adjust launches in the {kind} "
                  "loop")
        elif not st["redos"] and not st["adjust_reads"]:
            check(n == its, f"{label}: {n} conv_adjust launches for {its} "
                  "convection iterations (none redone)")
        elif not st["replays"]:
            check(n == st["adjust_reads"] > 0,
                  f"{label}: {n} conv_adjust launches for "
                  f"{st['adjust_reads']} adjustment reads")
        else:
            check(n > its, f"{label}: {n} conv_adjust launches for {its} "
                  f"convection iterations and {st['redos']} redone chunks")
        total += n - st["idle_launches"].get("conv_adjust", 0)
    return total


def loop_stats():
    """What the path's loop runners did since the last reset_counts:
    {loop: graphs.Stats as a dict} (None for a loop that did not run)."""
    stats = PATH["loops"].stats
    return {k: (stats[k].as_dict() if k in stats else None)
            for k in ("radiation", "convection")}


def rounds_text(hist):
    """The nonzero bins of an adjustment-rounds histogram, {rounds: n}."""
    return {k: n for k, n in enumerate(hist) if n} if hist else {}


def loop_line(label, out=None, stats=None):
    """Log how a path's loops ran: per loop the CUDA graphs captured and
    the host seconds their captures took, their replays, the eager
    iterations and their host seconds, the device reads (and per
    iteration), the redone chunks, the iterations replayed past the stop,
    the launches of the iterations that changed nothing and the adjustment
    rounds needed (first tries); the peak device memory since the path's
    start (of this process: not with ``stats`` from another); with ``out``
    (a RunOutput) the host wall per radiation and convection iteration.
    Returns the stats."""
    memory = ""
    if stats is None:
        stats = loop_stats()
        memory = (f"; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    parts = []
    for kind, st in stats.items():
        if st is None:
            continue
        its = max(st["iterations"], 1)
        idle = {k: n for k, n in st["idle_launches"].items() if n}
        parts.append(
            f"{kind} {st['graphs']} graphs (captures {st['capture_s']:.3f} "
            f"s), {st['replays']} replays, {st['eager']} eager iterations "
            f"({st['eager_s']:.3f} s), "
            f"{st['reads']} reads ({st['reads'] / its:.3f} per iteration), "
            f"{st['redos']} redos, {st['past_stop']} iterations past the "
            f"stop, idle launches {idle}"
            + (f", adjustment rounds {rounds_text(st['rounds'])}"
               if st["rounds"] else ""))
    walls = ""
    if out is not None:
        walls = f"; host wall {out.rad_seconds / max(out.rad.it, 1) * 1e3:.3f}"
        walls += " ms per radiation iteration"
        if out.conv is not None and out.conv.steps:
            walls += (f", {out.conv_seconds / out.conv.steps * 1e3:.3f} ms "
                      "per convection iteration")
    log(f"{label} loops: " + ("; ".join(parts) or "no chunked loop")
        + memory + walls)
    return stats


def per_iteration_twin(label, run, graphed):
    """``run()`` (a pipeline.run of a path) again through the per-iteration
    loop: bit for bit the graphed run ``graphed`` (final T, both counts,
    the TOA spectrum); logs both walls.  Returns the per-iteration run."""
    from helios_tpu_torch.rce import graphs
    torch.cuda.synchronize()
    with graphs.loops(graphs.PER_ITERATION):
        per = run()
    counts = lambda o: (o.rad.it, o.conv.it if o.conv is not None else 0,
                        o.conv.steps if o.conv is not None else 0)
    check(torch.equal(graphed.T_lay, per.T_lay)
          and counts(graphed) == counts(per)
          and torch.equal(graphed.totals.F_up_band[-1],
                          per.totals.F_up_band[-1]),
          f"{label}: the graphed run {counts(graphed)} is not bit for bit "
          f"the per-iteration run {counts(per)}")
    log(f"{label}: the graphed run bit for bit the per-iteration run "
        f"({counts(graphed)}); wall {graphed.wall_seconds:.3f} s against "
        f"{per.wall_seconds:.3f} s (radiation loop {graphed.rad_seconds:.3f} "
        f"against {per.rad_seconds:.3f} s, convection loop "
        f"{graphed.conv_seconds:.3f} against {per.conv_seconds:.3f} s)")
    return per


# the modules that call forward.integrate_flux_flat by name
INTEGRATION_SITES = ("forward", "rce.radiative", "rce.loop", "pipeline",
                     "checkpoint")
INTEGRATIONS = {"calls": 0, "on_card": 0, "launches": 0}


@contextlib.contextmanager
def checked_integrations():
    """While the block runs, every flux integration on the card
    (forward.integrate_flux_flat, at each of INTEGRATION_SITES) is checked
    to launch band_integrate exactly once per spectral slice (once on a
    whole model) and no ordered_sum; one on the CPU, nothing.  Counts the
    integrations in INTEGRATIONS; those inside patched_sites (another
    route of the integration) are not checked."""
    import importlib
    from helios_tpu_torch import forward
    from helios_tpu_torch.kernels.integrate import band_integrate
    from helios_tpu_torch.kernels.ordered import ordered_sum
    from helios_tpu_torch.ops.slices import count, home

    def checked(fn):
        def integrate(phys, m, *args, **kw):
            if forward.band_integrate is not band_integrate:
                return fn(phys, m, *args, **kw)     # patched_sites' routes
            before = (band_integrate.launches, ordered_sum.launches)
            out = fn(phys, m, *args, **kw)
            card = home(m).type == "cuda"
            want = (max(1, count(m)) if card else 0, 0)
            got = (band_integrate.launches - before[0],
                   ordered_sum.launches - before[1])
            check(got == want, f"a flux integration launched {got[0]} "
                  f"band_integrate and {got[1]} ordered_sum, not {want}")
            INTEGRATIONS["calls"] += 1
            INTEGRATIONS["on_card"] += card
            INTEGRATIONS["launches"] += got[0]
            return out
        return integrate

    saved = []
    for name in INTEGRATION_SITES:
        mod = importlib.import_module("helios_tpu_torch." + name)
        saved.append((mod, mod.integrate_flux_flat))
    real = saved[0][1]
    for mod, fn in saved:
        check(fn is real, f"{mod.__name__}.integrate_flux_flat is not "
              "forward's")
        mod.integrate_flux_flat = checked(fn)
    try:
        yield
    finally:
        for mod, fn in saved:
            mod.integrate_flux_flat = fn


def sweep_inputs(dtype, seed=0, L=L_FLAG, S=NBIN_FLAG * NY_FLAG):
    rng = np.random.default_rng(seed)
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


def sweep_case(dtype, rtol, bandwidth, S=NBIN_FLAG * NY_FLAG):
    from helios_tpu_torch.kernels.sweep import (noniso_sweep,
                                                noniso_sweep_reference)
    args = sweep_inputs(dtype, S=S)
    L, S = args[0].shape
    got = noniso_sweep(*args, n_passes=PASSES)
    torch.cuda.synchronize()
    max_rel, max_abs = max_errors(
        got, noniso_sweep_reference(*args, n_passes=PASSES))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "noniso_sweep: non-finite output")
    check(max_rel <= rtol, f"noniso_sweep {dtype}: max relative error "
          f"{max_rel:.3e} > {rtol:.0e}")
    ms = cuda_ms(lambda: noniso_sweep(*args, n_passes=PASSES), 10, 3,
                 per_event=20)
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


def iso_inputs(dtype, seed=1, L=L_FLAG, S=NBIN_FLAG * NY_FLAG):
    """Random iso sweep inputs; the fp32 set is the fp64 set rounded."""
    rng = np.random.default_rng(seed)
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


def iso_case(dtype, rtol, bandwidth, S=NBIN_FLAG * NY_FLAG):
    from helios_tpu_torch.kernels.sweep import iso_sweep, iso_sweep_reference
    args = iso_inputs(dtype, S=S)
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
    res["ms"] = cuda_ms(lambda: iso_sweep(*args, n_passes=PASSES), 10, 3,
                        per_event=20)
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


def thomas_inputs(dtype, n, seed, S=NBIN_FLAG * NY_FLAG):
    """A diagonally dominant M-matrix system (b in [2, 3], c in
    [-0.9, -0.1], sub-diagonal c_{i-1}) with d > 0: its solution is
    positive, so relative errors are well defined."""
    rng = np.random.default_rng(seed)
    mk = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, (n, S)),
                                     device=DEVICE).to(dtype)
    return [mk(2.0, 3.0), mk(-0.9, -0.1), mk(1.0, 1e3)]


def thomas_bound_ms(dtype, n, S, bandwidth=HBM_BYTES_PER_S):
    """(bound ms, what sets it): b, c, d read and x written once, 4 n S
    values; 8 flops per row and column (two divisions, two fma and a
    multiply-subtract going forward, one fma back)."""
    size = torch.empty((), dtype=dtype).element_size()
    bytes_ms = 4 * n * S * size / bandwidth * 1e3
    ops_ms = 8 * n * S / PEAK_FLOPS[dtype] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def thomas_case(dtype, rtol, bandwidth, S=NBIN_FLAG * NY_FLAG):
    from helios_tpu_torch.kernels.thomas import (thomas_solve,
                                                 thomas_solve_reference)
    name = str(dtype).split(".")[-1]
    res = {}
    for label, n in THOMAS_ROWS.items():
        args = thomas_inputs(dtype, n, seed=n, S=S)
        S = args[0].shape[1]
        got = thomas_solve(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"thomas_solve {name}: non-finite output")
        rel, ab = max_errors([got], [thomas_solve_reference(*args)])
        check(rel <= rtol, f"thomas_solve {name} n={n}: max relative error "
              f"{rel:.3e} > {rtol:.0e}")
        r = dict(n=n, max_rel_err=rel, max_abs_err=ab,
                 ms=cuda_ms(lambda: thomas_solve(*args), 10, 3,
                            per_event=20),
                 plain_ms=cuda_ms(lambda: thomas_solve_reference(*args), 5,
                                  1))
        r["bound_ms"], r["bound_by"] = thomas_bound_ms(dtype, n, S)
        r["bound_ms_measured_bw"] = thomas_bound_ms(dtype, n, S,
                                                    bandwidth)[0]
        log(f"thomas_solve {name} [{n} x {S}, {label} matrix]: max rel err "
            f"{rel:.3e} (limit {rtol:.0e}), max abs err {ab:.3e}; kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({4 * n * S * args[0].element_size() / 1e6:.1f} MB at "
            f"3.35 TB/s), {r['bound_ms_measured_bw']:.4f} ms at the measured "
            f"{bandwidth / 1e12:.3f} TB/s; library: none (no single PyTorch "
            "call solves a batched tridiagonal system)")
        res[label] = r
    return res


# shapes shorter than the ring kernels' rings and the iso sweep's blocks
# (L = 1, n = 2) and row lengths S that are odd or leave a block part-filled
RAGGED_SWEEP = [(L, S) for L in (1, 12) for S in (1, 37, 257)]
RAGGED_THOMAS = [(n, S) for n in (2, 50) for S in (1, 37, 257)]
# the iso sweep at a depth where only 4 fp64 columns fit a block
ISO_DEEP = (1000, 37)


def ragged_case(dtype, rtol):
    """The sweeps and the Thomas solve against their plain versions at
    ragged shapes: the non-iso sweep at RAGGED_SWEEP (4 passes) and at L =
    12 with 7 and 1001 passes, the iso sweep at RAGGED_SWEEP and ISO_DEEP
    with 1, 4 and 7 passes and at L = 12 with 1001, the Thomas solve at
    RAGGED_THOMAS; returns each one's largest relative error."""
    from helios_tpu_torch.kernels.sweep import (iso_sweep,
                                                iso_sweep_reference,
                                                noniso_sweep,
                                                noniso_sweep_reference)
    from helios_tpu_torch.kernels.thomas import (thomas_solve,
                                                 thomas_solve_reference)
    name = str(dtype).split(".")[-1]
    worst = dict(noniso_sweep=0.0, noniso_sweep_7_1001=0.0, iso_sweep=0.0,
                 thomas_solve=0.0)
    noniso = lambda n: (lambda a: noniso_sweep(*a, n_passes=n),
                        lambda a: noniso_sweep_reference(*a, n_passes=n))
    iso = lambda n: (lambda a: iso_sweep(*a, n_passes=n),
                     lambda a: iso_sweep_reference(*a, n_passes=n))
    runs = [("noniso_sweep", (L, S, PASSES),
             sweep_inputs(dtype, 10 * L + S, L, S), *noniso(PASSES))
            for L, S in RAGGED_SWEEP]
    runs += [("noniso_sweep_7_1001", (12, S, n),
              sweep_inputs(dtype, 10 * n + S, 12, S), *noniso(n))
             for S in (37, 257) for n in (7, PP_PASSES)]
    runs += [("iso_sweep", (L, S, n), iso_inputs(dtype, 10 * L + S, L, S),
              *iso(n))
             for L, S in RAGGED_SWEEP + [ISO_DEEP] for n in (1, PASSES, 7)]
    runs += [("iso_sweep", (12, S, PP_PASSES), iso_inputs(dtype, S, 12, S),
              *iso(PP_PASSES)) for S in (37, 257)]
    runs += [("thomas_solve", (n, S), thomas_inputs(dtype, n, n + S, S),
              lambda a: [thomas_solve(*a)],
              lambda a: [thomas_solve_reference(*a)])
             for n, S in RAGGED_THOMAS]
    for kernel, shape, args, fn, plain in runs:
        got = fn(args)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{kernel} {name} {shape}: non-finite output")
        rel, _ = max_errors(got, plain(args))
        check(rel <= rtol, f"{kernel} {name} at {shape}: max relative error "
              f"{rel:.3e} > {rtol:.0e}")
        worst[kernel] = max(worst[kernel], rel)
    log(f"ragged shapes, {name} (limit {rtol:.0e}): noniso_sweep at (L, S) "
        f"in {RAGGED_SWEEP}, {PASSES} passes: max rel err "
        f"{worst['noniso_sweep']:.3e}, at L = 12, S in (37, 257), 7 and "
        f"{PP_PASSES} passes: {worst['noniso_sweep_7_1001']:.3e}; iso_sweep "
        f"at (L, S) in {RAGGED_SWEEP + [ISO_DEEP]}, 1, {PASSES} and 7 "
        f"passes, and at L = 12, {PP_PASSES} passes: "
        f"{worst['iso_sweep']:.3e}; thomas_solve at (n, S) in "
        f"{RAGGED_THOMAS}: {worst['thomas_solve']:.3e}")
    return worst


def profiled_kernel_ms(fn, kernel, n=20, tries=3):
    """The device time of one fn() in the named CUDA kernel, by
    torch.profiler over n calls; profiled again, up to ``tries`` times,
    while the profiler records none of the kernel's launches (a trace
    that lost its kernel events was seen once on the card)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.key)
        if us > 0:
            break
    check(us > 0, f"the profiler saw no {kernel} in {tries} traces")
    return us / 1e3 / n


def ordered_inputs(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(1.0, 1e4, shape), dtype=dtype,
                        device=DEVICE)


def ordered_case(dtype, rtol, bandwidth):
    """The fixed-order sums and scans at the main path's shapes: the Gauss
    sums ([L+1, nbin, ny] over ny), the band sums ([L+1, nbin] over nbin),
    the beam's layer scan ([L, S] along L) and a per-layer scan ([L]), each
    also as ENSEMBLE_P copies at every slot of a batch ([L+1, P, ...],
    [L, P, S], [L, P]).  Each result bit for bit the in-order loop
    (kernels.ordered.in_order_reference); within ``rtol`` of the plain
    version (torch.sum / torch.cumsum, another order); every batch member
    bit for bit the call alone, where the plain version's members are
    counted that are not.  Times the Gauss sum, the main path's largest."""
    from helios_tpu_torch.kernels.ordered import (in_order_reference,
                                                  ordered_cumsum, ordered_sum)
    L, B, Y, P = L_FLAG, NBIN_FLAG, NY_FLAG, ENSEMBLE_P
    name = str(dtype).split(".")[-1]
    cases = (("gauss sum", (L + 1, B, Y), 2, False),
             ("band sum", (L + 1, B), 1, False),
             ("beam layer scan", (L, B * Y), 0, True),
             ("layer scan", (L,), 0, True))
    res = {}
    for k, (label, shape, dim, scan) in enumerate(cases):
        kernel = ordered_cumsum if scan else ordered_sum
        plain = ((lambda t, d: torch.cumsum(t, d)) if scan
                 else (lambda t, d: torch.sum(t, d)))
        x = ordered_inputs(dtype, shape, seed=10 + k)
        # the batch: P copies, the planet axis after the first (layer) axis
        xb = torch.stack([x] * P, dim=1).contiguous()
        dimb = dim + 1 if dim > 0 else 0
        got, got_b = kernel(x, dim), kernel(xb, dimb)
        want, in_order = plain(x, dim), in_order_reference(x, dim, scan)
        want_b = plain(xb, dimb)
        torch.cuda.synchronize()
        check(torch.equal(got, in_order), f"ordered_sum {name} {label}: "
              "not bit for bit the in-order loop")
        rel = float(((got - want).abs() / want.abs()).max())
        err = float((got - want).abs().max())
        check(rel <= rtol, f"ordered_sum {name} {label}: {rel:.3e} off "
              f"torch's sum (limit {rtol:.0e})")
        members = lambda t: [t.select(1 if t.dim() > 1 else 0, p)
                             for p in range(P)]
        same = [torch.equal(m, got) for m in members(got_b)]
        plain_same = [torch.equal(m, want) for m in members(want_b)]
        check(all(same), f"ordered_sum {name} {label}: batch members "
              f"{[p for p, s in enumerate(same) if not s]} are not the "
              "call alone")
        res[label] = dict(shape=list(shape), max_rel_err_vs_plain=rel,
                          max_abs_err_vs_plain=err,
                          plain_members_off=[p for p, s in
                                             enumerate(plain_same) if not s])
        log(f"ordered_sum {name} {label} {list(shape)} along {dim}: bit for "
            f"bit the in-order loop, {rel:.3e} off torch's "
            f"{'cumsum' if scan else 'sum'} (limit {rtol:.0e}); as "
            f"{P} copies in a batch every member bit for bit the call "
            f"alone (torch's {'cumsum' if scan else 'sum'}: members "
            f"{res[label]['plain_members_off']} differ from its call alone)")

    x = ordered_inputs(dtype, (L + 1, B, Y), seed=10)
    xb = torch.stack([x] * P, dim=1).contiguous()
    size = x.element_size()
    out = {}
    for key, t, d in (("", x, 2), ("ensemble_", xb, 3)):
        n_in, n_out = t.numel(), t.numel() // Y
        bytes_ms = (n_in + n_out) * size / HBM_BYTES_PER_S * 1e3
        ops_ms = n_in / PEAK_FLOPS[dtype] * 1e3
        ms = cuda_ms(lambda: ordered_sum(t, d), 20, 3, per_event=20)
        plain_ms = cuda_ms(lambda: torch.sum(t, d), 20, 3, per_event=20)
        in_order_ms = cuda_ms(lambda: in_order_reference(t, d, False), 5, 1)
        device_ms = profiled_kernel_ms(lambda: ordered_sum(t, d),
                                       "ordered_sum_kernel")
        out.update({key + "ms": ms, key + "plain_ms": plain_ms,
                    key + "device_ms": device_ms,
                    key + "in_order_ms": in_order_ms,
                    key + "bound_ms": max(bytes_ms, ops_ms),
                    key + "bound_by": ("bytes" if bytes_ms >= ops_ms
                                       else "operations"),
                    key + "bound_ms_measured_bw":
                        (n_in + n_out) * size / bandwidth * 1e3})
        log(f"ordered_sum {name} gauss sum {list(t.shape)}: kernel "
            f"{ms:.4f} ms back to back (the wrapper's host launch time "
            f"shows in so short a call; on the device {device_ms:.4f} ms by "
            f"the profiler), torch.sum {plain_ms:.4f} ms, the in-order loop "
            f"{in_order_ms:.3f} ms; bound {out[key + 'bound_ms']:.4f} ms "
            f"({(n_in + n_out) * size / 1e6:.1f} MB at 3.35 TB/s)")
    return dict(out, cases=res,
                max_rel_err=max(r["max_rel_err_vs_plain"]
                                for r in res.values()),
                max_abs_err=max(r["max_abs_err_vs_plain"]
                                for r in res.values()))


def band_integrate_bound_ms(dtype, R, S, B, Y, dl_values):
    """(bound in ms, "bytes" or "operations") of one band_integrate: the
    three fluxes, the weights and delta_lambda read once, the three bands
    and three totals written once; 2 operations per flux value (the Gauss
    product and add), 8 per bin and row (three halvings, two products, an
    add and the two totals)."""
    size = torch.finfo(dtype).bits // 8
    bytes_ms = ((3 * R * S + Y + dl_values) + (3 * R * B + 3 * R)) \
        * size / HBM_BYTES_PER_S * 1e3
    ops_ms = (2 * 3 * R * S + 8 * R * B) / PEAK_FLOPS[dtype] * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def band_integrate_case(dtype):
    """The flux integration kernel against its in-order reference (the
    chain the card ran before it, every sum in index order), bit for bit
    (torch.equal), and against that chain through the ordered_sum kernel:
    at the flagship [L+1, S], at path n's batch [L+1, 8, S] with the
    members' shared delta_lambda (stack_models' expanded view), and the
    flagship as 2 slices (385 bins padded to 386, the pad's delta_lambda
    0), the second starting from the first's totals, whose totals are the
    flagship's.  Times the kernel and the 14-launch chain (and F_net, a
    15th) back to back, the kernel's device time by the profiler, and its
    bound."""
    from helios_tpu_torch.kernels.integrate import (band_integrate,
                                                    band_integrate_reference)
    L, B, Y, P = L_FLAG, NBIN_FLAG, NY_FLAG, ENSEMBLE_P
    S = B * Y
    name = str(dtype).split(".")[-1]
    rng = np.random.default_rng(20)
    mk = lambda lo, hi, *s: torch.tensor(rng.uniform(lo, hi, s), dtype=dtype,
                                         device=DEVICE)
    w = mk(0.01, 0.1, Y)
    dl = mk(1e-7, 1e-5, B)
    cases = {"flagship": ([mk(0.0, 1e6, L + 1, S) for _ in range(3)], dl),
             "batch": ([mk(0.0, 1e6, L + 1, P, S) for _ in range(3)],
                       dl.expand(P, B))}

    def same(label, got, want, what):
        torch.cuda.synchronize()
        off = [f for f, g, x in zip(got._fields, got, want)
               if not torch.equal(g, x)]
        check(not off, f"band_integrate {name} {label}: {off} not bit for "
              f"bit {what}")

    res = {}
    for label, (f, d) in cases.items():
        got = band_integrate(*f, w, d)
        same(label, got, band_integrate_reference(*f, w, d, in_order=True),
             "the in-order reference")
        same(label, got, band_integrate_reference(*f, w, d),
             "the chain through ordered_sum")
        res[label] = got

    # two slices with the carry: the pad copies the last bin
    h = (B + 1) // 2
    pad = [torch.cat([x, x[..., -Y:]], -1) for x in cases["flagship"][0]]
    dl_pad = torch.cat([dl, torch.zeros_like(dl[-1:])])
    part = lambda k: ([x[..., k * h * Y:(k + 1) * h * Y].contiguous()
                       for x in pad]
                      + [w, dl_pad[k * h:(k + 1) * h].contiguous()])
    a = band_integrate(*part(0))
    want_a = band_integrate_reference(*part(0), in_order=True)
    same("slice 0 of 2", a, want_a, "the in-order reference")
    b = band_integrate(*part(1), carry=(a.F_up_tot, a.F_down_tot))
    same("slice 1 of 2", b, band_integrate_reference(
        *part(1), carry=(want_a.F_up_tot, want_a.F_down_tot),
        in_order=True), "the in-order reference")
    whole = res["flagship"]
    check(all(torch.equal(getattr(b, k), getattr(whole, k))
              for k in ("F_up_tot", "F_down_tot", "F_net")),
          f"band_integrate {name}: the 2-slice totals are not the "
          "flagship's")
    log(f"band_integrate {name}: bit for bit the in-order reference and "
        f"the chain through ordered_sum at the flagship [{L + 1}, {S}] and "
        f"the {P}-planet batch [{L + 1}, {P}, {S}] (shared delta_lambda); "
        f"on 2 slices with the carry (bins padded to {2 * h}) bit for bit "
        "per slice, the totals the flagship's")

    out = dict(max_abs_err=0.0, bitwise_vs_in_order=True)
    for key, label in (("", "flagship"), ("ensemble_", "batch")):
        f, d = cases[label]
        R = f[0].numel() // S
        call = lambda: band_integrate(*f, w, d)
        ms = cuda_ms(call, 20, 3, per_event=20)
        chain_ms = cuda_ms(lambda: band_integrate_reference(*f, w, d), 20, 3,
                           per_event=20)
        in_order_ms = cuda_ms(lambda: band_integrate_reference(
            *f, w, d, in_order=True), 3, 1)
        device_ms = profiled_kernel_ms(call, "band_integrate_kernel")
        bound, by = band_integrate_bound_ms(dtype, R, S, B, Y, B)
        out.update({key + "ms": ms, key + "chain_ms": chain_ms,
                    key + "plain_ms": in_order_ms,
                    key + "device_ms": device_ms, key + "bound_ms": bound,
                    key + "bound_by": by, key + "rows": R})
        log(f"band_integrate {name} {label} [{R} rows x {S}]: kernel "
            f"{ms:.4f} ms back to back, {device_ms:.4f} ms on the device "
            f"(profiler); the chain it replaces (ordered_sum, 15 launches) "
            f"{chain_ms:.4f} ms; the in-order reference {in_order_ms:.3f} "
            f"ms; bound {bound:.4f} ms by {by}")
    return out


def adjust_inputs(dtype, P, seed, L=L_FLAG):
    """Columns of the convective adjustment at the flagship depth (P of
    them, or a planet's with P None): blocks of layers steeper and flatter
    than the adiabat over p 1e9..1e-1, narrow stable gaps and inversions,
    fluxes near the fudge factors' balance.  Returns (T_lay, the keyword
    arguments of convective_adjustment but T, rounds and members)."""
    from helios_tpu_torch import constants as pc
    rng = np.random.default_rng(seed)
    n = P or 1
    p_int = np.logspace(9, -1, L + 1)[:, None] * np.ones((1, n))
    p_lay = np.sqrt(p_int[:-1] * p_int[1:])
    slope = np.empty((L, n))
    for q in range(n):
        i = 0
        while i < L:
            k = int(rng.integers(1, 12))
            slope[i:i + k, q] = rng.choice([-0.05, 0.05, 0.2, 0.3, 0.4],
                                           p=[0.1, 0.15, 0.15, 0.3, 0.3])
            i += k
    T = np.empty((L + 1, n))
    T[L - 1] = 300.0
    for i in range(L - 2, -1, -1):
        T[i] = T[i + 1] * (p_lay[i] / p_lay[i + 1]) ** slope[i]
    T[L] = T[0] * rng.uniform(0.98, 1.06, n)
    F_intern = pc.SIGMA_SB * 500.0 ** 4
    F_down = rng.uniform(1e8, 2e8, (L + 1, n))
    kappa = np.full((L + 1, n), 0.25)
    arrays = dict(
        p_lay=p_lay, p_int=p_int, kappa_lay=kappa[:L], kappa_int=kappa,
        c_p_lay=pc.R_UNIV / kappa[:L],
        meanmolmass_lay=2.3 * pc.AMU * (1 + rng.uniform(0, 0.01, (L, n))),
        F_add_heat_sum=rng.uniform(0, 1e3, (L, n)),
        F_smooth_sum=rng.uniform(-1e3, 1e3, (L, n)), F_down_tot=F_down,
        F_up_tot=F_down * rng.uniform(0.993, 1.007, (L + 1, n)) + F_intern)
    t = lambda a: torch.tensor(a if P else a[:, 0], dtype=dtype,
                               device=DEVICE).contiguous()
    kw = {k: t(v) for k, v in arrays.items()}
    kw.update(iter_value=10, T_star=5000.0, input_dampara="automatic",
              F_intern=F_intern)
    return t(T), kw


def adjust_case(dtype):
    """The convective adjustment's kernel against the chain of ops it
    replaces (convect.plain_adjustment, its sums through ordered_sum) at
    graphs.ROUNDS rounds, bit for bit (T, marks, rounds needed, flag), at
    the flagship depth for a planet and for an ENSEMBLE_P-planet batch;
    times the kernel and the chain back to back and each replayed as a
    CUDA graph (as the loops run them), the kernel's device time
    (profiler), the chain's device time and its launches."""
    from torch.profiler import ProfilerActivity, profile

    from helios_tpu_torch.rce import convect
    from helios_tpu_torch.rce.graphs import ROUNDS
    name = str(dtype).split(".")[-1]
    out = {}
    for key, P in (("", None), ("ensemble_", ENSEMBLE_P)):
        T, kw = adjust_inputs(dtype, P, seed=30)
        members = torch.ones(T.shape[1:], dtype=torch.bool, device=DEVICE)
        run = lambda fn: fn(T, kw["p_lay"], kw["p_int"], kw["kappa_lay"],
                            kw["kappa_int"], kw["c_p_lay"],
                            kw["meanmolmass_lay"], members=members,
                            rounds=ROUNDS, **{k: v for k, v in kw.items()
                                              if k not in ADJUST_COLUMNS})
        kernel = lambda: run(convect.convective_adjustment)
        chain = lambda: run(convect.plain_adjustment)
        got, want = kernel(), chain()
        torch.cuda.synchronize()
        off = [k for k, (g, w) in enumerate(zip(got, want))
               if not torch.equal(g, w)]
        check(not off, f"conv_adjust {name} P={P}: outputs {off} not bit for "
              "bit the chain's")
        graphed = {}
        for label, fn in (("kernel", kernel), ("chain", chain)):
            g = torch.cuda.CUDAGraph()
            fn()
            with torch.cuda.graph(g):
                fn()
            graphed[label] = cuda_ms(g.replay, 20, 3, per_event=20)
            del g
        ms = cuda_ms(kernel, 20, 3, per_event=20)
        chain_ms = cuda_ms(chain, 10, 2, per_event=5)
        device_ms = profiled_kernel_ms(kernel, "conv_adjust_kernel")
        chain()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chain()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        chain_device_ms = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
            for e in events) / 1e3
        chain_launches = sum(e.count for e in events)
        out.update({key + "ms": ms, key + "device_ms": device_ms,
                    key + "graphed_ms": graphed["kernel"],
                    key + "chain_ms": chain_ms,
                    key + "chain_graphed_ms": graphed["chain"],
                    key + "chain_device_ms": chain_device_ms,
                    key + "chain_launches": chain_launches,
                    key + "rounds_needed": int(got[2]),
                    key + "columns": P or 1})
        log(f"conv_adjust {name} [{L_FLAG + 1} x {P or 1}], {ROUNDS} rounds "
            f"({int(got[2])} needed): bit for bit the chain; kernel "
            f"{ms:.4f} ms back to back, {graphed['kernel']:.4f} ms as a "
            f"graph, {device_ms:.4f} ms on the device (profiler); the chain "
            f"it replaces {chain_ms:.4f} ms back to back, "
            f"{graphed['chain']:.4f} ms as a graph, {chain_device_ms:.4f} ms "
            f"on the device in {chain_launches} device operations")
    return out


# the per-layer arrays of convective_adjustment, in its argument order
ADJUST_COLUMNS = ("p_lay", "p_int", "kappa_lay", "kappa_int", "c_p_lay",
                  "meanmolmass_lay")


def host_us(fn, n=1000, batch=100):
    """The host time of one fn() in microseconds: time.perf_counter_ns
    over n calls in batches of ``batch`` with no sync inside a batch (the
    card drains between batches, so a full launch queue never blocks the
    host), the median batch."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(n // batch):
        t = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        per_call.append((time.perf_counter_ns() - t) / batch / 1e3)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def launch_breakdown():
    """Where a kernel wrapper's host time goes, step by step, at the Gauss
    sum's shape ([L+1, nbin, ny] fp64 summed over ny, the most frequent
    launch of the loops): the whole ordered_sum call and torch.sum beside
    it, then each step of the launch path alone, and the steps the path
    no longer takes (host_us, microseconds)."""
    import math
    from helios_tpu_torch.kernels import _launch
    from helios_tpu_torch.kernels.ordered import ordered_sum
    x = ordered_inputs(torch.float64, (L_FLAG + 1, NBIN_FLAG, NY_FLAG), 10)
    dev, shape = x.device, x.shape[:-1]
    out = x.new_empty(shape)
    O, K, I = math.prod(shape), NY_FLAG, 1
    lib = _launch._library("ordered_sum", 2, 4)
    fn = _launch.entry("ordered_sum", x.dtype, 2, 4)
    px, po = x.data_ptr(), out.data_ptr()
    stream = torch.cuda.current_stream(dev.index).cuda_stream

    def shape_arithmetic():
        d = -1 % len(x.shape)
        I = math.prod(x.shape[d + 1:])
        return _launch.check_count("O*K*I", x.numel()) // (x.shape[d] * I)

    def switch():
        with torch.cuda.device(dev):
            pass

    many = [x] * 14
    steps = {
        "ordered_sum(x, -1)": lambda: ordered_sum(x, -1),
        "torch.sum(x, -1)": lambda: torch.sum(x, -1),
        # the launch path, step by step
        "argument test (isinstance, dim, numel)": lambda: (
            isinstance(x, torch.Tensor) and x.dim() and x.numel()),
        "x.contiguous()": x.contiguous,
        "shape arithmetic and check_count": shape_arithmetic,
        "x.new_empty": lambda: x.new_empty(shape),
        "is_cuda and the entry point": lambda: (
            x.is_cuda and _launch.entry("ordered_sum", x.dtype, 2, 4)),
        "get_device() against current_device()": lambda: (
            x.get_device() != torch.cuda.current_device()),
        "current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(dev.index).cuda_stream,
        "two data_ptr()": lambda: (x.data_ptr(), out.data_ptr()),
        "ctypes call (launches)": lambda: fn(px, po, O, K, I, 0, stream),
        "ctypes call of one int, no launch":
            lambda: lib.helios_cuda_error_string(0),
        "_launch.launch (launches)": lambda: _launch.launch(
            "ordered_sum", (x, out), (O, K, I, 0)),
        "check_tensors of 14 tensors (a sweep's)": lambda: (
            _launch.check_tensors(many, [shape + (NY_FLAG,)] * 14)),
        # what the path no longer does
        "torch.empty(shape, dtype=, device=)": lambda: torch.empty(
            shape, dtype=x.dtype, device=dev),
        "with torch.cuda.device(dev)": switch,
        "current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        steps["torch._C._cuda_getCurrentRawStream (private)"] = (
            lambda: raw(dev.index))
    res = {name: host_us(f) for name, f in steps.items()}
    log("host time per call at the Gauss sum [106, 385, 20] fp64, "
        "microseconds (median of 10 batches of 100 calls, no sync inside "
        "a batch): " + "; ".join(f"{k} {v:.2f}" for k, v in res.items()))
    return res


# --------------------------------------------------------------------------- #
# the host tools: the ktable library, built with g++ on this machine
# --------------------------------------------------------------------------- #

HK_STEP_CM = 0.01             # HELIOS-K's default wavenumber step [cm^-1]
KTABLE_GRID = (0.244e-4, 500e-4, 50.0)   # the flagship grid: 385 bins, R 50
HK_TEMPS = np.arange(100.0, 3100.0, 100.0)          # a HELIOS-K T grid
HK_PRESS = 10.0 ** np.arange(0.0, 9.5, 0.5)         # and P grid [ubar]


def cpu_model():
    """The host CPU as lscpu names it: vendor, model name, family and
    model numbers, and the architecture."""
    import platform
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60).stdout
    keys = ("Vendor ID", "Model name", "CPU family", "Model")
    fields = [" ".join(ln.split()) for ln in out.splitlines()
              if ln.split(":", 1)[0].strip() in keys]
    return f"{'; '.join(fields) or 'not reported'} ({platform.machine()})"


def host_tools_phase():
    """The port's native ktable library (ktable/native/kdistr.cpp) built by
    g++ on this machine, each of its two functions held against the numpy
    version at rtol 1e-12 at full width, with both times on this host's
    CPU: kdistr_native on one (T, P) point of a synthetic line list at
    HELIOS-K's 0.01 cm^-1 step over the flagship grid's 0.244-500 um (4.1
    million points into 385 bins x 20 Gauss points), bilinear_tp_native
    regridding a [30 T, 19 P, 385, 20] table onto the final grid of
    combine.final_pt_grid.  The HDF5 files of the tools need h5py, which
    this phase does not."""
    from helios_tpu_torch.io.opacity import gauss_legendre_ypoints
    from helios_tpu_torch.ktable import build as kb
    from helios_tpu_torch.ktable import combine as kc
    from helios_tpu_torch.ktable import native

    cached = native.library_path().exists()
    t = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t
    lam_int = kb.gen_fixed_res_grid(*KTABLE_GRID)
    dlam, (y, _) = np.diff(lam_int), gauss_legendre_ypoints(NY_FLAG)
    nu = np.arange(1.0 / lam_int[-1], 1.0 / lam_int[0], HK_STEP_CM)
    lam_hk = np.sort(1.0 / nu)
    rng = np.random.default_rng(21)
    opac = 10.0 ** (rng.uniform(-8.0, 2.0, len(nu))
                    + 2.0 * np.sin(nu / 37.0))

    def timed(fn):
        t = time.perf_counter()
        return fn(), time.perf_counter() - t

    got, native_s = timed(lambda: native.kdistr_native(
        lam_hk, opac, lam_int, dlam, y))
    want, numpy_s = timed(lambda: kb.kdistribution_for_one_TP(
        lam_hk, opac, lam_int, dlam, y, use_native=False))
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(got.shape == (len(dlam) * NY_FLAG,) and np.all(np.isfinite(got))
          and rel <= 1e-12,
          f"host tools: kdistr_native {rel:.3e} off numpy (limit 1e-12)")

    temps, press = kc.final_pt_grid()
    values = 10.0 ** rng.uniform(-6.0, 1.0, (len(HK_TEMPS), len(HK_PRESS),
                                             len(dlam), NY_FLAG))
    args = (values, HK_TEMPS, HK_PRESS, temps, press)
    grid, bil_native_s = timed(lambda: native.bilinear_tp_native(*args))
    grid_np, bil_numpy_s = timed(lambda: kc.interpolate_tp_grid(
        *args, use_native=False))
    bil_rel = float(np.max(np.abs(grid - grid_np) / np.abs(grid_np)))
    check(grid.shape == (len(temps), len(press), len(dlam), NY_FLAG)
          and bil_rel <= 1e-12,
          f"host tools: bilinear_tp_native {bil_rel:.3e} off numpy (limit "
          "1e-12)")
    log(f"host tools [host CPU times on this machine: {cpu_model()}, "
        f"{os.cpu_count()} cores; card {nvidia_smi_line()}]: kdistr.cpp "
        f"{'found built' if cached else 'built by g++'} in {build_s:.2f} "
        f"s; "
        f"kdistr_native, one (T, P) point of {len(nu)} line-list points "
        f"into {len(dlam)} bins x {NY_FLAG}: {native_s:.3f} s against "
        f"numpy's {numpy_s:.3f} s, max rel difference {rel:.3e} (limit "
        f"1e-12); bilinear_tp_native {list(values.shape)} onto "
        f"{list(grid.shape)}: {bil_native_s:.3f} s against numpy's "
        f"{bil_numpy_s:.3f} s, max rel difference {bil_rel:.3e} (limit "
        f"1e-12)")
    return dict(build_s=build_s, points=len(nu), kdistr_native_s=native_s,
                kdistr_numpy_s=numpy_s, kdistr_rel=rel,
                bilinear_native_s=bil_native_s,
                bilinear_numpy_s=bil_numpy_s, bilinear_rel=bil_rel,
                cpu=cpu_model())


def chained_case(dtype):
    """The chained-pass identity of both sweeps at the flagship shape: one
    call of n passes equals n single-pass calls, each fed the previous
    call's F_up (and Fc_up), bit for bit, for n = 7 and PP_PASSES."""
    from helios_tpu_torch.kernels.sweep import iso_sweep, noniso_sweep
    name = str(dtype).split(".")[-1]
    res = {}
    for fn, args, n_state in ((iso_sweep, iso_inputs(dtype), 1),
                              (noniso_sweep, sweep_inputs(dtype), 2)):
        fixed = args[:len(args) - n_state]
        for n in (7, PP_PASSES):
            whole = fn(*args, n_passes=n)
            state = args[len(args) - n_state:]
            for _ in range(n):
                out = fn(*fixed, *state, n_passes=1)
                state = out[1::2]       # F_up (and Fc_up)
            torch.cuda.synchronize()
            same = all(torch.equal(w, o) for w, o in zip(whole, out))
            diff = max(float((w - o).abs().max()) for w, o in zip(whole, out))
            check(same, f"{fn.__name__} {name}: {n} passes in one call differ "
                  f"from {n} single-pass calls by up to {diff:.3e}")
            res.setdefault(fn.__name__, {})[n] = same
    log(f"chained passes, {name}, flagship shape: one call of n passes "
        f"equals n single-pass calls bit for bit, n in (7, {PP_PASSES}): "
        f"{res}")
    return res


def ro_inputs(dtype, seed=2, C=L_FLAG * NBIN_FLAG, ny=NY_FLAG):
    """C = 105 x 385 cells (an ensemble's P times as many) of two
    ascending ny-point k-distributions (20 Gauss points); every 7th cell
    has exact ties (new == mixed), every 7th (offset 1) a negligible
    overlap."""
    from helios_tpu_torch.io.opacity import gauss_legendre_ypoints
    rng = np.random.default_rng(seed)
    m = np.sort(10.0 ** rng.uniform(-4, 1, (C, ny)), axis=1)
    n = np.sort(10.0 ** rng.uniform(-3, 0.5, (C, ny)), axis=1)
    n[::7] = m[::7]
    n[1::7] *= 1e-7
    y, w = gauss_legendre_ypoints(ny)
    return [torch.tensor(np.asarray(x), device=DEVICE).to(dtype)
            for x in (m, n, w, y)]


def ro_bound_ms(dtype, C, ny, n_negligible, bandwidth=HBM_BYTES_PER_S):
    """(bound ms, what sets it): mixed, new read and out written once,
    3 C ny values; per cell of this run's data, ny additions where the
    overlap is negligible, else the ny^2 sums, a merge of ny sorted runs
    (ny^2 log2 ny comparisons), ny^2 weight products, ny^2 scan additions
    and ny^2 half-weight subtractions."""
    size = torch.empty((), dtype=dtype).element_size()
    bytes_ms = 3 * C * ny * size / bandwidth * 1e3
    ops = ((C - n_negligible) * ny * ny * (4 + np.log2(ny))
           + n_negligible * ny)
    ops_ms = ops / PEAK_FLOPS[dtype] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def row_mismatches(got, want):
    """(rows of ``got`` not bit for bit equal to ``want``'s, NaN equal to
    NaN; the largest absolute difference where both are finite)."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    both = torch.isfinite(got) & torch.isfinite(want)
    diff = float((got - want)[both].abs().max()) if bool(both.any()) else 0.0
    return int((~same.all(dim=1)).sum()), diff


def ro_case(dtype, bandwidth, C=L_FLAG * NBIN_FLAG):
    from helios_tpu_torch.kernels.ro import (ro_general_cells, ro_mix,
                                             ro_mix_occupancy,
                                             ro_mix_reference)
    from helios_tpu_torch.ops.mixing import negligible_overlap
    name = str(dtype).split(".")[-1]
    args = ro_inputs(dtype, C=C)
    C, ny = args[0].shape
    neg = int(negligible_overlap(args[0], args[1]).sum())
    general = int(ro_general_cells(*args).sum())
    got = ro_mix(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"ro_mix {name}: non-finite")
    want = ro_mix_reference(*args)
    bad, ab = row_mismatches(got, want)
    rel, _ = max_errors([got], [want])
    check(bad == 0, f"ro_mix {name}: {bad} cells differ from the plain "
          f"version (max abs {ab:.3e}); it must match bit for bit")
    r = dict(C=C, ny=ny, negligible_cells=neg, general_cells=general,
             max_rel_err=rel, max_abs_err=ab,
             ms=cuda_ms(lambda: ro_mix(*args), 10, 3, per_event=10),
             plain_ms=cuda_ms(lambda: ro_mix_reference(*args), 5, 1))
    r["bound_ms"], r["bound_by"] = ro_bound_ms(dtype, C, ny, neg)
    r["bound_ms_measured_bw"] = ro_bound_ms(dtype, C, ny, neg, bandwidth)[0]
    occ = ro_mix_occupancy(dtype, ny)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r.update(occ, waves=-(-C // occ["threads"]) / (occ["blocks_per_sm"] * sms))
    log(f"ro_mix {name} [{C} cells x {ny}, {neg} negligible, {general} in "
        f"the general branch]: blocks of {occ['threads']} cells, "
        f"{occ['smem_bytes']} B of shared memory, {occ['blocks_per_sm']} "
        f"blocks per SM, {r['waves']:.2f} waves on {sms} SMs; bit for bit "
        f"with the plain version (max rel "
        f"err {rel:.3e}, max abs err {ab:.3e}); kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms; bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
        f"{r['bound_ms_measured_bw']:.4f} ms at the measured "
        f"{bandwidth / 1e12:.3f} TB/s; library: none (torch.sort alone does "
        "not compute the function)")
    return r


# ny above which the previous design's launch-wide weight bound failed for
# Gauss-Legendre weights in fp32 (every live cell went general)
RO_WIDE_NY = (87, 100, 126)


def old_stream_bound_ok(gauss_weight):
    """The previous design's launch-wide check on the weights (before the
    check at each position of the stream): the least weight product
    fl(hmin^2) at least twice the smallest normal and 4 eps fl(hsum^2)."""
    h = (0.5 * gauss_weight).cpu().numpy()
    dt, info = h.dtype.type, np.finfo(h.dtype)
    pmin = dt(h.min() * h.min())
    hsum = dt(0)
    for x in h:
        hsum = dt(hsum + x)
    return bool(pmin >= 2 * info.tiny
                and pmin >= dt(4 * info.epsneg) * dt(hsum * hsum))


def ro_wide_ny_case(C=2000):
    """ro_mix in fp32 at RO_WIDE_NY on ro_inputs' cells (C + ny of them):
    bit for bit with the plain version, the cells of the general branch
    (ro_general_cells) against the previous design's (every live cell,
    where its launch-wide bound failed), and the kernel's time."""
    from helios_tpu_torch.kernels.ro import (ro_general_cells, ro_mix,
                                             ro_mix_reference)
    from helios_tpu_torch.ops.mixing import negligible_overlap
    res = {}
    for ny in RO_WIDE_NY:
        args = ro_inputs(torch.float32, C=C + ny, ny=ny)
        got = ro_mix(*args)
        torch.cuda.synchronize()
        bad, ab = row_mismatches(got, ro_mix_reference(*args))
        check(bad == 0, f"ro_mix fp32 ny={ny}: {bad} cells differ from the "
              f"plain version (max abs {ab:.3e})")
        live = int((~negligible_overlap(args[0], args[1])).sum())
        general = int(ro_general_cells(*args).sum())
        before = 0 if old_stream_bound_ok(args[2]) else live
        ms = cuda_ms(lambda: ro_mix(*args), 5, 2, per_event=3)
        res[ny] = dict(cells=C + ny, live=live, general_cells=general,
                       general_cells_before=before, ms=ms)
        log(f"ro_mix fp32 ny={ny} [{C + ny} cells, {live} live]: bit for bit "
            f"with the plain version; {general} cells in the general branch "
            f"(the previous design's launch-wide bound: {before}); kernel "
            f"{ms:.4f} ms")
    return res


# ny of the ragged Random Overlap checks: small and odd counts, powers of
# two and one past them, and the largest the kernel takes
RO_RAGGED_NY = (2, 3, 4, 5, 16, 17, 20, 32, 33, 64, 126)


def ro_ragged_inputs(dtype, ny, C, seed):
    """[C, ny] cells of every kind the kernel's branches meet: ascending
    random cells, exact ties (new == mixed), gray cells (all sums tie),
    ties across rows among unequal weights, unsorted new (the general
    branch), unsorted mixed (still the stream), an infinite entry (the
    general branch), negligible overlap and a +0 sum tied with a later -0
    sum; C is not a multiple of the kernel's block."""
    from helios_tpu_torch.io.opacity import gauss_legendre_ypoints
    rng = np.random.default_rng(seed)
    m = np.sort(10.0 ** rng.uniform(-4, 1, (C, ny)), axis=1)
    n = np.sort(10.0 ** rng.uniform(-3, 0.5, (C, ny)), axis=1)
    n[0::9] = m[0::9]
    m[1::9], n[1::9] = 0.3, 0.05
    m[2::9] = 0.5 * np.arange(ny) + 1.0
    n[2::9] = 1.0 * np.arange(ny) + 2.0
    n[3::9] = rng.permuted(n[3::9], axis=1)
    m[4::9] = rng.permuted(m[4::9], axis=1)
    n[5::9, -1] = np.inf
    n[6::9] *= 1e-7
    m[7::9, :2] = [0.0, -0.0]              # +0 and -0 sums tie
    n[7::9, 0] = -0.0
    y, w = gauss_legendre_ypoints(ny)
    return [torch.tensor(np.asarray(x), device=DEVICE).to(dtype)
            for x in (m, n, w, y)]


def ro_ragged_case(dtype):
    """ro_mix bit for bit against its plain version at every ny of
    RO_RAGGED_NY on ro_ragged_inputs (C = 1000 + ny), and at ny = 20 also
    with the last Gauss node past the last yg, with a weight far below the
    others (the stream takes it), with a zero weight (every live cell
    general), an all-negligible batch and a single cell."""
    from helios_tpu_torch.kernels.ro import (ro_general_cells, ro_mix,
                                             ro_mix_reference)
    from helios_tpu_torch.ops.mixing import negligible_overlap
    name = str(dtype).split(".")[-1]
    runs = [(f"ny={ny}", ro_ragged_inputs(dtype, ny, 1000 + ny, ny))
            for ny in RO_RAGGED_NY]
    m, n, w, y = ro_ragged_inputs(dtype, 20, 1020, 20)
    past_end, tiny, zero = y.clone(), w.clone(), w.clone()
    past_end[-1] = 1 - 1e-7
    tiny[0] = 1e-30
    zero[0] = 0.0
    quiet_m = torch.where(m == 0, torch.ones_like(m), m)
    quiet_n = torch.where(torch.isfinite(n), n, torch.ones_like(n)) * 1e-9
    runs += [("ny=20, node past the last yg", [m, n, w, past_end]),
             ("ny=20, tiny weight", [m, n, tiny, y]),
             ("ny=20, zero weight", [m, n, zero, y]),
             ("ny=20, all negligible", [quiet_m, quiet_n, w, y]),
             ("ny=20, one cell", [m[:1], n[:1], w, y])]
    general = 0
    for label, args in runs:
        got = ro_mix(*args)
        torch.cuda.synchronize()
        bad, ab = row_mismatches(got, ro_mix_reference(*args))
        check(bad == 0, f"ro_mix {name} {label}: {bad} cells differ from "
              f"the plain version (max abs {ab:.3e})")
        general += int(ro_general_cells(*args).sum())
    neg = negligible_overlap(quiet_m, quiet_n)
    check(bool(neg.all()), "ro_mix all-negligible batch is not")
    log(f"ro_mix {name} ragged: bit for bit with the plain version in "
        f"{len(runs)} batches (ny in {RO_RAGGED_NY}, C = 1000 + ny; at ny = "
        f"20 a node past the last yg, a tiny and a zero weight, all "
        f"negligible, one cell); {general} cells in the general branch")
    return dict(batches=len(runs), bitwise=True, general_cells=general)


# --------------------------------------------------------------------------- #
# phase 4: the paths
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


def flagship(tmpdir, **extra):
    """The flagship workload: an irradiated hot Jupiter with a thick
    interior, started from a super-adiabatic deep profile so that the run
    goes through both the radiation and the convection loop.  ``extra``
    config fields change it (the flux method)."""
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
    cfg = HeliosConfig(**dict(kw, **extra), force_start_tp_from_file="yes",
                       temp_format="helios", temp_path=path).finalize()
    check(cfg.nlayer == L_FLAG, f"flagship has {cfg.nlayer} layers")
    return cfg, table


# path a's loop statistics and its per-iteration run, for the summary
MAIN_PATH = {}


def main_path(launch_counts):
    """Path a: the flagship through pipeline.run, its loops as replayed
    CUDA graphs (the launches counted); then the same run through the
    per-iteration loop (graphs.PER_ITERATION), which it must equal bit for
    bit (final T, both counts, the TOA spectrum); one forward solve on the
    card against the CPU."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.forward import ModelArrays, forward_fluxes
    from helios_tpu_torch.rce import graphs

    with tempfile.TemporaryDirectory() as tmpdir:
        cfg, table = flagship(tmpdir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = pipeline.run(cfg, table, write_output=False, device=DEVICE)
        launch_counts.update(read_counts())
        stats = loop_line("main path", out)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with graphs.loops(graphs.PER_ITERATION) as per_loops:
            per = pipeline.run(cfg, table, write_output=False, device=DEVICE)
        per_counts = read_counts()
        per_peak = torch.cuda.max_memory_allocated() / 2**20
        T_start = pipeline.initial_temperatures(cfg, out.phys, out.arrays)

    rad, conv = out.rad, out.conv
    T = out.T_lay.cpu().numpy()
    check(np.all(np.isfinite(T)), "main path: non-finite temperatures")
    check(conv is not None and conv.steps > 0,
          "main path: the convection loop did not run")
    converged = (not bool(rad.keep_running) and not conv.keep_running
                 and not rad.aborted and not conv.aborted)
    check(converged, "main path: the run did not converge")
    # the adjustment's kernel: one launch per bounded adjustment (every
    # graphed convection iteration, past the stop too), one per read of an
    # unbounded one (the per-iteration loop, a redone chunk)
    per_stats = {k: st.as_dict() for k, st in per_loops.stats.items()}
    check(per_stats["convection"]["adjust_reads"] > 0,
          "main path, per-iteration loop: no adjustment read")
    check(out.n_flux_solves > 0
          and launch_counts == only(
              noniso_sweep=out.n_flux_solves, idle=launch_counts["idle"],
              conv_adjust=adjust_count("main path", stats)),
          f"main path: launches {launch_counts} for {out.n_flux_solves} "
          "flux solves")
    check(all(st is not None and st["graphs"] > 0 and st["replays"] > 0
              for st in stats.values()),
          f"main path: a loop ran without replayed graphs: {stats}")
    toa = out.totals.F_up_band[-1]
    same = (np.array_equal(T, per.T_lay.cpu().numpy())
            and (rad.it, conv.it, conv.steps)
            == (per.rad.it, per.conv.it, per.conv.steps)
            and torch.equal(toa, per.totals.F_up_band[-1]))
    check(same, f"main path: the graphed run ({rad.it} + {conv.it}) is not "
          f"bit for bit the per-iteration run ({per.rad.it} + "
          f"{per.conv.it}): max |dT| "
          f"{np.abs(T - per.T_lay.cpu().numpy()).max():.3e} K")
    check(per_counts == only(
              noniso_sweep=per.n_flux_solves,
              conv_adjust=adjust_count("main path, per-iteration loop",
                                       per_stats)),
          f"main path, per-iteration loop: launches {per_counts} for "
          f"{per.n_flux_solves} flux solves")
    log(f"main path: flagship RCE run [{L_FLAG} layers x {NBIN_FLAG} bins x "
        f"{NY_FLAG} y, fp64] converged: {rad.it} radiation + {conv.it} "
        f"convection iterations ({conv.steps} convection steps), "
        f"{out.n_flux_solves} flux solves + "
        f"{launch_counts['idle']['noniso_sweep']} idle iterations = "
        f"{launch_counts['noniso_sweep']} noniso_sweep launches; "
        f"{launch_counts['conv_adjust']} conv_adjust launches (the "
        f"per-iteration loop: {per_counts['conv_adjust']} for "
        f"{per.conv.steps} adjustments)")
    for name, o, peak in (
            ("graphed", out, None), ("per-iteration", per, per_peak)):
        log(f"main path, {name} loops: wall {o.wall_seconds:.3f} s "
            f"(radiation loop {o.rad_seconds:.3f} s = "
            f"{o.rad.it / o.rad_seconds:.1f} it/s, convection loop "
            f"{o.conv_seconds:.3f} s = {o.conv.steps / o.conv_seconds:.1f} "
            f"it/s)" + (f"; peak device memory {peak:.0f} MiB"
                        if peak is not None else ""))
    log(f"main path: the graphed run bit for bit the per-iteration run "
        f"(final T, {rad.it} + {conv.it} iterations, the TOA spectrum); T "
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
    MAIN_PATH.update(stats=stats, per_iteration=per)
    return out, T_start


def profiled_window(run, n, kernels, label, loops):
    """Where the iterations of ``run()`` (n of them) go: host wall per
    iteration, unprofiled, after one warm run (which captures the graphs
    of the window's keys), against the device's busy time and kernels per
    iteration and each named kernel's share (torch.profiler, CUDA
    kernels); the device reads per iteration of the loops of ``loops``
    (the graphs.loops block the runs use)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    reads_of = lambda: sum(st.reads for st in loops.stats.values())
    before = reads_of()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n
    reads = reads_of() - before
    for _ in range(3):      # again while a trace lost a kernel's events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        device_us, count = 0.0, 0
        kernel_us = dict.fromkeys(kernels, 0.0)
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            device_us += us
            count += e.count
            for k in kernels:
                if f"{k}_kernel" in e.key:
                    kernel_us[k] += us
        if all(kernel_us.values()):
            break
    for k, us in kernel_us.items():
        check(us > 0, f"{label}: the profiler saw no {k} in 3 traces")
    busy_ms = device_us / 1e3 / n
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=count / n,
                kernel_ms={k: us / 1e3 / n for k, us in kernel_us.items()},
                kernel_us=kernel_us, device_us=device_us,
                reads_per_iteration=reads / n if reads else None)


def breakdown_line(label, what, res, n):
    shares = "; ".join(
        f"{k} {us / 1e3 / n:.3f} ms ({100 * us / res['device_us']:.1f}% of "
        "device time)" for k, us in res["kernel_us"].items())
    reads = res["reads_per_iteration"]
    log(f"time breakdown, {label} {what}: wall {res['wall_ms']:.3f} ms; "
        f"device busy {res['busy_ms']:.3f} ms "
        f"({100 * res['busy_ms'] / res['wall_ms']:.1f}% of wall, idle "
        f"{100 * (1 - res['busy_ms'] / res['wall_ms']):.1f}%) in "
        f"{res['kernels']:.0f} kernels"
        + (f"; {reads:.3f} device reads per iteration" if reads else "")
        + (f"; {shares}" if shares else ""))


def time_breakdown(label, phys, arrays, T0, kernels, n=20, sset=None,
                   thermo=None, per_iteration=False):
    """Where a radiation iteration's time goes (profiled_window), over
    iterations 10..10+n of a loop started from T0 (two cell refreshes);
    with ``per_iteration`` through the per-iteration loop.  ``thermo``
    gives a physical timestep its c_p."""
    from helios_tpu_torch.rce import graphs, radiative

    loop = lambda steps, s: radiative.radiation_loop(
        phys, arrays, thermo, T0, max_steps=steps, sset=sset, state0=s)

    def window():
        s1 = loop(n, s)
        check(np.all(s1.it == s.it + n),
              "time breakdown: the radiation loop stopped")

    with graphs.loops(graphs.PER_ITERATION if per_iteration
                      else graphs.Settings()) as loops:
        s = loop(10, radiative.init_rad_state(phys, arrays, T0, sset))
        res = profiled_window(window, n, kernels, label, loops)
    it0 = int(np.max(s.it))
    breakdown_line(label, f"radiation iteration (it {it0}..{it0 + n})", res,
                   n)
    return res


def conv_breakdown(label, out, thermo, kernels, n=20, sset=None,
                   per_iteration=False):
    """Where a convection iteration's time goes (profiled_window), over
    steps 10..10+n of the convection loop entered from the run's final
    radiation state; with ``per_iteration`` through the per-iteration
    loop."""
    from helios_tpu_torch.rce import graphs, loop as conv_loop

    run = lambda steps, s: conv_loop.convection_loop(
        out.phys, out.arrays, thermo, out.rad, max_steps=steps, sset=sset,
        state0=s)

    def window():
        s1 = run(n, s)
        check(s1.steps - s.steps == n,
              "conv breakdown: the convection loop stopped")

    with graphs.loops(graphs.PER_ITERATION if per_iteration
                      else graphs.Settings()) as loops:
        s = run(10, run(0, None))
        res = profiled_window(window, n, kernels, label, loops)
    breakdown_line(label, f"convection iteration (steps {s.steps}.."
                   f"{s.steps + n})", res, n)
    return res


def write_pt_file(path, p_lay, p_int, T):
    """T [L+1] as a "PT" file (pressure in 10^-6 bar, temperature): the
    layers at p_lay and the surface at p_int[0], so that the log-P
    interpolation of load_tp_file gives T back exactly."""
    L = len(p_lay)
    rows = np.column_stack([np.append(p_lay, p_int[0]), T])
    assert rows.shape == (L + 1, 2)
    np.savetxt(path, rows, fmt="%.17g")


def postprocessing_run(T_lay, arrays, cfg_kw, table, launch_counts,
                       sset=None, extra_files=(), starflux=None,
                       inspect=None):
    """The post-processing run of an RCE run's final profile T_lay (on the
    grid of ``arrays``), read back from a "PT" file, with the direct beam
    and the output files (POSTPROC_FILES and ``extra_files``); ``starflux``
    a stellar spectrum in memory, ``inspect(run_dir)`` a check of the files
    before they go.  Returns (output, the files written, peak device memory
    MiB); checks the run's shape, its files and its TOA spectrum."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import HeliosConfig

    T_final = T_lay.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmpdir:
        path = os.path.join(tmpdir, "final_pt.dat")
        write_pt_file(path, arrays.p_lay.cpu().numpy(),
                      arrays.p_int.cpu().numpy(), T_final)
        kw = dict(cfg_kw, run_type="post-processing", iso_input="yes",
                  direct_beam="yes", temp_format="PT", temp_path=path,
                  name="pp", output_dir=tmpdir + "/")
        cfg = HeliosConfig(**kw).finalize()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = pipeline.run(cfg, table, write_output=True, sset=sset,
                           starflux=starflux, device=DEVICE)
        launch_counts.update(read_counts())
        files = sorted(f[len("pp"):] for f in
                       os.listdir(os.path.join(tmpdir, "pp")))
        if inspect is not None:
            inspect(os.path.join(tmpdir, "pp"))
    phys, L = out.phys, out.phys.nlayer
    check(phys.singlewalk == 1 and phys.iso == 1
          and phys.n_sweep_passes == PP_PASSES,
          f"post-processing: singlewalk {phys.singlewalk}, iso {phys.iso}, "
          f"{phys.n_sweep_passes} passes")
    want_files = sorted(POSTPROC_FILES + list(extra_files))
    check(files == want_files, f"post-processing: files {files}, expected "
          f"{want_files}")
    check(np.array_equal(out.T_lay.cpu().numpy(), T_final),
          "post-processing: the PT file did not give the profile back")
    toa = out.totals.F_up_band[L]
    check(bool(torch.isfinite(toa).all()) and bool((toa > 0).all()),
          "post-processing: TOA spectrum not finite and positive")
    return out, files, torch.cuda.max_memory_allocated() / 2**20


def postprocessing_path(flag_out, launch_counts, kernel_ms_1001,
                        cfg_kw=FLAGSHIP, extra_files=(),
                        label="post-processing path"):
    """The post-processing run of the converged flagship profile (of the
    workload ``cfg_kw``), with the direct beam and the output files
    (``extra_files`` besides POSTPROC_FILES): one iso solve of 1001
    passes."""
    from helios_tpu_torch.forward import ModelArrays, forward_fluxes

    out, files, peak_mib = postprocessing_run(
        flag_out.T_lay, flag_out.arrays, cfg_kw, flagship_table(),
        launch_counts, extra_files=extra_files)
    phys, L = out.phys, out.phys.nlayer
    check(launch_counts == only(iso_sweep=1),
          f"{label}: launches {launch_counts}, expected one iso_sweep")
    toa = out.totals.F_up_band[L]
    arrays_cpu = ModelArrays(*(t.cpu() for t in out.arrays))
    t = time.perf_counter()
    cpu = forward_fluxes(phys, arrays_cpu, out.T_lay.cpu())[1]
    cpu_s = time.perf_counter() - t
    rel = float(((toa.cpu() - cpu.F_up_band[L]).abs()
                 / cpu.F_up_band[L].abs()).max())
    check(rel <= 1e-10, f"{label}: TOA spectrum cuda vs cpu {rel:.3e} > "
          "1e-10")
    log(f"{label} [{L} layers x {NBIN_FLAG} bins x {NY_FLAG} "
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
                toa_rel_cpu=rel, cpu_s=cpu_s, toa=toa)


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
    loops = loop_line("iso RCE path")
    check(bool(torch.isfinite(rad.T_lay).all()),
          "iso RCE: non-finite temperatures")
    check(rad.it == ISO_RCE_ITERATIONS or not bool(rad.keep_running),
          f"iso RCE: stopped at {rad.it} iterations")
    check(launch_counts == only(iso_sweep=rad.it,
                                idle=launch_counts["idle"]),
          f"iso RCE: launches {launch_counts} for {rad.it} iterations")
    log(f"iso RCE path [{L_FLAG} layers x {NBIN_FLAG} bins x {NY_FLAG} y, "
        f"fp64, {phys.n_sweep_passes} passes]: {rad.it} radiation "
        f"iterations + {launch_counts['idle']['iso_sweep']} idle = "
        f"{launch_counts['iso_sweep']} iso_sweep launches in "
        f"{wall:.3f} s ({rad.it / wall:.1f} it/s, model build excluded); "
        f"T {float(rad.T_lay.min()):.1f}..{float(rad.T_lay.max()):.1f} K")
    res = time_breakdown("iso RCE", phys, arrays, T0, ("iso_sweep",))
    res.update(it=rad.it, it_per_s=rad.it / wall, loops=loops)
    return res


def forward_cuda_vs_cpu(phys, arrays, T, sset=None, sset_cpu=None):
    """One forward_fluxes on the card and the same call on the CPU; returns
    (launch counts of the card's call, the card's totals, the relative
    difference of each total)."""
    from helios_tpu_torch.forward import ModelArrays, forward_fluxes

    torch.cuda.synchronize()
    reset_counts()
    gpu = forward_fluxes(phys, arrays, T, sset=sset)[1]
    torch.cuda.synchronize()
    counts = read_counts()
    arrays_cpu = ModelArrays(*(t.cpu() for t in arrays))
    cpu = forward_fluxes(phys, arrays_cpu, T.cpu(), sset=sset_cpu)[1]
    rel = {f: ((getattr(gpu, f).cpu() - getattr(cpu, f)).abs()
               / getattr(cpu, f).abs()) for f in ("F_up_tot", "F_down_tot")}
    return counts, gpu, rel


def matrix_path(flag_out, launch_counts):
    """The flagship RCE run of path a with the matrix flux method: one
    Thomas solve and one absorption-fallback non-iso sweep per flux solve.
    Whether it converges is reported, not required (a run that does not
    is a finding for ROADMAP C)."""
    from helios_tpu_torch import pipeline

    with tempfile.TemporaryDirectory() as tmpdir:
        cfg, table = flagship(tmpdir, flux_calc_method="matrix")
        torch.cuda.synchronize()
        reset_counts()
        out = pipeline.run(cfg, table, write_output=False, device=DEVICE)
        launch_counts.update(read_counts())
        stats = loop_line("matrix path", out)
        per = per_iteration_twin("matrix path", lambda: pipeline.run(
            cfg, table, write_output=False, device=DEVICE), out)
    rad, conv, n = out.rad, out.conv, out.n_flux_solves
    T = out.T_lay.cpu().numpy()
    check(out.phys.flux_calc_method == "matrix", "matrix path: not matrix")
    check(np.all(np.isfinite(T)), "matrix path: non-finite temperatures")
    check(n > 0 and launch_counts == only(
              thomas_solve=n, noniso_sweep=n, idle=launch_counts["idle"],
              conv_adjust=adjust_count("matrix path", stats)),
          f"matrix path: launches {launch_counts} for {n} flux solves")
    converged = (not bool(rad.keep_running) and conv is not None
                 and not conv.keep_running and not rad.aborted
                 and not conv.aborted)
    dT = np.abs(T - flag_out.T_lay.cpu().numpy())
    conv_it = conv.it if conv is not None else 0
    conv_steps = conv.steps if conv is not None else 0
    log(f"matrix path: flagship RCE run with flux_calc_method=matrix "
        f"[{L_FLAG} layers x {NBIN_FLAG} bins x {NY_FLAG} y, fp64]: "
        f"{'converged' if converged else 'DID NOT CONVERGE'} after "
        f"{rad.it} radiation + {conv_it} convection iterations "
        f"({conv_steps} convection steps; radiation loop aborted "
        f"{rad.aborted}), {n} flux solves + "
        f"{launch_counts['idle']['thomas_solve']} idle iterations = "
        f"{launch_counts['thomas_solve']} thomas_solve + "
        f"{launch_counts['noniso_sweep']} noniso_sweep launches; wall "
        f"{out.wall_seconds:.3f} s (radiation {out.rad_seconds:.3f} s = "
        f"{rad.it / out.rad_seconds:.1f} it/s, convection "
        f"{out.conv_seconds:.3f} s); T {T.min():.1f}..{T.max():.1f} K, max "
        f"|T - T(path a)| {dT.max():.4f} K")

    counts, _, rel = forward_cuda_vs_cpu(out.phys, out.arrays, out.T_lay)
    check(counts == only(thomas_solve=1, noniso_sweep=1),
          f"matrix forward_fluxes: launches {counts}, expected one "
          "thomas_solve and one noniso_sweep")
    up, down = float(rel["F_up_tot"].max()), float(rel["F_down_tot"].max())
    down_boa = float(rel["F_down_tot"][0])
    down_rest = float(rel["F_down_tot"][1:].max())
    check(max(up, down_rest) <= 1e-10, f"matrix forward_fluxes cuda vs "
          f"cpu: F_up_tot {up:.3e}, F_down_tot above the BOA "
          f"{down_rest:.3e} > 1e-10")
    check(down_boa <= 1e-6, f"matrix forward_fluxes cuda vs cpu: BOA "
          f"F_down_tot {down_boa:.3e} > 1e-6")
    log(f"matrix forward_fluxes at the flagship shape, cuda vs cpu: max rel "
        f"difference F_up_tot {up:.3e}, F_down_tot {down:.3e} (above the "
        f"BOA {down_rest:.3e}, limit 1e-10; at the BOA {down_boa:.3e}, limit "
        f"1e-6: the elimination divides it by the albedo); launches per "
        f"solve {counts}")
    return dict(out=out, converged=converged, rad_it=rad.it, loops=stats,
                per_iteration_wall_s=per.wall_seconds,
                conv_it=conv_it, dT_max=float(dT.max()),
                wall_s=out.wall_seconds, fwd_rel_up=up, fwd_rel_down=down,
                fwd_rel_down_boa=down_boa)


def matrix_postprocessing_path(flag_out, launch_counts, toa_iteration):
    """Path b's post-processing run with the matrix method: one Thomas
    solve (and the single-pass absorption fallback) in place of the 1001
    sweep passes."""
    out, files, peak_mib = postprocessing_run(
        flag_out.T_lay, flag_out.arrays,
        dict(FLAGSHIP, flux_calc_method="matrix"), flagship_table(),
        launch_counts)
    check(launch_counts == only(thomas_solve=1, iso_sweep=1),
          f"matrix post-processing: launches {launch_counts}, expected one "
          "thomas_solve and one iso_sweep")
    L = out.phys.nlayer
    toa = out.totals.F_up_band[L]
    rel = float(((toa - toa_iteration).abs() / toa_iteration.abs()).max())
    log(f"matrix post-processing path [{L} layers x {NBIN_FLAG} bins x "
        f"{NY_FLAG} y, fp64, beam, {THOMAS_ROWS['iso']} matrix rows]: wall "
        f"{out.wall_seconds:.3f} s with {len(files)} output files; "
        f"launches {launch_counts}; peak device memory {peak_mib:.0f} MiB; "
        f"TOA spectrum max rel difference from path b's {PP_PASSES}-pass "
        f"solve {rel:.3e}")
    return dict(wall_s=out.wall_seconds, toa_rel_iteration=rel)


OTF_WORKLOAD = dict(planet="manual", g=2140.0, a=0.03142, R_planet=1.138,
                    R_star=0.805, T_star=5040.0, T_intern=100.0,
                    scattering="yes", direct_beam="no", convection="no",
                    run_type="iterative", iso_input="yes",
                    opacity_mixing="on-the-fly", k_mixing_method="RO")


def otf_inputs(device):
    """The JAX package's on-the-fly workload (bench.py:329-354): the donor
    table and the species set, built in memory, on ``device``."""
    from helios_tpu_torch import chem
    from helios_tpu_torch.io.opacity import synthetic_premixed_table

    donor = synthetic_premixed_table(nbin=NBIN_FLAG, ny=NY_FLAG, ntemp=8,
                                     npress=6, seed=1)
    specs = [chem.SpeciesSpec("H2O", True, False, "1e-3"),
             chem.SpeciesSpec("CO2", True, False, "1e-4"),
             chem.SpeciesSpec("H2", False, True, "0.9"),
             chem.SpeciesSpec("He", False, False, "0.1")]
    sset = chem.build_species_set(
        specs, ktemps=donor.temperatures, kpress=donor.pressures,
        nbin=NBIN_FLAG, ny=NY_FLAG, nlayer=L_FLAG,
        opacity_tables={"H2O": donor.kpoints, "CO2": donor.kpoints * 3.0},
        scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4},
        device=device)
    return donor, sset


def otf_general_cells(runs, sset):
    """(cells of the ro_mix launches that the kernel sends through its
    general branch, cells mixed, launches) over one forward_fluxes of each
    (phys, arrays, T) in ``runs``: every ro_mix launch is seen on its way to
    the card (ro_general_cells launches nothing)."""
    from helios_tpu_torch.forward import forward_fluxes
    from helios_tpu_torch.kernels import _launch
    from helios_tpu_torch.kernels.ro import ro_general_cells

    seen = [0, 0, 0]
    real = _launch.launch

    def seeing(name, tensors, ints):
        if name == "ro_mix":
            general = ro_general_cells(*tensors[:4])
            seen[0] += int(general.sum())
            seen[1] += general.numel()
            seen[2] += 1
        return real(name, tensors, ints)

    _launch.launch = seeing
    try:
        for phys, arrays, T in runs:
            forward_fluxes(phys, arrays, T, sset=sset)
        torch.cuda.synchronize()
    finally:
        _launch.launch = real
    return tuple(seen)


def otf_path(launch_counts, pp_counts):
    """On-the-fly Random Overlap mixing: ISO_RCE_ITERATIONS radiation
    iterations of the JAX package's on-the-fly workload (one ro_mix per
    cell refresh: two absorbers), one non-isothermal forward_fluxes of
    the same species on the card against the CPU, and the post-processing
    run of the final profile with the output files."""
    from helios_tpu_torch.config import HeliosConfig
    from helios_tpu_torch.forward import build_model
    from helios_tpu_torch.rce import graphs, radiative

    donor, sset = otf_inputs(DEVICE)
    phys, arrays = build_model(HeliosConfig(**OTF_WORKLOAD).finalize(),
                               donor, device=DEVICE)
    check(phys.iso == 1 and phys.nlayer == L_FLAG and phys.ro_method == 1
          and phys.opacity_mixing == "on-the-fly",
          "on-the-fly RCE: not the isothermal on-the-fly flagship shape")
    T0 = torch.as_tensor(np.linspace(1800.0, 600.0, phys.nlayer + 1),
                         dtype=torch.float64, device=DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    rad = radiative.radiation_loop(phys, arrays, None, T0,
                                   max_steps=ISO_RCE_ITERATIONS, sset=sset)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launch_counts.update(read_counts())
    otf_loops = loop_line("on-the-fly RCE path")
    with graphs.loops(graphs.PER_ITERATION):
        t = time.perf_counter()
        per = radiative.radiation_loop(phys, arrays, None, T0,
                                       max_steps=ISO_RCE_ITERATIONS,
                                       sset=sset)
        torch.cuda.synchronize()
        per_wall = time.perf_counter() - t
    check(torch.equal(per.T_lay, rad.T_lay) and per.it == rad.it,
          "on-the-fly RCE: the graphed loop is not bit for bit the "
          "per-iteration loop")
    log(f"on-the-fly RCE path: the graphed loop bit for bit the "
        f"per-iteration loop ({rad.it} iterations); {wall:.3f} s against "
        f"{per_wall:.3f} s")
    refreshes = 1 + (rad.it + 9) // 10      # init, then it = 0, 10, ...
    check(bool(torch.isfinite(rad.T_lay).all()),
          "on-the-fly RCE: non-finite temperatures")
    check(rad.it == ISO_RCE_ITERATIONS or not bool(rad.keep_running),
          f"on-the-fly RCE: stopped at {rad.it} iterations")
    check(launch_counts == only(iso_sweep=rad.it, ro_mix=refreshes,
                                idle=launch_counts["idle"]),
          f"on-the-fly RCE: launches {launch_counts} for {rad.it} "
          f"iterations and {refreshes} cell refreshes")
    log(f"on-the-fly RCE path [{L_FLAG} layers x {NBIN_FLAG} bins x "
        f"{NY_FLAG} y, fp64, RO of 2 absorbers]: {rad.it} radiation "
        f"iterations, {refreshes} cell refreshes; launches {launch_counts}; "
        f"{wall:.3f} s ({rad.it / wall:.1f} it/s, model and species build "
        f"excluded); T {float(rad.T_lay.min()):.1f}.."
        f"{float(rad.T_lay.max()):.1f} K")
    res = time_breakdown("on-the-fly RCE", phys, arrays, T0,
                         ("iso_sweep", "ro_mix"), sset=sset)
    res_per = time_breakdown("on-the-fly RCE, per-iteration loop", phys,
                             arrays, T0, ("iso_sweep", "ro_mix"), sset=sset,
                             per_iteration=True)
    res.update(it=rad.it, it_per_s=rad.it / wall, refreshes=refreshes,
               loops=otf_loops, wall_s=wall, per_iteration_wall_s=per_wall,
               per_iteration=res_per)

    # non-isothermal: layers and interfaces are mixed, two ro_mix launches
    phys_n, arrays_n = build_model(
        HeliosConfig(**dict(OTF_WORKLOAD, iso_input="no")).finalize(),
        donor, device=DEVICE)
    counts, _, rel = forward_cuda_vs_cpu(phys_n, arrays_n, rad.T_lay,
                                         sset=sset,
                                         sset_cpu=otf_inputs("cpu")[1])
    check(counts == only(ro_mix=2, noniso_sweep=1),
          f"on-the-fly forward_fluxes: launches {counts}, expected two "
          "ro_mix and one noniso_sweep")
    fwd_rel = max(float(r.max()) for r in rel.values())
    check(fwd_rel <= 1e-10, f"on-the-fly forward_fluxes cuda vs cpu: "
          f"{fwd_rel:.3e} > 1e-10")
    log(f"on-the-fly forward_fluxes, non-isothermal, cuda vs cpu: max rel "
        f"difference of the totals {fwd_rel:.3e} (limit 1e-10); launches "
        f"{counts}")

    out, files, peak_mib = postprocessing_run(rad.T_lay, arrays,
                                              OTF_WORKLOAD, donor, pp_counts,
                                              sset=sset)
    check(pp_counts == only(iso_sweep=1, ro_mix=2),
          f"on-the-fly post-processing: launches {pp_counts}, expected one "
          "iso_sweep and two ro_mix (the solve's and the diagnostics' cell "
          "refresh)")
    log(f"on-the-fly post-processing path: wall {out.wall_seconds:.3f} s "
        f"with {len(files)} output files; launches {pp_counts}; peak device "
        f"memory {peak_mib:.0f} MiB")
    res.update(fwd_rel=fwd_rel, pp_wall_s=out.wall_seconds)

    general, cells, calls = otf_general_cells(
        [(phys, arrays, T0), (phys, arrays, rad.T_lay),
         (phys_n, arrays_n, rad.T_lay)], sset)
    log(f"on-the-fly workload, forward solves at the start and the final "
        f"profile (iso) and the final profile (non-iso): {general} of "
        f"{cells} cells in {calls} ro_mix calls take the kernel's general "
        "branch")
    res.update(general_cells=general, general_cells_of=cells)
    return res


# --------------------------------------------------------------------------- #
# phase 4, BASELINE configs 4 and 5: cloud decks with the geometric zenith
# correction, solid surfaces, additional heating, the physical timestep
# --------------------------------------------------------------------------- #

# the files write_all adds for a run with clouds
CLOUD_FILES = ["_" + n + ".dat" for n in (
    "cloud_mixing_ratio", "cloud_opacities", "cloud_optdepth",
    "cloud_scat_cross_sect")]
ZENITH_DEG = 80.0           # above 70: geom_zenith_corr resolves to 1


def write_mie_dir(path):
    """A synthetic LX-Mie directory over the 51 radii of the clouds
    module's R_VALUES_MICRON (the recipe of tests/test_clouds.py:74-90):
    cross sections ~ r^2 with a Rayleigh-like fall-off."""
    from helios_tpu_torch.clouds import R_VALUES_MICRON
    os.makedirs(path)
    lam_um = np.geomspace(0.3, 30.0, 50)
    zero = np.zeros_like(lam_um)
    for r in R_VALUES_MICRON:
        x = 2 * np.pi * r / lam_um
        rows = np.column_stack([
            lam_um, zero, zero, 1e-8 * r ** 2 * np.minimum(x ** 4, 2.0),
            1e-8 * r ** 2 * np.minimum(x, 1.0), zero,
            np.clip(0.9 * np.minimum(x, 1.0), 0, 1)])
        np.savetxt(os.path.join(path, "r{:.6f}.dat".format(r)), rows,
                   fmt="%.6e", header="lam c2 c3 scat abs c5 g0")
    return path


def cloud_kw(mie_dir):
    """The cloudy flagship's fields over path a's workload: the direct
    beam at ZENITH_DEG and one manual Mie deck from 1 bar up."""
    return dict(direct_beam="yes", zenith_angle_deg=ZENITH_DEG,
                nr_cloud_decks=1, mie_dirs=[mie_dir],
                cloud_radius_mode=[1.0], cloud_radius_geo_std=[1.5],
                cloud_mixing_ratio_source="manual",
                cloud_bottom_pressure=[1e6],
                cloud_bottom_mixing_ratio=[1e-18],
                cloud_to_gas_scale_height=[0.8])


def rce_summary(label, out, launch_counts, kernel, stats):
    """Checks of a converged RCE run (finite T, converged, one ``kernel``
    launch per flux solve, the adjustment's launches its loops' ``stats``
    count) and its log line; returns its numbers."""
    rad, conv = out.rad, out.conv
    T = out.T_lay.cpu().numpy()
    check(np.all(np.isfinite(T)), f"{label}: non-finite temperatures")
    converged = (not bool(rad.keep_running) and not rad.aborted
                 and (conv is None or not (conv.keep_running
                                           or conv.aborted)))
    check(converged, f"{label}: the run did not converge")
    n = out.n_flux_solves
    check(n > 0 and launch_counts == only(
              **{kernel: n}, idle=launch_counts["idle"],
              conv_adjust=adjust_count(label, stats)),
          f"{label}: launches {launch_counts} for {n} flux solves")
    conv_it = conv.it if conv is not None else 0
    conv_steps = conv.steps if conv is not None else 0
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"{label} [{out.phys.nlayer} layers x {NBIN_FLAG} bins x {NY_FLAG} "
        f"y, fp64] converged: {rad.it} radiation + {conv_it} convection "
        f"iterations ({conv_steps} convection steps), {n} flux solves + "
        f"{launch_counts['idle'][kernel]} idle iterations = "
        f"{launch_counts[kernel]} {kernel} launches; wall "
        f"{out.wall_seconds:.3f} s (radiation loop {out.rad_seconds:.3f} s = "
        f"{rad.it / out.rad_seconds:.1f} it/s, convection loop "
        f"{out.conv_seconds:.3f} s); peak device memory {peak:.0f} MiB; T "
        f"{T.min():.1f}..{T.max():.1f} K")
    return dict(rad_it=rad.it, conv_it=conv_it, wall_s=out.wall_seconds,
                rad_it_per_s=rad.it / out.rad_seconds, peak_mib=peak)


def totals_cuda_vs_cpu(label, phys, arrays, T, expected):
    """forward_cuda_vs_cpu with its checks: the ``expected`` launches and
    the totals within 1e-10."""
    counts, _, rel = forward_cuda_vs_cpu(phys, arrays, T)
    check(counts == expected, f"{label} forward_fluxes: launches {counts}, "
          f"expected {expected}")
    worst = max(float(r.max()) for r in rel.values())
    check(worst <= 1e-10, f"{label} forward_fluxes cuda vs cpu: {worst:.3e} "
          "> 1e-10")
    log(f"{label} forward_fluxes, cuda vs cpu: max rel difference of the "
        f"totals {worst:.3e} (limit 1e-10); launches {counts}")
    return worst


def cloudy_path(tmpdir, launch_counts):
    """Path f: the flagship RCE run of path a with the direct beam at
    ZENITH_DEG (the geometric zenith correction) and one Mie cloud deck,
    to convergence; one forward_fluxes on the card against the CPU; and
    where a radiation iteration's time goes."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.rce import radiative

    extra = cloud_kw(write_mie_dir(os.path.join(tmpdir, "mie")))
    cfg, table = flagship(tmpdir, **extra)
    check(cfg.clouds == 1 and cfg.geom_zenith_corr == 1 and cfg.dir_beam == 1,
          "cloudy flagship: clouds, beam or zenith correction off")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = pipeline.run(cfg, table, write_output=False, device=DEVICE)
    launch_counts.update(read_counts())
    loops = loop_line("cloudy path", out)
    res = rce_summary("cloudy path: flagship RCE run with a cloud deck and "
                      f"the zenith-corrected beam at {ZENITH_DEG:.0f} deg",
                      out, launch_counts, "noniso_sweep", loops)
    res["fwd_rel"] = totals_cuda_vs_cpu("cloudy", out.phys, out.arrays,
                                        out.T_lay, only(noniso_sweep=1))
    T0 = torch.as_tensor(pipeline.initial_temperatures(cfg, out.phys,
                                                       out.arrays),
                         dtype=out.T_lay.dtype, device=DEVICE)
    res["breakdown"] = time_breakdown("cloudy flagship", out.phys,
                                      out.arrays, T0, ("noniso_sweep",))
    res["conv_breakdown"] = conv_breakdown(
        "cloudy flagship", out, radiative.make_const_thermo(
            FLAGSHIP["kappa_value"]), ("noniso_sweep",))
    res.update(out=out, cfg_kw=dict(FLAGSHIP, **extra), loops=loops)
    return res


def matrix_ulp_sensitivity(phys, arrays_cpu, T):
    """How far F_down_tot of a matrix-method solve on the CPU moves when M
    of the upper half layers changes by one ulp: the conditioning of the
    unpivoted elimination at this profile (max relative change)."""
    from helios_tpu_torch import forward as tf
    from helios_tpu_torch.ops import interp as interp_ops

    cells = tf.compute_cells(phys, arrays_cpu, T,
                             interp_ops.interface_temperatures(T))
    up = cells.cells_or_upper
    nudged = cells._replace(cells_or_upper=up._replace(
        M=up.M * (1.0 + 2.0 ** -52)))
    tot = [tf.integrate_flux_flat(phys, arrays_cpu, tf.solve_fluxes(
        phys, arrays_cpu, c, T, tf.init_flux_state(phys, T.dtype, T.device)),
        cells.F_dir).F_down_tot for c in (cells, nudged)]
    return float(((tot[1] - tot[0]).abs() / tot[0].abs()).max())


def cloudy_matrix_path(cl, launch_counts):
    """Path j: one forward_fluxes of path f's workload with the matrix
    method at albedo 0.3, at path f's final profile, on the card against
    the CPU.  F_up_tot is held to 1e-10.  F_down_tot is held to 1e-10 or
    to ten times the CPU solve's own change under a one-ulp change of M,
    whichever is larger: with clouds, columns whose deep layers are opaque
    (transmission 0, w0 ~ 0) take the matrix, and the unpivoted elimination
    recovers their F_down by dividing by pivots ~ w0 (ROADMAP C)."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import HeliosConfig
    from helios_tpu_torch.forward import ModelArrays

    cfg = HeliosConfig(**dict(cl["cfg_kw"], flux_calc_method="matrix",
                              surf_albedo=0.3)).finalize()
    phys, arrays, _ = pipeline.prepare_model(cfg, flagship_table(),
                                             device=DEVICE)
    T = cl["out"].T_lay
    counts, _, rel = forward_cuda_vs_cpu(phys, arrays, T)
    launch_counts.update(counts)
    check(counts == only(thomas_solve=1, noniso_sweep=1),
          f"cloudy matrix forward_fluxes: launches {counts}, expected one "
          "thomas_solve and one noniso_sweep")
    up, down = float(rel["F_up_tot"].max()), float(rel["F_down_tot"].max())
    sens = matrix_ulp_sensitivity(
        phys, ModelArrays(*(t.cpu() for t in arrays)), T.cpu())
    limit = max(1e-10, 10 * sens)
    check(up <= 1e-10, f"cloudy matrix forward_fluxes cuda vs cpu: F_up_tot "
          f"{up:.3e} > 1e-10")
    check(down <= limit, f"cloudy matrix forward_fluxes cuda vs cpu: "
          f"F_down_tot {down:.3e} > {limit:.3e}")
    log(f"cloudy matrix path [{L_FLAG} layers x {NBIN_FLAG} bins x "
        f"{NY_FLAG} y, fp64, albedo 0.3]: forward_fluxes cuda vs cpu max rel "
        f"difference F_up_tot {up:.3e} (limit 1e-10), F_down_tot {down:.3e} "
        f"(limit {limit:.3e}: the cpu solve's F_down_tot moves {sens:.3e} "
        f"under one ulp of M); launches {counts}")
    return dict(fwd_rel_up=up, fwd_rel_down=down, ulp_sensitivity=sens)


ROCKY_STEPS = 40            # runtime_limit / physical_tstep


def rocky_path(launch_counts):
    """Path h: BASELINE config 5 at the flagship's depth and widths: a rocky
    planet with the surface albedo from a file, the Koll f-factor,
    additional heating and a physical timestep, non-isothermal layers
    from a super-adiabatic start, convection on, with the output files;
    exactly ROCKY_STEPS radiation iterations and one convective
    adjustment; one forward_fluxes on the card against the CPU, and where
    a radiation iteration's time goes."""
    from helios_tpu_torch import grid as grid_mod
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import HeliosConfig
    from helios_tpu_torch.rce import radiative

    kw = dict(name="rocky", planet="manual", g=981.0, a=0.05, R_planet=0.09,
              R_star=0.5, T_star=3500.0, T_intern=100.0, planet_type="rocky",
              nlayer=L_FLAG, p_boa=1e6, p_toa=1e2, scattering="yes",
              direct_beam="no", convection="yes", kappa_value=0.25,
              run_type="iterative", iso_input="no", approx_f="yes",
              physical_tstep=100.0, runtime_limit=100.0 * ROCKY_STEPS)
    with tempfile.TemporaryDirectory() as tmpdir:
        # the albedo and heating files of tests/test_surface_modes.py:66-80
        # and :117-126
        lam_um = np.geomspace(0.3, 400.0, 30)
        alb = 0.2 + 0.5 * np.exp(-((np.log10(lam_um) - 0.5) / 0.3) ** 2)
        albedo = os.path.join(tmpdir, "albedo.dat")
        np.savetxt(albedo, np.column_stack([lam_um, alb]), fmt="%.6e",
                   header="header\nheader2\nWavelength Feldspathic",
                   comments="")
        p = np.geomspace(1e2, 1e6, 20)
        heating = os.path.join(tmpdir, "heat.dat")
        np.savetxt(heating, np.column_stack(
            [p, np.where((p > 1e3) & (p < 1e5), 2e-2, 0.0)]), fmt="%.6e",
            header="header\nheader2\nPressure heating", comments="")
        p_lay = grid_mod.build_grid(kw["p_boa"], kw["p_toa"], L_FLAG,
                                    kw["g"]).p_lay
        T0 = 2500.0 * (p_lay / p_lay[0]) ** 0.35     # dlnT/dlnp > kappa
        start = os.path.join(tmpdir, "start_tp.dat")
        with open(start, "w") as f:
            f.write("rocky start profile\nlayer T[K]\n")
            f.write(f"BOA {float(T0[0])!r}\n")
            for i, t in enumerate(T0):
                f.write(f"{i} {float(t)!r}\n")
        make_cfg = lambda out_dir: HeliosConfig(
            **kw, surf_albedo="file", albedo_file=albedo,
            albedo_file_header_lines=2, add_heating="yes",
            add_heating_path=heating, add_heating_file_header_lines=2,
            force_start_tp_from_file="yes", temp_format="helios",
            temp_path=start, output_dir=out_dir + "/").finalize()
        cfg = make_cfg(tmpdir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = pipeline.run(cfg, flagship_table(), write_output=True,
                           device=DEVICE)
        launch_counts.update(read_counts())
        loops = loop_line("rocky path", out)
        # in an empty output directory: with approx_f a run reads tau_lw
        # from the file of the run before it
        with tempfile.TemporaryDirectory() as twin_dir:
            per_iteration_twin("rocky path", lambda: pipeline.run(
                make_cfg(twin_dir), flagship_table(), write_output=False,
                device=DEVICE), out)
        tau_file = os.path.join(tmpdir, "rocky",
                                "rocky_tau_lw_tau_sw_f_factor.dat")
        check(os.path.exists(tau_file), "rocky path: no tau_lw / tau_sw / "
              "f-factor file")
        n_files = len(os.listdir(os.path.join(tmpdir, "rocky")))
    phys, rad, conv = out.phys, out.rad, out.conv
    T = out.T_lay.cpu().numpy()
    n = out.n_flux_solves
    check(np.all(np.isfinite(T)), "rocky path: non-finite temperatures")
    check(rad.it == ROCKY_STEPS, f"rocky path: {rad.it} radiation "
          f"iterations, expected {ROCKY_STEPS}")
    check(conv is not None and conv.steps == 1 and conv.it == 0,
          "rocky path: not one convective adjustment")
    check(launch_counts == only(noniso_sweep=n, idle=launch_counts["idle"],
                                conv_adjust=adjust_count("rocky path", loops))
          and n == ROCKY_STEPS + 1,
          f"rocky path: launches {launch_counts} for {n} flux solves")
    check(0.25 < phys.f_factor < 2.0 / 3.0 and phys.planet_type == "rocky",
          f"rocky path: f-factor {phys.f_factor}")
    alb = out.arrays.surf_albedo.cpu().numpy()
    heat = out.arrays.add_heat_dens.cpu().numpy()
    check(alb.min() > 0.15 and alb.max() < 0.75 and heat.max() > 0,
          "rocky path: no albedo file or heating in the model")
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"rocky path [{L_FLAG} layers x {NBIN_FLAG} bins x {NY_FLAG} y, "
        f"fp64, physical timestep {phys.physical_tstep:g} s]: {rad.it} "
        f"radiation iterations + {conv.steps} convective adjustment, {n} "
        f"flux solves + {launch_counts['idle']['noniso_sweep']} idle "
        f"iterations = {launch_counts['noniso_sweep']} noniso_sweep "
        f"launches; Koll f-factor {phys.f_factor:.6f}; surface albedo "
        f"{alb.min():.3f}..{alb.max():.3f}; wall {out.wall_seconds:.3f} s "
        f"(radiation loop {out.rad_seconds:.3f} s = "
        f"{rad.it / out.rad_seconds:.1f} it/s) with {n_files} output files; "
        f"peak device memory {peak:.0f} MiB; T {T.min():.1f}..{T.max():.1f}"
        " K")
    res = dict(rad_it=rad.it, wall_s=out.wall_seconds,
               rad_it_per_s=rad.it / out.rad_seconds, peak_mib=peak,
               f_factor=phys.f_factor)
    res["fwd_rel"] = totals_cuda_vs_cpu("rocky", phys, out.arrays,
                                        out.T_lay, only(noniso_sweep=1))
    T_start = torch.as_tensor(np.append(T0, T0[0]), dtype=out.T_lay.dtype,
                              device=DEVICE)
    res["breakdown"] = time_breakdown(
        "rocky", phys, out.arrays, T_start, ("noniso_sweep",),
        thermo=radiative.make_const_thermo(0.25))
    return res


def bare_rock_path(launch_counts):
    """Path i: the bare rock (planet_type="no_atmosphere", 2 layers by
    definition) of tests/test_surface_modes.py:87-100 at the flagship's
    widths, to convergence: both layers at 1.001 K and the surface within
    0.5% of the analytic f^(1/4) (R*/a)^(1/2) T*."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import HeliosConfig

    cfg = HeliosConfig(
        planet="manual", g=981.0, a=0.05, R_planet=0.09, R_star=0.5,
        T_star=3500.0, T_intern=0.0, planet_type="no_atmosphere",
        surf_albedo=0.1, f_factor=0.6667, scattering="no", direct_beam="no",
        convection="no", run_type="iterative", iso_input="yes",
        rad_convergence_limit=1e-6).finalize()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = pipeline.run(cfg, flagship_table(), write_output=False,
                       device=DEVICE)
    launch_counts.update(read_counts())
    loops = loop_line("bare rock path", out)
    phys, T = out.phys, out.T_lay.cpu().numpy()
    check(phys.no_atmo == 1 and phys.nlayer == 2, "bare rock: not 2 layers")
    res = rce_summary("bare rock path", out, launch_counts, "iso_sweep",
                      loops)
    T_eq = 0.6667 ** 0.25 * (phys.R_star / phys.a) ** 0.5 * phys.T_star
    check(np.all(T[:2] == 1.001), f"bare rock: layers at {T[:2]}")
    rel = abs(T[2] / T_eq - 1.0)
    check(rel <= 0.005, f"bare rock: surface {T[2]:.3f} K, analytic "
          f"{T_eq:.3f} K")
    log(f"bare rock path: surface {T[2]:.4f} K against the analytic "
        f"{T_eq:.4f} K ({100 * rel:.3f}%, limit 0.5%)")
    res.update(T_surf=float(T[2]), T_eq=T_eq)
    return res


# --------------------------------------------------------------------------- #
# phase 4, the command line: the quickstart (k), preempt and resume (l),
# real-gas thermodynamics with a stellar spectrum and coupling (m)
# --------------------------------------------------------------------------- #

# the files write_all writes for a non-isothermal run without clouds
RCE_FILES = sorted(POSTPROC_FILES + ["_planck_int.dat"])
CKPT_FILES = ["restart.ckpt.npz", "restart_conv.ckpt.npz"]
CLI_FLAGS = ["-progress", "yes", "-checkpoint_every", "100"]

# A command line in a new process: helios_tpu_torch.__main__.main on the
# arguments, then one JSON line of the kernels' launch counts and the run's
# numbers.  Without h5py the opacity table is made in memory from its seed
# (the quickstart's synthetic_premixed_table) and pipeline.load_opacity_file
# hands it over instead of reading its file.
CLI_PROCESS = """
import json, sys
from helios_tpu_torch import __main__ as cli, pipeline
from helios_tpu_torch.kernels.adjust import conv_adjust
from helios_tpu_torch.kernels.integrate import band_integrate
from helios_tpu_torch.kernels.ordered import ordered_sum
from helios_tpu_torch.kernels.ro import ro_mix
from helios_tpu_torch.kernels.sweep import iso_sweep, noniso_sweep
from helios_tpu_torch.kernels.thomas import thomas_solve
from helios_tpu_torch.rce import graphs
if sys.argv[1] == "memory":
    from helios_tpu_torch.io.opacity import synthetic_premixed_table
    table = synthetic_premixed_table(nbin={nbin}, ny={ny})
    pipeline.load_opacity_file = lambda path: table
runs = []
real = pipeline.run
pipeline.run = lambda *a, **k: runs.append(real(*a, **k)) or runs[-1]
with graphs.loops() as loops:
    code = cli.main(sys.argv[2:], device={device!r})
out = runs[0]
idle = dict.fromkeys(("noniso_sweep", "iso_sweep", "thomas_solve", "ro_mix",
                      "ordered_sum", "band_integrate", "conv_adjust"), 0)
for st in loops.stats.values():
    for name, n in st.idle_launches.items():
        idle[name] += n
print(json.dumps(dict(
    launches=dict(noniso_sweep=noniso_sweep.launches,
                  iso_sweep=iso_sweep.launches,
                  thomas_solve=thomas_solve.launches,
                  ro_mix=ro_mix.launches,
                  ordered_sum=ordered_sum.launches,
                  band_integrate=band_integrate.launches,
                  conv_adjust=conv_adjust.launches, idle=idle),
    n_flux_solves=out.n_flux_solves, rad_it=out.rad.it,
    conv_it=out.conv.it, conv_steps=out.conv.steps,
    wall_s=out.wall_seconds, rad_s=out.rad_seconds,
    conv_s=out.conv_seconds,
    loops={{k: st.as_dict() for k, st in loops.stats.items()}})))
sys.exit(code)
"""


def have_h5py():
    try:
        import h5py  # noqa: F401
        return True
    except ImportError:
        return False


def quickstart_inputs(tmpdir):
    """The quickstart's inputs in ``tmpdir``: what ``python3 -m
    helios_tpu_torch.examples`` writes (examples.write_example_inputs: the
    table, 385 bins x 20, and param.dat, 105 layers); without h5py
    param.dat is written from the same template and the table stays in
    memory.  Returns (param path, table or None when it is read from its
    file)."""
    from helios_tpu_torch import examples
    from helios_tpu_torch.io.opacity import synthetic_premixed_table

    target = os.path.join(tmpdir, "example")
    if have_h5py():
        paths = examples.write_example_inputs(target, nbin=NBIN_FLAG,
                                              ny=NY_FLAG)
        return paths["param"], None
    os.makedirs(target)
    param = os.path.join(target, "param.dat")
    with open(param, "w") as f:
        f.write(examples.PARAM_TEMPLATE.format(
            opacity_path=os.path.join(target, "opac_synthetic.h5"),
            out_dir=os.path.join(target, "output") + os.sep))
    return param, synthetic_premixed_table(nbin=NBIN_FLAG, ny=NY_FLAG)


def capture_main(argv, table, callbacks=()):
    """helios_tpu_torch.__main__.main(argv) in this process, with ``table``
    (when not None) handed over by pipeline.load_opacity_file in place of
    the file and ``callbacks`` added to the run's chunk callbacks; returns
    (exit code, what it printed, its pipeline.run output)."""
    from helios_tpu_torch import __main__ as cli
    from helios_tpu_torch import pipeline

    runs, real, load = [], pipeline.run, pipeline.load_opacity_file
    pipeline.run = lambda *a, **k: runs.append(
        real(*a, callbacks=callbacks, **k)) or runs[-1]
    if table is not None:
        pipeline.load_opacity_file = lambda path: table
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.main(argv, device=DEVICE)
    finally:
        pipeline.run, pipeline.load_opacity_file = real, load
    return code, buf.getvalue(), runs[0]


def final_checkpoints(run_dir):
    """(radiation, convection) checkpoint payloads of a finished run: the
    last chunk of each loop is always written, so they hold the final
    iteration counts and the final T bit for bit."""
    from helios_tpu_torch import checkpoint as ckpt_mod
    rad, conv = (ckpt_mod.load_rad_checkpoint(os.path.join(run_dir, n))
                 for n in CKPT_FILES)
    check(rad is not None and conv is not None,
          f"no checkpoint pair in {run_dir}")
    check(ckpt_mod.checkpoint_phase(conv) == "convection",
          "the _conv checkpoint holds no convection state")
    return rad, conv


def same_final_state(label, rad_ckpt, conv_ckpt, ref):
    """The final T and both iteration counts of a run, from its final
    checkpoints, bit for bit those of the reference run ``ref``."""
    T = torch.as_tensor(conv_ckpt["T_lay"])
    counts = (int(rad_ckpt["it"]), int(conv_ckpt["it"]))
    want = (ref.rad.it, ref.conv.it)
    check(counts == want, f"{label}: iterations {counts}, expected {want}")
    check(torch.equal(T, ref.T_lay.cpu()), f"{label}: final T differs from "
          f"the reference run by up to "
          f"{float((T - ref.T_lay.cpu()).abs().max()):.3e} K")


def metric_records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "event" not in r]


def quickstart_path(tmpdir, launch_counts):
    """Path k: the quickstart through the command line.  The examples'
    inputs, then the command line with progress lines, metrics and a
    checkpoint every 100 iterations in a new process, against an
    unmonitored pipeline.run of the same parsed param.dat in this process:
    the final T and both iteration counts bit for bit (from the CLI run's
    final checkpoints), one noniso_sweep launch per flux solve, the output
    files, both checkpoint files, and metrics whose iterations rise and
    whose first chunk is marked as including the kernels' first use."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import config_from_cli

    param, table = quickstart_inputs(tmpdir)
    if table is not None:
        log("quickstart path: no h5py on this machine, so "
            "io.opacity.save_opacity_file / load_opacity_file (the "
            "quickstart's HDF5 table) and pipeline.load_starflux (path m's "
            "HDF5 spectrum) did not run: pipeline.load_opacity_file hands "
            "the table over in memory and path m passes the spectrum to "
            "pipeline.run; the CPU tests hold the readers")
    metrics = os.path.join(tmpdir, "k_metrics.jsonl")
    argv = ["-parameter_file", param] + CLI_FLAGS + ["-metrics_file",
                                                     metrics]
    code = CLI_PROCESS.format(nbin=NBIN_FLAG, ny=NY_FLAG, device=DEVICE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code, "memory" if table is not None
         else "file"] + argv, capture_output=True, text=True, env=env,
        timeout=600)
    process_s = time.perf_counter() - t
    check(proc.returncode == 0, f"quickstart CLI exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    cli = json.loads(lines[-1])
    check(any(ln.startswith("Done! Run 'example' finished") for ln in lines),
          "quickstart CLI: no 'Done!' line")
    progress = [ln for ln in lines if ln.startswith("[")]
    launch_counts.update(cli["launches"])
    loop_line("quickstart CLI process", stats=cli["loops"])
    check(cli["n_flux_solves"] > 0 and launch_counts
          == only(noniso_sweep=cli["n_flux_solves"],
                  idle=launch_counts["idle"],
                  conv_adjust=adjust_count("quickstart CLI", cli["loops"])),
          f"quickstart CLI: launches {launch_counts} for "
          f"{cli['n_flux_solves']} flux solves")

    cfg = config_from_cli(["-parameter_file", param])
    run_dir = os.path.join(cfg.output_dir, cfg.name)
    files = sorted(os.listdir(run_dir))
    want = sorted([cfg.name + f for f in RCE_FILES] + CKPT_FILES)
    check(files == want, f"quickstart CLI: files {files}, expected {want}")
    recs = metric_records(metrics)
    phases = [r["phase"] for r in recs]
    check(phases == sorted(phases, reverse=True) and "convection" in phases,
          f"quickstart CLI: metrics phases {phases}")
    for ph in ("radiation", "convection"):
        its = [r["iteration"] for r in recs if r["phase"] == ph]
        check(its == sorted(set(its)), f"quickstart CLI: {ph} metrics "
              f"iterations do not rise: {its}")
    check(recs[0]["includes_compile"] and recs[0]["iteration"] == 100,
          "quickstart CLI: the first chunk is not marked includes_compile")
    check(len(progress) == len(recs), f"quickstart CLI: {len(progress)} "
          f"progress lines for {len(recs)} chunks")

    torch.cuda.synchronize()
    reset_counts()
    ref = pipeline.run(cfg, table, write_output=False, device=DEVICE)
    ref_counts = read_counts()
    ref_loops = loop_line("quickstart in-process run", ref)
    check(ref_counts == only(noniso_sweep=ref.n_flux_solves,
                             idle=ref_counts["idle"],
                             conv_adjust=adjust_count(
                                 "quickstart in-process run", ref_loops)),
          f"quickstart in-process run: launches {ref_counts}")
    rad_ckpt, conv_ckpt = final_checkpoints(run_dir)
    same_final_state("quickstart CLI against the in-process run", rad_ckpt,
                     conv_ckpt, ref)
    check((cli["rad_it"], cli["conv_it"], cli["conv_steps"])
          == (ref.rad.it, ref.conv.it, ref.conv.steps),
          "quickstart CLI: counts differ from the in-process run")

    # what one checkpoint costs: the final states written again, timed
    from helios_tpu_torch import checkpoint as ckpt_mod
    probe = os.path.join(tmpdir, "probe.ckpt.npz")
    ck_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt_mod.save_conv_checkpoint(probe, ref.conv, ref.phys)
        ck_ms.append((time.perf_counter() - t) * 1e3)
    ck_mb = os.path.getsize(probe) / 1e6
    log(f"quickstart path [{cfg.nlayer} layers x {NBIN_FLAG} bins x "
        f"{NY_FLAG} y, fp64, convection, chunks of 100]: the CLI run "
        f"converged in {cli['rad_it']} radiation + {cli['conv_it']} "
        f"convection iterations, {cli['n_flux_solves']} flux solves + "
        f"{launch_counts['idle']['noniso_sweep']} idle iterations = "
        f"{launch_counts['noniso_sweep']} noniso_sweep launches; "
        f"{len(files)} files, {len(recs)} chunks (= checkpoints written), "
        f"{len(progress)} progress lines; final T and counts bit for bit "
        f"those of the unmonitored in-process run")
    log(f"quickstart walls: monitored CLI run {cli['wall_s']:.3f} s "
        f"(radiation {cli['rad_s']:.3f} s, convection {cli['conv_s']:.3f} s; "
        f"the process {process_s:.3f} s), unmonitored in-process run "
        f"{ref.wall_seconds:.3f} s (radiation {ref.rad_seconds:.3f} s, "
        f"convection {ref.conv_seconds:.3f} s); one convection checkpoint "
        f"{ck_mb:.1f} MB in {statistics.median(ck_ms):.1f} ms (median of 3)")
    return dict(param=param, table=table, argv=argv, ref=ref, cli=cli,
                run_dir=run_dir,
                process_s=process_s, files=files, chunks=len(recs),
                ckpt_ms=statistics.median(ck_ms), ckpt_mb=ck_mb)


def resume_path(k, tmpdir, counts_rad, counts_conv):
    """Path l: preempt and resume.  Path k's config runs in this process
    with a checkpoint every 100 iterations and is stopped by a callback
    after the radiation checkpoint at iteration 200; the same command line
    (main() in this process) then resumes from the file and runs to the
    end.  When that run has written its convection checkpoint at
    iteration 200, a callback copies its checkpoint pair (the final
    radiation state and the _conv file) into a second run directory: the
    files that a run stopped there leaves.  The command line then resumes
    there from the _conv file.  Each resumed run: the final T and both
    counts bit for bit path k's, one noniso_sweep launch per flux solve
    made after the restore (and per loop iteration past the stop)."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.config import config_from_cli

    class Preempted(Exception):
        pass

    def preempt(info):
        if info.phase == "radiation" and info.state.it >= 200:
            raise Preempted

    argv = {ph: k["argv"][:-2] + ["-name", f"resume_{ph}"]  # no metrics
            for ph in ("radiation", "convection")}
    run_dirs = {ph: os.path.join(config_from_cli(a).output_dir,
                                 f"resume_{ph}") for ph, a in argv.items()}

    def snapshot(info):
        if info.phase == "convection" and info.state.it == 200:
            os.makedirs(run_dirs["convection"])
            for name in CKPT_FILES:
                shutil.copy(os.path.join(run_dirs["radiation"], name),
                            run_dirs["convection"])

    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):  # progress lines
            pipeline.run(config_from_cli(argv["radiation"]), k["table"],
                         write_output=False, device=DEVICE,
                         callbacks=[preempt])
        check(False, "resume path: the radiation loop was not stopped")
    except Preempted:
        pass
    stopped_s = time.perf_counter() - t

    res = {}
    for phase, counts, cbs in (("radiation", counts_rad, [snapshot]),
                               ("convection", counts_conv, [])):
        torch.cuda.synchronize()
        reset_counts()
        with warnings.catch_warnings():      # the converged radiation file
            warnings.simplefilter("ignore")
            code, printed, out = capture_main(argv[phase], k["table"], cbs)
        counts.update(read_counts())
        loops = loop_line(f"resumed {phase} run", out)
        check(code == 0 and "Done!" in printed,
              f"resume path: the resumed {phase} run failed")
        restored = out.rad_it0 if phase == "radiation" else (
            out.conv.it - out.conv.steps + 1)
        check(restored == 200, f"resume path: the {phase} run resumed at "
              f"{restored}, not 200")
        check(counts == only(noniso_sweep=out.n_flux_solves,
                             idle=counts["idle"],
                             conv_adjust=adjust_count(
                                 f"resumed {phase} run", loops)),
              f"resume path: launches {counts} for {out.n_flux_solves} "
              "flux solves after the restore")
        same_final_state(f"resumed {phase} run",
                         *final_checkpoints(run_dirs[phase]), k["ref"])
        check(torch.equal(out.T_lay.cpu(), k["ref"].T_lay.cpu()),
              f"resume path: the resumed {phase} run's T differs")
        how = (f"stopped after the radiation checkpoint at iteration 200 "
               f"({stopped_s:.3f} s)" if phase == "radiation" else
               "the checkpoint pair of the first resumed run at convection "
               "iteration 200")
        log(f"resume path, {how}, resumed from the file through the "
            f"command line: {out.n_flux_solves} flux solves + "
            f"{counts['idle']['noniso_sweep']} idle iterations = "
            f"{counts['noniso_sweep']} noniso_sweep launches after the "
            f"restore, wall {out.wall_seconds:.3f} s; final T and "
            f"{out.rad.it} + {out.conv.it} iterations bit for bit path k's")
        res[phase] = dict(wall_s=out.wall_seconds, solves=out.n_flux_solves)
    res["stopped_s"] = stopped_s
    return res


# a synthetic water-atmosphere table in the reference's ASCII format
# (read.py:1105-1193 "water_atmo": 5 header lines, then T, P [10^-6 bar],
# kappa, c_p [erg/mol/K], log10 entropy [erg/g/K], two unused columns and
# the water phase number), on the grid of the flagship's profiles
WATER_T = np.linspace(100.0, 6000.0, 60)
WATER_P = np.geomspace(1e-2, 1e10, 49)


def write_water_table(path):
    """Smooth kappa 0.22-0.29, c_p = R/kappa (10% up where water
    condenses), entropy rising with T and falling with P, and the phase
    number of write.py:209-232: 1 vapour or supercritical, 0 liquid or
    ice.  Returns the file's path and the grids as written (temps, press,
    kappa, cp, entropy [erg/g/K], phase)."""
    from helios_tpu_torch import constants as pc
    T, P = np.meshgrid(WATER_T, WATER_P, indexing="ij")
    lp = np.log10(P)
    kappa = 0.25 + 0.03 * np.tanh((lp - 5.0) / 2.0) - 0.01 * T / 6000.0
    psat = 6.1e3 * np.exp(17.27 * (T - 273.0) / (T - 36.0)) * 1e3
    condensed = (T <= 273.0) | ((P > psat) & (T < 647.0))
    phase = np.where(condensed, 0.0, 1.0)
    cp = pc.R_UNIV / kappa * (1.0 + 0.1 * (1.0 - phase))
    logS = 7.5 + 0.4 * np.log10(T / 100.0) - 0.03 * (lp - 6.0)
    with open(path, "w") as f:
        f.write("synthetic water-atmosphere table\n" + "#\n" * 4)
        for i in range(len(WATER_T)):
            for j in range(len(WATER_P)):
                row = (T[i, j], P[i, j], kappa[i, j], cp[i, j], logS[i, j],
                       0.0, 0.0, phase[i, j])
                f.write(" ".join(repr(float(x)) for x in row) + "\n")
    return dict(path=path, temps=WATER_T, press=WATER_P, kappa=kappa, cp=cp,
                entropy=10.0 ** logS, phase=phase)


def plain_bilinear(grid, temps, press, T, p, log_temp):
    """The plain version of a thermodynamics-table lookup, in numpy:
    bilinear in T (in log10 T with ``log_temp``, the grid step taken in
    log10 of the grid's ends) and log10 P, the fractional index clamped to
    [0.001, n - 1.001] (kernels.cu:703-919)."""
    def frac(x, x0, x1, n):
        t = np.clip((x - x0) / ((x1 - x0) / (n - 1.0)), 0.001, n - 1.001)
        i = np.minimum(np.floor(t).astype(np.int64), n - 2)
        return i, t - i

    f = np.log10 if log_temp else (lambda x: x)
    ti, wt = frac(f(T), f(temps[0]), f(temps[-1]), len(temps))
    pi, wp = frac(np.log10(p), np.log10(press[0]), np.log10(press[-1]),
                  len(press))
    return (grid[ti, pi] * (1 - wp) * (1 - wt)
            + grid[ti, pi + 1] * wp * (1 - wt)
            + grid[ti + 1, pi] * (1 - wp) * wt
            + grid[ti + 1, pi + 1] * wp * wt)


def write_spectrum(path, donor):
    """A synthetic 385-bin stellar spectrum (not a blackbody): a 5040 K
    Planck curve with absorption bands, in the star tool's HDF5 layout
    when h5py is there.  Returns the spectrum [erg/s/cm^2/cm]."""
    from helios_tpu_torch import constants as pc
    lam = np.asarray(donor.wave_centers)
    x = pc.H * pc.C / (lam * pc.K_B * 5040.0)
    flux = pc.PI * 2 * pc.H * pc.C ** 2 / lam ** 5 / np.expm1(x)
    flux *= 1.0 - 0.4 * np.exp(-((np.log10(lam) + 3.9) / 0.05) ** 2)
    if have_h5py():
        import h5py
        with h5py.File(path, "w") as f:
            f.create_dataset("/r50_kdistr/synthetic/star", data=flux)
    return flux


# the thermodynamics fields of a run's result, the table each comes from
# and whether it is looked up in log10 T
THERMO_FIELDS = (("kappa_lay", "kappa", False), ("c_p_lay", "cp", True),
                 ("entropy_lay", "entropy", True),
                 ("phase_number_lay", "phase", False))


def thermo_against_plain(label, out, water):
    """A run's kappa, c_p, entropy and phase at its final T (looked up on
    the card by pipeline.run) against the plain numpy lookup in the grids
    that were written to the table file: rtol 1e-12.  Returns the largest
    relative difference."""
    T = out.T_lay[:out.phys.nlayer].cpu().numpy()
    p = out.arrays.p_lay.cpu().numpy()
    worst = 0.0
    for field, grid, log_temp in THERMO_FIELDS:
        got = getattr(out.result, field)
        want = plain_bilinear(water[grid], water["temps"], water["press"], T,
                              p, log_temp)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        check(rel <= 1e-12, f"{label}: {field} differs from the plain "
              f"lookup by {rel:.3e} (limit 1e-12)")
        worst = max(worst, rel)
    return worst


def real_gas_path(tmpdir, water, counts0, counts1, pp_counts):
    """Path m: the flagship with real-gas thermodynamics
    (kappa_value="water_atmo", the synthetic table ``water`` in the
    reference's ASCII format), a stellar spectrum file (a synthetic 385-bin
    spectrum in HDF5), the direct beam and coupling (which needs on-the-fly
    mixing: the species of path e), coupling iterations 0 and 1 to
    convergence: finite entropy and phase inside the table's range in
    _colmass_mu_cp_kappa_entropy.dat and _state.dat, kappa, c_p, entropy
    and phase against the plain lookup (rtol 1e-12), coupling convergence
    "1" (identical physics), the forward totals at the final T on the card
    against the CPU (rtol 1e-10); then the post-processing run of the
    converged profile with the same table (one iso_sweep of 1001 passes),
    which writes the entropy and phase files too.  With these thin
    absorbers no layer is unstable: table_convection_path runs the
    convection loop with the table."""
    from helios_tpu_torch import pipeline

    donor, sset = otf_inputs(DEVICE)
    s_lo, s_hi = water["entropy"].min(), water["entropy"].max()
    ph_lo, ph_hi = water["phase"].min(), water["phase"].max()
    star_path = os.path.join(tmpdir, "star.h5")
    flux = write_spectrum(star_path, donor)
    starflux = None if have_h5py() else flux
    extra = dict(OTF_WORKLOAD, opacity_mixing="on-the-fly",
                 kappa_value="water_atmo", kappa_file_path=water["path"],
                 stellar_model="file", stellar_path=star_path,
                 stellar_dataset="/r50_kdistr/synthetic/star",
                 direct_beam="yes", coupling="yes", name="realgas",
                 output_dir=tmpdir + "/")
    del extra["iso_input"], extra["T_intern"], extra["convection"]
    outs, walls = [], []
    for n, counts in ((0, counts0), (1, counts1)):
        cfg, _ = flagship(tmpdir, **extra, coupling_iter_nr=n)
        check(cfg.real_star == 1 and cfg.iso == 0 and cfg.coupling == 1,
              "real-gas path: not the non-iso stellar-file coupling run")
        torch.cuda.synchronize()
        reset_counts()
        out = pipeline.run(cfg, donor, sset=sset, starflux=starflux,
                           device=DEVICE)
        counts.update(read_counts())
        loops = loop_line(f"real-gas coupling iteration {n}", out)
        rad, conv = out.rad, out.conv
        check(not bool(rad.keep_running) and not rad.aborted
              and conv is not None and not (conv.keep_running
                                            or conv.aborted),
              f"real-gas path, coupling iteration {n}: no convergence")
        # the start, every 10th radiation iteration, every convection step
        # at a multiple of 10 and the diagnostics
        refreshes = (1 + (rad.it + 9) // 10
                     + (conv.it // 10 + 1 if conv.steps else 0) + 1)
        check(counts == only(noniso_sweep=out.n_flux_solves,
                             ro_mix=2 * refreshes, idle=counts["idle"],
                             conv_adjust=adjust_count(
                                 f"real-gas coupling iteration {n}", loops)),
              f"real-gas path, coupling iteration {n}: launches {counts} "
              f"for {out.n_flux_solves} flux solves and {refreshes} cell "
              f"refreshes ({rad.it} radiation, {conv.it} convection "
              f"iterations, {conv.steps} convection steps)")
        outs.append(out)
        walls.append(out.wall_seconds)
    check(torch.equal(outs[0].T_lay, outs[1].T_lay),
          "real-gas path: coupling iterations 0 and 1 differ")
    run_dir = os.path.join(tmpdir, "realgas")
    with open(os.path.join(run_dir, "realgas_coupling_convergence.dat")) as f:
        converged = f.read().strip()
    check(converged == "1", f"real-gas path: coupling convergence "
          f"{converged!r}, expected '1'")
    for name in ("realgas_tp_coupling_0.dat", "realgas_tp_coupling_1.dat"):
        check(os.path.exists(os.path.join(run_dir, name)),
              f"real-gas path: no {name}")
    ent, ph = thermo_columns(run_dir, "realgas", L_FLAG)
    check(np.all(np.isfinite(ent)) and ent.min() >= s_lo * (1 - 1e-5)
          and ent.max() <= s_hi * (1 + 1e-5),
          f"real-gas path: entropy {ent.min():.4e}..{ent.max():.4e} outside "
          f"the table's {s_lo:.4e}..{s_hi:.4e}")
    check(np.all(np.isfinite(ph)) and ph.min() >= ph_lo and ph.max() <= ph_hi,
          f"real-gas path: phase {ph.min()}..{ph.max()} outside the table's "
          f"{ph_lo}..{ph_hi}")
    out = outs[-1]
    thermo_rel = thermo_against_plain("real-gas path", out, water)
    counts, _, rel = forward_cuda_vs_cpu(out.phys, out.arrays, out.T_lay,
                                         sset=sset,
                                         sset_cpu=otf_inputs("cpu")[1])
    worst = max(float(r.max()) for r in rel.values())
    check(worst <= 1e-10, f"real-gas forward_fluxes cuda vs cpu: "
          f"{worst:.3e} > 1e-10")
    c = out.conv
    log(f"real-gas path [{L_FLAG} layers x {NBIN_FLAG} bins x {NY_FLAG} y, "
        f"fp64, water_atmo table, stellar spectrum "
        f"{'file' if starflux is None else 'in memory'}, beam, RO of 2 "
        f"absorbers, coupling iterations 0 and 1]: {out.rad.it} radiation "
        f"+ {c.it} convection iterations each, walls {walls[0]:.3f} / "
        f"{walls[1]:.3f} s; launches {counts1}; coupling convergence "
        f"{converged}; entropy {ent.min():.4e}..{ent.max():.4e} erg/g/K, "
        f"phase {ph.min():g}..{ph.max():g}; kappa, c_p, entropy and phase "
        f"max rel difference from the plain lookup {thermo_rel:.3e} (limit "
        f"1e-12); forward_fluxes cuda vs cpu max rel difference of the "
        f"totals {worst:.3e} (limit 1e-10)")

    def in_range(run_dir):
        e, p = thermo_columns(run_dir, "pp", L_FLAG)
        check(np.all(np.isfinite(e)) and e.min() >= s_lo * (1 - 1e-5)
              and e.max() <= s_hi * (1 + 1e-5) and np.all(np.isfinite(p))
              and p.min() >= ph_lo and p.max() <= ph_hi,
              "real-gas post-processing: entropy or phase outside the "
              "table's range")

    pp_kw = dict(FLAGSHIP, **extra)
    pp_kw.update(coupling="no")
    for k in ("output_dir", "name"):
        del pp_kw[k]
    pp, files, _ = postprocessing_run(out.T_lay, out.arrays, pp_kw, donor,
                                      pp_counts, sset=sset,
                                      extra_files=("_state.dat",),
                                      starflux=starflux, inspect=in_range)
    check(pp_counts == only(iso_sweep=1, ro_mix=2),
          f"real-gas post-processing: launches {pp_counts}, expected one "
          "iso_sweep and two ro_mix")
    log(f"real-gas post-processing path: wall {pp.wall_seconds:.3f} s with "
        f"{len(files)} output files, entropy and phase among them; launches "
        f"{pp_counts}")
    return dict(walls=walls, rad_it=out.rad.it, conv_it=c.it, fwd_rel=worst,
                pp_wall_s=pp.wall_seconds, thermo_rel=thermo_rel)


def table_convection_path(tmpdir, water, launch_counts, flag_out):
    """Path m, the convection loop with the table: path a's flagship with
    kappa_value="water_atmo" (the same table as the coupling runs), to
    convergence through both loops.  The convection loop must run and
    leave convective layers; kappa, c_p, entropy and phase at the final T
    against the plain lookup (rtol 1e-12); one noniso_sweep launch per
    flux solve; the convection loop's wall per step against path a's
    constant kappa, and the device time of one convection step's kappa /
    c_p lookups at the final profile."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.rce import radiative

    cfg, table = flagship(tmpdir, kappa_value="water_atmo",
                          kappa_file_path=water["path"])
    torch.cuda.synchronize()
    reset_counts()
    out = pipeline.run(cfg, table, write_output=False, device=DEVICE)
    launch_counts.update(read_counts())
    loops = loop_line("table convection path", out)
    per = per_iteration_twin("table convection path", lambda: pipeline.run(
        cfg, table, write_output=False, device=DEVICE), out)
    rad, conv = out.rad, out.conv
    check(not bool(rad.keep_running) and not rad.aborted
          and conv is not None and conv.steps > 0
          and not (conv.keep_running or conv.aborted),
          f"table convection path: the convection loop did not run to "
          f"convergence ({rad.it} radiation, {conv.it} convection "
          "iterations)")
    n_conv = int(conv.conv_layer.sum())
    check(n_conv > 0, "table convection path: no convective layer")
    check(launch_counts == only(noniso_sweep=out.n_flux_solves,
                                idle=launch_counts["idle"],
                                conv_adjust=adjust_count(
                                    "table convection path", loops)),
          f"table convection path: launches {launch_counts} for "
          f"{out.n_flux_solves} flux solves")
    thermo_rel = thermo_against_plain("table convection path", out, water)
    lookups = {name: thermo_lookup_ms(th, out.arrays, out.T_lay)
               for name, th in (
                   ("table", pipeline.make_thermo(cfg, device=DEVICE)),
                   ("constant", radiative.make_const_thermo(
                       FLAGSHIP["kappa_value"])))}
    per_step = lambda o: o.conv_seconds / o.conv.steps * 1e3
    log(f"table convection path [{L_FLAG} layers x {NBIN_FLAG} bins x "
        f"{NY_FLAG} y, fp64, path a's flagship with the water_atmo table]: "
        f"{rad.it} radiation + {conv.it} convection iterations "
        f"({conv.steps} steps), {n_conv} convective layers, "
        f"{out.n_flux_solves} flux solves + "
        f"{launch_counts['idle']['noniso_sweep']} idle iterations = "
        f"{launch_counts['noniso_sweep']} noniso_sweep launches; kappa, "
        f"c_p, entropy and phase max rel difference from the plain lookup "
        f"{thermo_rel:.3e} (limit 1e-12); wall {out.wall_seconds:.3f} s, "
        f"convection loop {per_step(out):.3f} ms per step against path "
        f"a's {per_step(flag_out):.3f} with a constant kappa")
    log("table convection path, the kappa / c_p lookups of one convection "
        "step (kappa_cp_lay and kappa_int, twice each) at the final "
        "profile, device time: "
        + "; ".join(f"{name} {ms:.4f} ms in {k:.0f} kernels"
                    for name, (ms, k) in lookups.items()))
    thermo = pipeline.make_thermo(cfg, device=DEVICE)
    conv_bd = conv_breakdown("table convection", out, thermo,
                             ("noniso_sweep",))
    conv_per = conv_breakdown("table convection, per-iteration loop", out,
                              thermo, ("noniso_sweep",), per_iteration=True)
    return dict(wall_s=out.wall_seconds, rad_it=rad.it, conv_it=conv.it,
                conv_ms_per_step=per_step(out),
                flag_conv_ms_per_step=per_step(flag_out),
                thermo_rel=thermo_rel, lookups=lookups, loops=loops,
                conv_breakdown=conv_bd, conv_per_iteration=conv_per,
                per_iteration_wall_s=per.wall_seconds)


def thermo_lookup_ms(thermo, arrays, T, n=20):
    """Device time and kernels of the kappa / c_p lookups that one
    convection step makes (kappa_cp_lay and kappa_int before the
    adjustment and again after the flux solve), at the profile T, with
    ``thermo`` a table or a constant: torch.profiler over n steps."""
    from torch.profiler import ProfilerActivity, profile
    from helios_tpu_torch.ops import interp as interp_ops
    from helios_tpu_torch.rce import radiative

    T_int = interp_ops.interface_temperatures(T)

    def step():
        for _ in range(2):
            radiative.kappa_cp_lay(thermo, T, arrays.p_lay)
            radiative.kappa_int(thermo, T_int, arrays.p_int)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    return us / 1e3 / n, count / n


def thermo_columns(run_dir, name, L):
    """The entropy column of _colmass_mu_cp_kappa_entropy.dat (every layer)
    and the phase column of _state.dat (the layers below 0.99 x 10^-6 bar,
    write.py:209-232)."""
    with open(os.path.join(run_dir,
                           f"{name}_colmass_mu_cp_kappa_entropy.dat")) as f:
        rows = [r.split() for r in f.read().splitlines()[2:] if r.strip()]
    with open(os.path.join(run_dir, f"{name}_state.dat")) as f:
        phase = [float(r.split()[3]) for r in f.read().splitlines()[2:]
                 if r.strip()]
    check(len(rows) == L and 0 < len(phase) <= L,
          f"{name}: {len(rows)} entropy and {len(phase)} phase rows for {L} "
          "layers")
    return np.asarray([float(r[6]) for r in rows]), np.asarray(phase)


# --------------------------------------------------------------------------- #
# paths n-o: planet ensembles
# --------------------------------------------------------------------------- #

ENSEMBLE_P = 8
ENSEMBLE_ALBEDOS = [0.1 * k for k in range(ENSEMBLE_P)]
ENSEMBLE_CKPT_FILES = ["ensemble.ckpt.npz", "ensemble_conv.ckpt.npz"]


def batched_flux_solves(outs):
    """Flux solves of a batch: the loops iterate while any member runs, so
    the slowest member's radiation iterations plus its convection steps."""
    return (max(o.rad.it - o.rad_it0 for o in outs)
            + max(o.conv.steps if o.conv is not None else 0 for o in outs))


def member_against(label, member, ref):
    """A batch member against the same planet's run alone: T and both
    iteration counts bit for bit (checked; the gap logged first).
    Returns (bitwise, |dT| of the surface ghost, max |dT| of the other
    layers, in K)."""
    same = (torch.equal(member.T_lay.cpu(), ref.T_lay.cpu())
            and (member.rad.it, member.conv.it)
            == (ref.rad.it, ref.conv.it))
    diff = (member.T_lay.cpu() - ref.T_lay.cpu()).abs()
    ghost, rest = float(diff[-1]), float(diff[:-1].max())
    log(f"{label}: {'bit for bit' if same else 'NOT bit for bit'} its run "
        f"alone (iterations {member.rad.it} + {member.conv.it} against "
        f"{ref.rad.it} + {ref.conv.it}; |dT| {ghost:.3e} K in the surface "
        f"ghost layer, at most {rest:.3e} K elsewhere)")
    check(same, f"{label}: not bit for bit its run alone")
    return same, ghost, rest


# --------------------------------------------------------------------------- #
# C.8: the first op at which a batch member differs from its run alone
# --------------------------------------------------------------------------- #

def torch_route_integration(*args, **kw):
    """The flux integration as the port ran it before kernels.ordered: the
    chain of ops with torch's sums."""
    from helios_tpu_torch.kernels import integrate
    real = integrate.ordered_sum
    integrate.ordered_sum = TORCH_ROUTE["ordered_sum"]
    try:
        return integrate.band_integrate_reference(*args, **kw)
    finally:
        integrate.ordered_sum = real


# names of the loops' call sites of the fixed-order sums and the flux
# integration, and torch's sums in their place: the route the port took
# before kernels.ordered
ORDERED_SITES = (("fastpath", ("ordered_cumsum",)),
                 ("forward", ("ordered_cumsum", "band_integrate")),
                 ("rce.convect", ("ordered_cumsum",)),
                 ("rce.radiative", ("ordered_cumsum",)))
TORCH_ROUTE = {"ordered_sum": lambda x, dim: torch.sum(x, dim=dim),
               "ordered_cumsum": lambda x, dim: torch.cumsum(x, dim=dim),
               "band_integrate": torch_route_integration}


@contextlib.contextmanager
def patched_sites(make):
    """Each call site of ORDERED_SITES (and fastpath's noniso_sweep) bound
    to make(name, function) while the block runs."""
    import importlib
    saved = []
    sites = ORDERED_SITES + (("fastpath", ("noniso_sweep",)),)
    for mod_name, names in sites:
        mod = importlib.import_module("helios_tpu_torch." + mod_name)
        for n in names:
            saved.append((mod, n, getattr(mod, n)))
            setattr(mod, n, make(n, getattr(mod, n)))
    try:
        yield
    finally:
        for mod, n, fn in reversed(saved):
            setattr(mod, n, fn)


def port_callsite():
    """file:line of the innermost caller inside helios_tpu_torch outside
    its kernel wrappers."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename.replace(os.sep, "/")
        if "helios_tpu_torch/" in name and "/kernels/" not in name:
            return (f"{name.split('helios_tpu_torch/')[-1]}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


class OpRecorder(torch.overrides.TorchFunctionMode):
    """Every floating-point tensor that a torch function returns, with the
    port's call site, in call order; the kernel wrappers' outputs are
    added by ``kernel``.  Uninitialised allocations are left out (a
    kernel fills them later, and its own record holds the result)."""
    UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty"}

    def __init__(self):
        super().__init__()
        self.ops = []

    def add(self, name, out):
        outs = out if isinstance(out, tuple) else (out,)
        for k, t in enumerate(outs):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.ops.append((name + (f"[{k}]" if len(outs) > 1 else ""),
                                 port_callsite(), t))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if name not in self.UNINITIALISED:
            self.add(name, out)
        return out

    def kernel(self, name, fn):
        def recorded(*a, **k):
            out = fn(*a, **k)
            self.add(name, out)
            return out
        return recorded


def member_views(batched, solo, P):
    """The P members of a batched op output against its solo output's
    shape: the planet axis where dropping it gives the solo shape (after
    the first axis first, as the port's layout has it), or a flattened
    [.., P*n, ..] axis; None when neither fits."""
    b, s = tuple(batched.shape), tuple(solo.shape)
    for ax in sorted(range(len(b)), key=lambda a: (a != 1, a)):
        if b[ax] == P and b[:ax] + b[ax + 1:] == s:
            return [batched.select(ax, p) for p in range(P)]
    if len(b) == len(s):
        for ax in range(len(b)):
            rest_b, rest_s = b[:ax] + b[ax + 1:], s[:ax] + s[ax + 1:]
            if b[ax] == P * s[ax] and rest_b == rest_s:
                v = batched.reshape(s[:ax] + (P, s[ax]) + s[ax + 1:])
                return [v.select(ax, p) for p in range(P)]
    return None


def same_bits(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def differing_ops(solo_ops, batch_ops, P):
    """The ops (in the solo run's order) at which some member of the batch
    differs from the solo output: [(name, call site, members that differ,
    max relative difference)], and the number of ops compared."""
    import difflib
    keys = lambda ops: [(n, site) for n, site, _ in ops]
    match = difflib.SequenceMatcher(None, keys(solo_ops), keys(batch_ops),
                                    autojunk=False)
    found, compared = [], 0
    for i, j, n in match.get_matching_blocks():
        for k in range(n):
            name, site, solo = solo_ops[i + k]
            views = member_views(batch_ops[j + k][2], solo, P)
            if views is None:
                continue
            compared += 1
            off = [p for p, v in enumerate(views) if not same_bits(v, solo)]
            if off:
                scale = float(solo.abs().max()) or 1.0
                rel = max(float((views[p] - solo).abs().max()) for p in off)
                found.append((name, site, off, rel / scale,
                              slot_classes(views)))
    return found, compared


def slot_classes(views):
    """The slots grouped by equal bits of their outputs."""
    classes = []
    for p, v in enumerate(views):
        for c in classes:
            if same_bits(views[c[0]], v):
                c.append(p)
                break
        else:
            classes.append([p])
    return classes


def op_diagnosis(label, P, solo_fn, batch_fn, routes=("torch", "ordered")):
    """solo_fn() and batch_fn() (the same work on one planet and on P
    copies of it) under an OpRecorder, once with each route of the loops'
    sums: "torch" (torch.sum / torch.cumsum, the port before
    kernels.ordered) and "ordered" (the port).  Logs the first op at which
    a member differs from the solo output, with the members (slots) that
    differ, and every other op that does.  Returns {route: (differing ops,
    ops compared)}."""
    res = {}
    for route in routes:
        runs = []
        for fn in (solo_fn, batch_fn):
            rec = OpRecorder()
            make = lambda n, f: rec.kernel(
                n, TORCH_ROUTE[n] if route == "torch" and n in TORCH_ROUTE
                else f)
            with patched_sites(make), rec:
                fn()
            torch.cuda.synchronize()
            runs.append(rec.ops)
        found, compared = differing_ops(runs[0], runs[1], P)
        res[route] = (found, compared)
        if found:
            name, site, off, rel, classes = found[0]
            rest = "; ".join(f"{n} at {s}: slots {o}, equal among "
                             f"themselves in {c}" for n, s, o, _, c
                             in found[1:13])
            log(f"{label}, {route} sums: {compared} ops compared; the first "
                f"that differs from the run alone is {name} at {site}: "
                f"slots {off} of {P} differ (max {rel:.3e} of its scale), "
                f"slots equal among themselves in {classes}; "
                f"{len(found) - 1} later ops differ: {rest}")
        else:
            log(f"{label}, {route} sums: {compared} ops compared, every "
                f"member bit for bit the run alone at every op")
    return res


def copies_of(x, P):
    """P copies of a loop tensor, the planet axis after the layer axis."""
    return torch.stack([x] * P, dim=1 if x.dim() > 0 else 0).contiguous()


def gap_causes(label, run, cfg, table):
    """Where a batch member's last bits part from its run alone, on the
    card.  (1) One forward solve (compute_cells, solve_fluxes,
    integrate_flux_flat) of ``run``'s planet at its final T, and its
    convective adjustment from its radiation result as the chain of ops
    (convect.plain_adjustment), each alone and as ENSEMBLE_P copies in one
    batch: the first op that differs, by op_diagnosis, with torch's sums
    and with the fixed-order ones; with the latter none may differ; and
    the adjustment's kernel (one block per member): every copy bit for bit
    the planet alone.  (2) The ENSEMBLE_P copies run to convergence as one
    ensemble: each bit for bit ``run`` (checked)."""
    from helios_tpu_torch import forward as fw
    from helios_tpu_torch.ops import interp as interp_ops
    from helios_tpu_torch.parallel import ensemble as ens
    from helios_tpu_torch.pipeline import make_thermo
    from helios_tpu_torch.rce import convect
    from helios_tpu_torch.rce.radiative import kappa_cp_lay, kappa_int

    P = ENSEMBLE_P
    phys, m = run.phys, run.arrays
    mb = ens.stack_models([m] * P)
    T = run.T_lay.clone()
    forward = op_diagnosis(
        f"{label}: one forward solve", P,
        lambda: fw.forward_fluxes(phys, m, T),
        lambda: fw.forward_fluxes(phys, mb, copies_of(T, P)))

    thermo = make_thermo(cfg, device=DEVICE)
    rad = run.rad

    def adjustment(batch, fn=convect.plain_adjustment):
        wrap = (lambda x: copies_of(x, P)) if batch else (lambda x: x)
        arrays = mb if batch else m
        T0 = wrap(rad.T_lay)
        kap, c_p = kappa_cp_lay(thermo, T0, arrays.p_lay)
        kap_int = kappa_int(thermo, interp_ops.interface_temperatures(T0),
                            arrays.p_int)
        return fn(
            T0, arrays.p_lay, arrays.p_int, kap, kap_int, c_p,
            wrap(rad.cache.meanmolmass_lay), iter_value=0,
            T_star=phys.T_star, input_dampara=phys.input_dampara,
            F_intern=phys.F_intern,
            F_add_heat_sum=wrap(rad.cache.F_add_heat_sum),
            F_smooth_sum=wrap(rad.F_smooth_sum),
            F_down_tot=wrap(rad.totals.F_down_tot),
            F_up_tot=wrap(rad.totals.F_up_tot))

    adjust = op_diagnosis(f"{label}: the convective adjustment", P,
                          lambda: adjustment(False), lambda: adjustment(True))
    solo = adjustment(False, convect.convective_adjustment)
    batch = adjustment(True, convect.convective_adjustment)
    kernel_same = all(torch.equal(b[:, k], a) for a, b in zip(solo, batch)
                      for k in range(P))
    log(f"{label}: the adjustment's kernel, {P} copies in one launch "
        f"against the planet alone: "
        f"{'bit for bit' if kernel_same else 'not bit for bit'}")
    check(kernel_same, f"{label}: a copy's adjustment by the kernel is not "
          "bit for bit the planet's alone")
    for what, res in (("forward solve", forward), ("adjustment", adjust)):
        found, compared = res["ordered"]
        check(compared > 0 and not found,
              f"{label}: with the fixed-order sums a batch member differs "
              f"from its {what} alone at {found[:1]}")

    copies = ens.run_ensemble(
        [dataclasses.replace(cfg, name=f"copy_{k}") for k in range(P)],
        tables=[table] * P, write_output=False, device=DEVICE)
    counts = [(o.rad.it, o.conv.it) for o in copies]
    bitwise = [torch.equal(o.T_lay, run.T_lay) for o in copies]
    log(f"{label}: {P} copies of path a's planet as one batch: iterations "
        f"(radiation, convection) {counts} against path a's "
        f"{(run.rad.it, run.conv.it)}; final T bit for bit path a's: "
        f"{bitwise}")
    check(len(set(counts)) == 1 and all(bitwise)
          and counts[0] == (run.rad.it, run.conv.it),
          f"{label}: the {P} copies stop at {counts}, T bit for bit "
          f"{bitwise}")
    summary = lambda res: {route: dict(
        compared=c, differing=len(f),
        first=(dict(op=f[0][0], site=f[0][1], slots=f[0][2],
                    rel=f[0][3], slot_classes=f[0][4]) if f else None))
        for route, (f, c) in res.items()}
    return dict(forward=summary(forward), adjustment=summary(adjust),
                copies=counts, copies_bitwise=bitwise)


def batched_vs_solo_forward(phys, arrays, stacked, T, k=0):
    """One forward_fluxes of the batch and one of member k alone at the
    same temperatures, on the card: whether member k's totals are bit for
    bit its solo call's, and their largest relative difference."""
    from helios_tpu_torch.forward import forward_fluxes

    Tb = torch.stack([T] * stacked.p_lay.shape[1], dim=1)
    got = forward_fluxes(phys, stacked, Tb)[1]
    want = forward_fluxes(phys, arrays, T)[1]
    fields = ("F_up_tot", "F_down_tot", "F_net")
    same = all(torch.equal(getattr(got, f)[:, k], getattr(want, f))
               for f in fields)
    rel = max(float(((getattr(got, f)[:, k] - getattr(want, f)).abs()
                     / getattr(want, f).abs().max()).max()) for f in fields)
    return same, rel


def ensemble_path(tmpdir, launch_counts, flag_out, T_start):
    """Path n: run_ensemble of 8 flagship planets (path a's config and
    start profile, surface albedo 0.0, 0.1, ..., 0.7, the table in
    memory).  Every member finite and converged; one noniso_sweep launch
    per batched flux solve (not 8) and per iteration replayed past the
    stop; gap_causes (the first op at which a member would differ with
    torch's sums; none with the fixed-order ones; 8 copies of path a's
    planet bit for bit path a); member 0's forward
    solve and run bit for bit path a's; the batch's wall against 8 x path
    a's, planets per hour and the peak device memory per member; where a
    batched radiation iteration's time goes, with the fixed-order sums and
    with torch's; one batched forward_fluxes on the card against the
    CPU."""
    from helios_tpu_torch.parallel import ensemble as ens

    cfg0, table = flagship(tmpdir)
    cfgs = [dataclasses.replace(cfg0, name=f"flagship_{k}",
                                surf_albedo=max(1e-8, a))
            for k, a in enumerate(ENSEMBLE_ALBEDOS)]
    check(cfgs[0].surf_albedo == cfg0.surf_albedo, "member 0 is not path a")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs = ens.run_ensemble(cfgs, tables=[table] * ENSEMBLE_P,
                            write_output=False, device=DEVICE)
    torch.cuda.synchronize()
    launch_counts.update(read_counts())
    adjusts = adjust_count("ensemble path", loop_stats())
    peak = torch.cuda.max_memory_allocated()

    for o in outs:
        T = o.T_lay.cpu().numpy()
        check(np.all(np.isfinite(T)), f"ensemble path: {o.result.name} has "
              "non-finite temperatures")
        check(o.conv is not None and o.conv.steps > 0
              and not bool(o.rad.keep_running) and not o.rad.aborted
              and not o.conv.keep_running and not o.conv.aborted,
              f"ensemble path: {o.result.name} did not converge")
    solves = batched_flux_solves(outs)
    check(launch_counts == only(noniso_sweep=solves,
                                idle=launch_counts["idle"],
                                conv_adjust=adjusts),
          f"ensemble path: launches {launch_counts} for {solves} batched "
          f"flux solves (members alone would make "
          f"{sum(o.n_flux_solves for o in outs)})")
    wall = outs[0].wall_seconds
    solo_wall = flag_out.wall_seconds
    its = [(o.rad.it, o.conv.it) for o in outs]
    log(f"ensemble path: {ENSEMBLE_P} flagship planets [{L_FLAG} layers x "
        f"{ENSEMBLE_P} x {NBIN_FLAG * NY_FLAG} = "
        f"{ENSEMBLE_P * NBIN_FLAG * NY_FLAG} columns, fp64] converged, "
        f"iterations (radiation, convection) per member {its}; {solves} "
        f"batched flux solves = {launch_counts['noniso_sweep']} noniso_sweep "
        f"launches (the members alone: {sum(o.n_flux_solves for o in outs)})")
    log(f"ensemble path walls: the batch {wall:.3f} s (radiation loop "
        f"{outs[0].rad_seconds:.3f} s, convection loop "
        f"{outs[0].conv_seconds:.3f} s) against {ENSEMBLE_P} x path a's "
        f"{solo_wall:.3f} s = {ENSEMBLE_P * solo_wall:.3f} s; "
        f"{ENSEMBLE_P / wall * 3600:.0f} planets per hour against "
        f"{3600 / solo_wall:.0f}; peak device memory {peak / 2**20:.0f} MiB "
        f"= {peak / 2**20 / ENSEMBLE_P:.0f} MiB per member")
    causes = gap_causes("ensemble path", flag_out, cfg0, table)
    fwd_same, fwd_rel = batched_vs_solo_forward(
        flag_out.phys, flag_out.arrays,
        ens.stack_models([o.arrays for o in outs]), flag_out.T_lay)
    log(f"ensemble path: one forward_fluxes of the batch against member 0's "
        f"alone at path a's final T on the card: "
        f"{'bit for bit' if fwd_same else 'not bit for bit'} (max rel "
        f"difference of the totals {fwd_rel:.3e})")
    check(fwd_same, "ensemble path: member 0's forward solve in the batch "
          "is not bit for bit its solve alone")
    same, ghost, rest = member_against(
        "ensemble path, member 0 against path a", outs[0], flag_out)
    stacked = ens.stack_models([o.arrays for o in outs])
    T0b = torch.stack([T_start] * ENSEMBLE_P, dim=1)
    bd = time_breakdown(f"{ENSEMBLE_P}-planet flagship batch", outs[0].phys,
                        stacked, T0b,
                        ("noniso_sweep", "band_integrate", "ordered_sum"))
    # the fixed order's cost: the same iterations with torch's sums
    with patched_sites(lambda n, f: TORCH_ROUTE.get(n, f)):
        bd_torch = time_breakdown(
            f"{ENSEMBLE_P}-planet flagship batch with torch's sums",
            outs[0].phys, stacked, T0b, ("noniso_sweep",))
    log(f"ensemble path: the fixed-order sums cost "
        f"{bd['busy_ms'] - bd_torch['busy_ms']:.3f} ms of device time per "
        f"batched radiation iteration ({bd['busy_ms']:.3f} against "
        f"{bd_torch['busy_ms']:.3f} ms with torch's sums, "
        f"{100 * (bd['busy_ms'] / bd_torch['busy_ms'] - 1):.1f}%) and "
        f"{bd['wall_ms'] - bd_torch['wall_ms']:.3f} ms of host wall")
    worst = totals_cuda_vs_cpu(
        "ensemble path", outs[0].phys, stacked,
        torch.stack([o.T_lay for o in outs], dim=1),
        only(noniso_sweep=1))
    return dict(wall_s=wall, solo_wall_s=solo_wall, solves=solves,
                planets_per_hour=ENSEMBLE_P / wall * 3600,
                solo_planets_per_hour=3600 / solo_wall,
                peak_mib_per_member=peak / 2**20 / ENSEMBLE_P,
                member0_bitwise=same, member0_ghost_dT=ghost,
                member0_rest_dT=rest, gap_causes=causes,
                forward_bitwise=fwd_same, forward_rel=fwd_rel,
                breakdown=bd, breakdown_torch_sums=bd_torch,
                cuda_vs_cpu=worst, iterations=its, outs=outs)


# --------------------------------------------------------------------------- #
# paths p and q: meshes of spectral slices on the one card
# --------------------------------------------------------------------------- #

SLICES = (2, 4)             # path p: 385 bins padded to 386 and to 388
MESH_MEMBERS = 4            # path q: path n's first members on a 2 x 2 mesh


def tensor_fields(x, prefix=""):
    """(dotted name, tensor) of every tensor of a NamedTuple tree."""
    for f, v in zip(x._fields, x):
        if hasattr(v, "_fields"):
            yield from tensor_fields(v, f"{prefix}{f}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + f, v


def sliced_forward_diff(phys, arrays, n, T):
    """One forward solve at T, on one device and on n slices of the card
    (gathered, the padded bins dropped): the fields of the cell cache, the
    fluxes and the totals that are not bit for bit, in the order the
    solve computes them, each with its largest difference relative to the
    field's scale."""
    from helios_tpu_torch.forward import forward_fluxes
    from helios_tpu_torch.ops import slices
    from helios_tpu_torch.parallel import sharding as shd

    pphys, parr = shd.pad_spectral(phys, arrays, n)
    m = shd.place_model(parr, shd.make_mesh(1, n, [DEVICE] * n))[0]
    whole = forward_fluxes(phys, arrays, T)
    sliced = [slices.gather(x, T.device) for x in forward_fluxes(pphys, m, T)]
    found = []
    for k, (w, g) in enumerate(zip(whole, sliced)):
        for (name, a), (_, b) in zip(tensor_fields(w, f"{k}."),
                                     tensor_fields(g, f"{k}.")):
            b = b[..., :a.shape[-1]] if b.dim() else b
            if not torch.equal(a, b):
                scale = float(a.abs().max()) or 1.0
                found.append((name, float((a - b).abs().max()) / scale))
    return found


def same_run(label, got, ref, fields=("F_up_band",)):
    """A run against the same planet's reference run: final T, both
    iteration counts and the TOA band fluxes bit for bit.  Returns
    (bitwise, max rel |dT|)."""
    counts = lambda o: (o.rad.it, o.conv.it if o.conv is not None else 0)
    same = (torch.equal(got.T_lay.cpu(), ref.T_lay.cpu())
            and counts(got) == counts(ref)
            and all(np.array_equal(getattr(got.result, f)[-1],
                                   getattr(ref.result, f)[-1])
                    for f in fields))
    rel = float(((got.T_lay.cpu() - ref.T_lay.cpu()).abs()
                 / ref.T_lay.cpu().abs()).max())
    log(f"{label}: {'bit for bit' if same else 'NOT bit for bit'} "
        f"(iterations {counts(got)} against {counts(ref)}; max rel |dT| "
        f"{rel:.3e})")
    return same, rel


def sliced_path(flag_out, flag_bd, T_start, counts_by_n):
    """Path p: path a's flagship on 2 slices of the card and on 4 (385
    bins padded to 386 and 388), through pipeline.run with
    n_spectral_shards and a device list.  Each run bit for bit path a (T, both counts, the TOA
    spectrum), or else the forward fields that differ are named and the run
    is held to rtol 1e-6; noniso_sweep launched once per slice and flux
    solve; the walls and a radiation iteration's host and device time
    against path a's.  With one card, device="cuda" and 2 slices raise the
    JAX package's RuntimeError."""
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.parallel import sharding as shd

    res = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        for n in SLICES:
            cfg, table = flagship(tmpdir, n_spectral_shards=n)
            reset_counts()
            out = pipeline.run(cfg, table, write_output=False,
                               device=[DEVICE] * n)
            counts_by_n[n].update(read_counts())
            label = f"sliced path, {n} slices"
            adjusts = adjust_count(label, loop_stats())
            check(np.all(np.isfinite(out.T_lay.cpu().numpy()))
                  and not bool(out.rad.keep_running) and not out.rad.aborted
                  and not out.conv.keep_running and not out.conv.aborted,
                  f"{label}: the run did not converge")
            solves = out.n_flux_solves
            check(counts_by_n[n] == only(noniso_sweep=n * solves,
                                         conv_adjust=adjusts),
                  f"{label}: launches {counts_by_n[n]} for {solves} flux "
                  f"solves on {n} slices")
            same, rel = same_run(f"{label} against path a", out, flag_out)
            diff = []
            if not same:
                diff = sliced_forward_diff(flag_out.phys, flag_out.arrays, n,
                                           flag_out.T_lay)
                log(f"{label}: forward fields that differ from one device "
                    f"(first computed first): {diff[:12]}")
                check(rel <= 1e-6, f"{label}: T {rel:.3e} from path a's "
                      "(limit 1e-6)")
            pphys, parr = shd.pad_spectral(out.phys, out.arrays, n)
            m = shd.place_model(parr, shd.make_mesh(1, n, [DEVICE] * n))[0]
            bd = time_breakdown(f"{n}-slice flagship", pphys, m, T_start,
                                ("noniso_sweep", "band_integrate",
                                 "ordered_sum"))
            log(f"{label}: wall {out.wall_seconds:.3f} s against path a's "
                f"{flag_out.wall_seconds:.3f} s; a radiation iteration "
                f"{bd['wall_ms']:.3f} ms of host wall and {bd['busy_ms']:.3f}"
                f" ms of device time against {flag_bd['wall_ms']:.3f} and "
                f"{flag_bd['busy_ms']:.3f} ms ({pphys.nbin} bins, "
                f"{solves} flux solves = {counts_by_n[n]['noniso_sweep']} "
                "noniso_sweep launches)")
            res[n] = dict(bitwise=same, max_rel_dT=rel, differing=diff[:12],
                          wall_s=out.wall_seconds, nbin=pphys.nbin,
                          solves=solves, breakdown=bd)
        if torch.cuda.device_count() == 1:
            cfg, table = flagship(tmpdir, n_spectral_shards=2)
            try:
                pipeline.run(cfg, table, write_output=False, device="cuda")
                raised = None
            except RuntimeError as e:
                raised = str(e)
            check(raised is not None and "n_spectral_shards=2 but only 1 "
                  "devices are visible" in raised,
                  f"sliced path: device='cuda' on one card gave {raised!r}")
            log(f"sliced path: device='cuda' with n_spectral_shards=2 on one "
                f"card raises RuntimeError({raised!r})")
    return res


def ensemble_mesh_path(tmpdir, launch_counts, members):
    """Path q: path n's first MESH_MEMBERS members through run_ensemble on
    a 2 x 2 mesh of the card (n_planet_batch 2, n_spectral_shards 2, the
    device list cuda:0 x 4): two groups of two members, each over 2 slices.
    Each member bit for bit its path-n result (T and both counts), or else
    held to rtol 1e-6; noniso_sweep launched once per slice and batched
    flux solve of each group."""
    from helios_tpu_torch.parallel import ensemble as ens

    cfg0, table = flagship(tmpdir)
    cfgs = [dataclasses.replace(cfg0, name=f"mesh_{k}",
                                surf_albedo=max(1e-8, a), n_planet_batch=2,
                                n_spectral_shards=2)
            for k, a in enumerate(ENSEMBLE_ALBEDOS[:MESH_MEMBERS])]
    reset_counts()
    outs = ens.run_ensemble(cfgs, tables=[table] * MESH_MEMBERS,
                            write_output=False, device=[DEVICE] * 4)
    launch_counts.update(read_counts())
    adjusts = adjust_count("ensemble mesh path", loop_stats())
    groups = [outs[:2], outs[2:]]
    solves = [batched_flux_solves(g) for g in groups]
    check(launch_counts == only(noniso_sweep=2 * sum(solves),
                                conv_adjust=adjusts),
          f"ensemble mesh path: launches {launch_counts} for {solves} "
          "batched flux solves of the two groups on 2 slices")
    bitwise, rels = [], []
    for k, (o, ref) in enumerate(zip(outs, members)):
        same, rel = same_run(f"ensemble mesh path, member {k} against path "
                             "n", o, ref)
        bitwise.append(same)
        rels.append(rel)
        check(same or rel <= 1e-6, f"ensemble mesh path: member {k} T "
              f"{rel:.3e} from path n's (limit 1e-6)")
    log(f"ensemble mesh path: {MESH_MEMBERS} flagship planets on a 2 x 2 "
        f"mesh of one card, wall {outs[0].wall_seconds:.3f} s (radiation "
        f"loop {outs[0].rad_seconds:.3f} s, convection loop "
        f"{outs[0].conv_seconds:.3f} s); batched flux solves per group "
        f"{solves} = {launch_counts['noniso_sweep']} noniso_sweep launches")
    return dict(bitwise=bitwise, max_rel_dT=rels, wall_s=outs[0].wall_seconds,
                solves=solves)


def capture_ensemble_main(argv, table):
    """helios_tpu_torch.__main__.main(argv) with an ensemble file in this
    process, ``table`` (when not None) handed over by
    pipeline.load_opacity_file in place of the file; returns (exit code,
    what it printed, the run_ensemble outputs)."""
    from helios_tpu_torch import __main__ as cli
    from helios_tpu_torch import pipeline
    from helios_tpu_torch.parallel import ensemble as ens

    runs, real, load = [], ens.run_ensemble, pipeline.load_opacity_file
    ens.run_ensemble = lambda *a, **k: runs.append(real(*a, **k)) or runs[-1]
    if table is not None:
        pipeline.load_opacity_file = lambda path: table
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            code = cli.main(argv, device=DEVICE)
    finally:
        ens.run_ensemble, pipeline.load_opacity_file = real, load
    return code, buf.getvalue(), runs[0]


def output_files(run_dir):
    """{name: bytes} of a run directory's output files (checkpoints
    aside)."""
    return {n: open(os.path.join(run_dir, n), "rb").read()
            for n in sorted(os.listdir(run_dir)) if not n.endswith(".npz")}


def ensemble_cli_path(k, tmpdir, launch_counts, resumed_counts):
    """Path o: the quickstart's param.dat with the shipped planets.dat
    (dark, gray and bright: surface albedo 0.0, 0.25, 0.5) through the
    command line in this process, with progress lines and a checkpoint
    every 100 iterations, the table handed over as path k's is.  Each
    member's file set; the ensemble checkpoint pair under the first
    member's directory; one noniso_sweep launch per batched flux solve
    (and per iteration replayed past the stop); the dark member bit for
    bit path k's unmonitored run; then the same
    command again, which resumes from the converged checkpoints, makes no
    flux solve and leaves the files unchanged."""
    from helios_tpu_torch import examples
    from helios_tpu_torch.config import config_from_cli

    planets = os.path.join(tmpdir, "planets.dat")
    with open(planets, "w") as f:
        f.write(examples.ENSEMBLE_TEMPLATE)
    argv = ["-parameter_file", k["param"], "-planet_ensemble_file",
            planets] + CLI_FLAGS
    out_dir = config_from_cli(["-parameter_file", k["param"]]).output_dir
    torch.cuda.synchronize()
    reset_counts()
    code, printed, outs = capture_ensemble_main(argv, k["table"])
    launch_counts.update(read_counts())
    adjusts = adjust_count("ensemble CLI", loop_stats())
    names = [o.result.name for o in outs]
    check(code == 0 and f"Done! Ensemble of {len(outs)} planets" in printed
          and names == ["dark", "gray", "bright"],
          f"ensemble CLI: exit {code}, members {names}:\n{printed[-2000:]}")
    progress = [ln for ln in printed.splitlines()
                if ln.startswith("[ensemble/")]
    check(any(ln.startswith("[ensemble/convection]") for ln in progress),
          "ensemble CLI: no convection progress line")
    solves = batched_flux_solves(outs)
    check(launch_counts == only(noniso_sweep=solves,
                                idle=launch_counts["idle"],
                                conv_adjust=adjusts),
          f"ensemble CLI: launches {launch_counts} for {solves} batched "
          "flux solves")
    files = {}
    for name in names:
        run_dir = os.path.join(out_dir, name)
        want = sorted([name + f for f in RCE_FILES]
                      + (ENSEMBLE_CKPT_FILES if name == names[0] else []))
        got = sorted(os.listdir(run_dir))
        check(got == want, f"ensemble CLI: {name} files {got}, expected "
              f"{want}")
        files[name] = output_files(run_dir)
    same, ghost, rest = member_against(
        "ensemble CLI, the dark member against path k's run", outs[0],
        k["ref"])
    wall = outs[0].wall_seconds

    torch.cuda.synchronize()
    reset_counts()
    with warnings.catch_warnings():          # the converged checkpoints
        warnings.simplefilter("ignore")
        code, printed, again = capture_ensemble_main(argv, k["table"])
    resumed_counts.update(read_counts())
    check(code == 0 and "Done! Ensemble of 3 planets" in printed,
          "ensemble CLI: the second call failed")
    # the restore rebuilds the radiation state's cells and band totals from
    # the checkpoint (ordered_sum, band_integrate), and no flux is solved
    check(all(n == 0 for name, n in resumed_counts.items()
              if name not in ("ordered_sum", "band_integrate", "idle"))
          and not any(resumed_counts["idle"].values()),
          f"ensemble CLI: the resumed call launched {resumed_counts}")
    for name in names:
        check(output_files(os.path.join(out_dir, name)) == files[name],
              f"ensemble CLI: the resumed call changed {name}'s files")
    log(f"ensemble CLI path [3 quickstart planets, {L_FLAG} layers x "
        f"{3 * NBIN_FLAG * NY_FLAG} columns, chunks of 100]: iterations "
        f"{[(o.rad.it, o.conv.it) for o in outs]}, {solves} batched flux "
        f"solves = {launch_counts['noniso_sweep']} noniso_sweep launches; "
        f"{len(progress)} progress lines; {len(RCE_FILES)} files per member "
        f"and the ensemble checkpoint pair; wall {wall:.3f} s against path "
        f"k's unmonitored {k['ref'].wall_seconds:.3f} s for one planet; the "
        f"second call resumed from the converged checkpoints in "
        f"{again[0].wall_seconds:.3f} s with no flux solve and left the "
        f"files unchanged")
    return dict(wall_s=wall, solves=solves, dark_bitwise=same,
                dark_ghost_dT=ghost, dark_rest_dT=rest,
                resumed_wall_s=again[0].wall_seconds)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from helios_tpu_torch.rce import graphs, radiative
    t_start = time.perf_counter()
    environment()
    build()

    bandwidth = copy_bandwidth()
    log(f"device-to-device copy: {bandwidth / 1e12:.3f} TB/s")
    f64 = sweep_case(torch.float64, 1e-12, bandwidth)
    f32 = sweep_case(torch.float32, 1e-4, bandwidth)
    i64 = iso_case(torch.float64, 1e-12, bandwidth)
    i32 = iso_case(torch.float32, 1e-4, bandwidth)
    t64 = thomas_case(torch.float64, 1e-12, bandwidth)
    t32 = thomas_case(torch.float32, 1e-4, bandwidth)
    g64 = ragged_case(torch.float64, 1e-12)
    g32 = ragged_case(torch.float32, 1e-4)
    c64 = chained_case(torch.float64)
    c32 = chained_case(torch.float32)
    r64 = ro_case(torch.float64, bandwidth)
    r32 = ro_case(torch.float32, bandwidth)
    q64 = ro_ragged_case(torch.float64)
    q32 = ro_ragged_case(torch.float32)
    wide = ro_wide_ny_case()
    o64 = ordered_case(torch.float64, 1e-13, bandwidth)
    o32 = ordered_case(torch.float32, 1e-4, bandwidth)
    b64 = band_integrate_case(torch.float64)
    b32 = band_integrate_case(torch.float32)
    a64 = adjust_case(torch.float64)
    a32 = adjust_case(torch.float32)
    host_us_by_step = launch_breakdown()
    host_tools_phase()
    # the same kernels at an ensemble's width: P = 8 planets' columns
    ens_S = ENSEMBLE_P * NBIN_FLAG * NY_FLAG
    e64 = sweep_case(torch.float64, 1e-12, bandwidth, S=ens_S)
    ei64 = iso_case(torch.float64, 1e-12, bandwidth, S=ens_S)
    et64 = thomas_case(torch.float64, 1e-12, bandwidth, S=ens_S)
    er64 = ro_case(torch.float64, bandwidth,
                   C=ENSEMBLE_P * L_FLAG * NBIN_FLAG)

    counts = {p: {} for p in ("flagship_rce", "post_processing", "iso_rce",
                              "matrix_rce", "matrix_post_processing",
                              "on_the_fly_rce",
                              "on_the_fly_post_processing", "cloudy_rce",
                              "cloudy_post_processing", "rocky_rce",
                              "bare_rock_rce", "cloudy_matrix_forward",
                              "quickstart_cli", "resumed_radiation",
                              "resumed_convection", "real_gas_coupling_0",
                              "real_gas_coupling_1",
                              "real_gas_post_processing",
                              "real_gas_convection", "flagship_ensemble",
                              "ensemble_cli", "ensemble_cli_resumed",
                              "sliced_flagship_2", "sliced_flagship_4",
                              "ensemble_mesh")}
    with checked_integrations():
        out, T_start = main_path(counts["flagship_rce"])
        T_start = torch.as_tensor(T_start, dtype=out.T_lay.dtype,
                                  device=DEVICE)
        flag_kernels = ("noniso_sweep", "band_integrate", "ordered_sum")
        const_kappa = radiative.make_const_thermo(FLAGSHIP["kappa_value"])
        # the graphed loops and the per-iteration loop, in turns
        flag_bd = time_breakdown("flagship", out.phys, out.arrays, T_start,
                                 flag_kernels)
        flag_bd_per = time_breakdown(
            "flagship, per-iteration loop", out.phys, out.arrays, T_start,
            flag_kernels, per_iteration=True)
        flag_conv_per = conv_breakdown(
            "flagship, per-iteration loop", out, const_kappa,
            flag_kernels + ("conv_adjust",), per_iteration=True)
        flag_conv = conv_breakdown("flagship", out, const_kappa,
                                   flag_kernels + ("conv_adjust",))
        with patched_sites(lambda n, f: TORCH_ROUTE.get(n, f)):
            flag_torch = time_breakdown(
                "flagship with torch's sums", out.phys, out.arrays, T_start,
                ("noniso_sweep",))
        log(f"flagship: the fixed-order sums cost "
            f"{flag_bd['busy_ms'] - flag_torch['busy_ms']:.3f} ms of device "
            f"time and {flag_bd['wall_ms'] - flag_torch['wall_ms']:.3f} ms of "
            f"host wall per radiation iteration")
        with tempfile.TemporaryDirectory() as ens_dir:
            ens = ensemble_path(ens_dir, counts["flagship_ensemble"], out,
                                T_start)
            mesh_q = ensemble_mesh_path(ens_dir, counts["ensemble_mesh"],
                                        ens["outs"][:MESH_MEMBERS])
        sliced_p = sliced_path(out, flag_bd, T_start, {
            n: counts[f"sliced_flagship_{n}"] for n in SLICES})
        pp = postprocessing_path(out, counts["post_processing"],
                                 i64["ms_1001"])
        iso_rce_path(counts["iso_rce"])
        mat = matrix_path(out, counts["matrix_rce"])
        # the profiler names kernels by their CUDA symbol: thomas_kernel
        mat_bd = time_breakdown("matrix flagship", mat["out"].phys,
                                mat["out"].arrays, T_start,
                                ("thomas", "noniso_sweep"))
        mat_conv = conv_breakdown("matrix flagship", mat["out"], const_kappa,
                                  ("thomas", "noniso_sweep"))
        mat_bd_per = time_breakdown(
            "matrix flagship, per-iteration loop", mat["out"].phys,
            mat["out"].arrays, T_start, ("thomas", "noniso_sweep"),
            per_iteration=True)
        mat_conv_per = conv_breakdown(
            "matrix flagship, per-iteration loop", mat["out"], const_kappa,
            ("thomas", "noniso_sweep"), per_iteration=True)
        matrix_postprocessing_path(out, counts["matrix_post_processing"],
                                   pp["toa"])
        otf = otf_path(counts["on_the_fly_rce"],
                       counts["on_the_fly_post_processing"])
        with tempfile.TemporaryDirectory() as cloud_dir:
            cl = cloudy_path(cloud_dir, counts["cloudy_rce"])
            postprocessing_path(cl["out"], counts["cloudy_post_processing"],
                                i64["ms_1001"], cfg_kw=cl["cfg_kw"],
                                extra_files=CLOUD_FILES,
                                label="cloudy post-processing path")
            cloudy_matrix_path(cl, counts["cloudy_matrix_forward"])
        rocky_path(counts["rocky_rce"])
        bare_rock_path(counts["bare_rock_rce"])
        with tempfile.TemporaryDirectory() as cli_dir:
            k = quickstart_path(cli_dir, counts["quickstart_cli"])
            resume_path(k, cli_dir, counts["resumed_radiation"],
                        counts["resumed_convection"])
            ensemble_cli_path(k, cli_dir, counts["ensemble_cli"],
                              counts["ensemble_cli_resumed"])
        with tempfile.TemporaryDirectory() as gas_dir:
            water = write_water_table(os.path.join(gas_dir, "water_atmo.dat"))
            real_gas_path(gas_dir, water, counts["real_gas_coupling_0"],
                          counts["real_gas_coupling_1"],
                          counts["real_gas_post_processing"])
            tc = table_convection_path(gas_dir, water,
                                  counts["real_gas_convection"], out)
    for path, c in counts.items():
        log(f"launches on the {path} path: {c}")
    log(f"flux integrations checked: {INTEGRATIONS['calls']}, "
        f"{INTEGRATIONS['on_card']} on the card with "
        f"{INTEGRATIONS['launches']} band_integrate launches (one per "
        "slice) and no ordered_sum")

    per_it = lambda bd: {k: bd[k] for k in ("wall_ms", "busy_ms", "kernels",
                                           "reads_per_iteration")}
    per = MAIN_PATH["per_iteration"]
    log("device loops: " + json.dumps(dict(
        flagship=dict(
            loops=MAIN_PATH["stats"], wall_s=out.wall_seconds,
            per_iteration_wall_s=per.wall_seconds,
            radiation=per_it(flag_bd), convection=per_it(flag_conv),
            radiation_per_iteration_loop=per_it(flag_bd_per),
            convection_per_iteration_loop=per_it(flag_conv_per)),
        matrix=dict(loops=mat["loops"], wall_s=mat["wall_s"],
                    per_iteration_wall_s=mat["per_iteration_wall_s"],
                    radiation=per_it(mat_bd), convection=per_it(mat_conv),
                    radiation_per_iteration_loop=per_it(mat_bd_per),
                    convection_per_iteration_loop=per_it(mat_conv_per)),
        on_the_fly=dict(loops=otf["loops"], wall_s=otf["wall_s"],
                        per_iteration_wall_s=otf["per_iteration_wall_s"],
                        radiation=per_it(otf),
                        radiation_per_iteration_loop=per_it(
                            otf["per_iteration"])),
        cloudy=dict(loops=cl["loops"], wall_s=cl["wall_s"],
                    radiation=per_it(cl["breakdown"]),
                    convection=per_it(cl["conv_breakdown"])),
        table_convection=dict(
            loops=tc["loops"], wall_s=tc["wall_s"],
            per_iteration_wall_s=tc["per_iteration_wall_s"],
            convection=per_it(tc["conv_breakdown"]),
            convection_per_iteration_loop=per_it(
                tc["conv_per_iteration"])))))
    by_path = lambda name: {path: c[name] for path, c in counts.items()}
    # of a kernel's launches on a path, those of loop iterations that
    # changed nothing (replayed past the stop, a redone chunk's first try)
    idle_of = lambda path, name: counts[path].get("idle", {}).get(name, 0)
    pick = lambda res, keys: {k: res[k] for k in keys}
    base = ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_ms_measured_bw")
    noniso = dict(
        name="noniso_sweep", route="cuda",
        source="helios_tpu_torch/csrc/noniso_sweep.cu",
        replaces="helios_tpu/kernels/sweep_pallas.py:234",
        launches=counts["flagship_rce"]["noniso_sweep"],
        idle_launches=idle_of("flagship_rce", "noniso_sweep"),
        max_abs_err=f64["max_abs_err"], ms=f64["ms"],
        plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"],
        bound_by=f64["bound_by"], library_ms=None,
        launches_by_path=by_path("noniso_sweep"), passes=PASSES,
        max_rel_err=f64["max_rel_err"],
        bound_ms_measured_bw=f64["bound_ms_measured_bw"],
        also_replaces="helios_tpu/kernels/sweep_pallas.py:162",
        sliced_bitwise={n: r["bitwise"] for n, r in sliced_p.items()},
        ensemble_mesh_bitwise=mesh_q["bitwise"],
        ragged_max_rel_err=dict(fp64=g64["noniso_sweep"],
                                fp32=g32["noniso_sweep"]),
        max_rel_err_7_1001_passes=dict(fp64=g64["noniso_sweep_7_1001"],
                                       fp32=g32["noniso_sweep_7_1001"]),
        chained_passes_bitwise=dict(fp64=c64["noniso_sweep"],
                                    fp32=c32["noniso_sweep"]),
        fp32=pick(f32, base),
        ensemble=dict(pick(e64, base), columns=ens_S))
    iso = dict(
        name="iso_sweep", route="cuda",
        source="helios_tpu_torch/csrc/iso_sweep.cu",
        replaces="helios_tpu/kernels/sweep_pallas.py:75",
        launches=counts["post_processing"]["iso_sweep"],
        idle_launches=idle_of("post_processing", "iso_sweep"),
        max_abs_err=i64["max_abs_err"], ms=i64["ms"],
        plain_ms=i64["plain_ms"], bound_ms=i64["bound_ms"],
        bound_by=i64["bound_by"], library_ms=None,
        launches_by_path=by_path("iso_sweep"), passes=PASSES,
        max_rel_err=i64["max_rel_err"],
        bound_ms_measured_bw=i64["bound_ms_measured_bw"],
        ms_1001=i64["ms_1001"], bound_ms_1001=i64["bound_ms_1001"],
        bound_by_1001=i64["bound_by_1001"],
        also_replaces="helios_tpu/kernels/sweep_pallas.py:27",
        ragged_max_rel_err=dict(fp64=g64["iso_sweep"], fp32=g32["iso_sweep"]),
        chained_passes_bitwise=dict(fp64=c64["iso_sweep"],
                                    fp32=c32["iso_sweep"]),
        fp32=pick(i32, base + ("ms_1001", "bound_ms_1001", "bound_by_1001",
                               "max_rel_err_vs_fp64_1001")),
        ensemble=dict(pick(ei64, base), columns=ens_S))
    tn, ti = t64["noniso"], t64["iso"]
    thomas = dict(
        name="thomas_solve", route="cuda",
        source="helios_tpu_torch/csrc/thomas.cu",
        replaces="helios_tpu/kernels/thomas_pallas.py:31",
        launches=counts["matrix_rce"]["thomas_solve"],
        idle_launches=idle_of("matrix_rce", "thomas_solve"),
        max_abs_err=max(tn["max_abs_err"], ti["max_abs_err"]),
        ms=tn["ms"], plain_ms=tn["plain_ms"], bound_ms=tn["bound_ms"],
        bound_by=tn["bound_by"], library_ms=None,
        library="none: no single PyTorch call solves a batched "
                "tridiagonal system",
        launches_by_path=by_path("thomas_solve"), rows=tn["n"],
        max_rel_err=max(tn["max_rel_err"], ti["max_rel_err"]),
        bound_ms_measured_bw=tn["bound_ms_measured_bw"],
        iso=pick(ti, base + ("n",)),
        ragged_max_rel_err=dict(fp64=g64["thomas_solve"],
                                fp32=g32["thomas_solve"]),
        fp32={k: pick(t32[k], base + ("n",)) for k in t32},
        ensemble={k: dict(pick(et64[k], base + ("n",)), columns=ens_S)
                  for k in et64})
    ro = dict(
        name="ro_mix", route="cuda",
        source="helios_tpu_torch/csrc/ro_mix.cu",
        replaces="helios_tpu/kernels/ro_pallas.py:225",
        launches=counts["on_the_fly_rce"]["ro_mix"],
        idle_launches=idle_of("on_the_fly_rce", "ro_mix"),
        max_abs_err=r64["max_abs_err"], ms=r64["ms"],
        plain_ms=r64["plain_ms"], bound_ms=r64["bound_ms"],
        bound_by=r64["bound_by"], library_ms=None,
        library="none: torch.sort alone does not compute the function",
        launches_by_path=by_path("ro_mix"), cells=r64["C"],
        negligible_cells=r64["negligible_cells"],
        max_rel_err=r64["max_rel_err"],
        bound_ms_measured_bw=r64["bound_ms_measured_bw"],
        bitwise_vs_plain=True,
        ragged=dict(ny=RO_RAGGED_NY, fp64=q64, fp32=q32),
        wide_ny_fp32=wide,
        general_cells=dict(flagship_inputs=r64["general_cells"],
                           on_the_fly=otf["general_cells"],
                           on_the_fly_of=otf["general_cells_of"]),
        fp32=pick(r32, base),
        ensemble=dict(pick(er64, base), cells=er64["C"]))
    ordered = dict(
        name="ordered_sum", route="cuda",
        source="helios_tpu_torch/csrc/ordered_sum.cu",
        replaces="helios_tpu/forward.py:668 (jnp.sum of the band totals, "
                 "no pallas_call: the loops' sums and scans in a fixed "
                 "order, ROADMAP C.8)",
        launches=counts["flagship_rce"]["ordered_sum"],
        idle_launches=idle_of("flagship_rce", "ordered_sum"),
        max_abs_err=o64["max_abs_err"], ms=o64["ms"],
        plain_ms=o64["plain_ms"], bound_ms=o64["bound_ms"],
        bound_by=o64["bound_by"], library_ms=o64["plain_ms"],
        library="torch.sum, which is also the plain version",
        launches_by_path=by_path("ordered_sum"),
        max_rel_err=o64["max_rel_err"],
        bound_ms_measured_bw=o64["bound_ms_measured_bw"],
        in_order_ms=o64["in_order_ms"], bitwise_vs_in_order=True,
        cases=o64["cases"],
        fp32=pick(o32, base + ("in_order_ms", "device_ms")),
        device_ms=o64["device_ms"],
        ensemble={k: o64["ensemble_" + k] for k in (
            "ms", "device_ms", "plain_ms", "in_order_ms", "bound_ms",
            "bound_by")},
        host_us_by_step=host_us_by_step)
    integrate = dict(
        name="band_integrate", route="cuda",
        source="helios_tpu_torch/csrc/band_integrate.cu",
        replaces="helios_tpu/fastpath.py:692 and helios_tpu/forward.py:"
                 "662-673 (gauss_band_flat and the band totals, no "
                 "pallas_call: on the card the port's chain of 14 launches "
                 "and F_net)",
        launches=counts["flagship_rce"]["band_integrate"],
        idle_launches=idle_of("flagship_rce", "band_integrate"),
        max_abs_err=b64["max_abs_err"], ms=b64["ms"],
        plain_ms=b64["plain_ms"], bound_ms=b64["bound_ms"],
        bound_by=b64["bound_by"], library_ms=None,
        library="none: no single PyTorch call computes the bands and the "
                "totals",
        launches_by_path=by_path("band_integrate"),
        bitwise_vs_in_order=True, chain_ms=b64["chain_ms"],
        device_ms=b64["device_ms"], rows=b64["rows"],
        fp32={k: b32[k] for k in ("ms", "chain_ms", "plain_ms", "device_ms",
                                  "bound_ms", "bound_by")},
        ensemble={k: b64["ensemble_" + k] for k in (
            "ms", "chain_ms", "plain_ms", "device_ms", "bound_ms",
            "bound_by", "rows")},
        integrations_checked=dict(INTEGRATIONS))
    conv_adjust = dict(
        name="conv_adjust", route="cuda",
        source="helios_tpu_torch/csrc/conv_adjust.cu",
        replaces="none: helios_tpu/rce/convect.py has no pallas_call (on "
                 "the card the port's chain of ops of the convective "
                 "adjustment, convect.plain_adjustment)",
        launches=counts["flagship_rce"]["conv_adjust"],
        idle_launches=idle_of("flagship_rce", "conv_adjust"),
        max_abs_err=0.0, ms=a64["ms"], plain_ms=a64["chain_ms"],
        bound_ms=None, bound_by="latency: the chains of dependent adds, "
                                "pow, log and exp of one column",
        library_ms=None,
        library="none: no PyTorch call computes the adjustment (the chain "
                "of ops it replaces is the yardstick)",
        launches_by_path=by_path("conv_adjust"), bitwise_vs_chain=True,
        **{k: a64[k] for k in ("device_ms", "graphed_ms", "chain_graphed_ms",
                               "chain_device_ms", "chain_launches",
                               "rounds_needed")},
        fp32={k: a32[k] for k in ("ms", "device_ms", "graphed_ms",
                                  "chain_ms", "chain_graphed_ms",
                                  "chain_device_ms")},
        ensemble={k: a64["ensemble_" + k] for k in (
            "ms", "device_ms", "graphed_ms", "chain_ms", "chain_graphed_ms",
            "chain_device_ms", "chain_launches", "columns")})
    log(f"matrix flagship converged: {mat['converged']}; chip_smoke took "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [noniso, iso, thomas, ro, ordered,
                                  integrate, conv_adjust]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        PATH_LOOPS.close()      # the last path's runners, before shutdown
    sys.exit(code)

"""Run observability (port of :mod:`helios_tpu.monitor`): the chunked
iteration runner, progress lines, structured metrics, realtime plots,
debug checks, mid-run coupling TP writes and a profiler trace.

The reference prints converged-layer counts and the wall time per 100
iterations (computation.py:902-905, 934-935) and draws a live matplotlib
panel every ``n_plot`` iterations (realtime_plotting.py:37-151).  Here the
loops run ``chunk_iters`` iterations per call (the ``max_steps`` /
``state0`` continuation of the loops, which the checkpointer uses too);
between chunks every registered callback sees the current state.  A chunk
adds no arithmetic to an iteration, so the chunked trajectory is bit for
bit the straight one; it costs one host sync per chunk on top of the
loops' own reads of the device.  A chunk is a loop call like any other: a
whole model's runner, its CUDA graphs and buffers, is kept from one call
to the next (and from one run to the next of the same shapes,
``rce.graphs``), a sliced model's made anew for each chunk.

Callbacks:
  - ProgressPrinter:  reference-style progress lines
  - MetricsWriter:    one JSON object per chunk to a .jsonl file
  - PlotCallback:     drives plotting.Plot (live or saved frames)
  - DebugChecker:     finiteness and negative-flux checks (``debug``)
  - CouplingTPWriter: coupling TP file every N iterations
Profiling: with ``profile_dir`` the second chunk of the radiation loop runs
under ``torch.profiler`` and its Chrome trace is written there (the first
chunk includes the kernels' first-use build and load); the trace holds the
loop's ``helios.*`` ranges (``tracing.span``).

On a mesh (``mesh``, :mod:`helios_tpu_torch.parallel.sharding`) each chunk
runs over the slices and the planet positions, and between chunks the state
is whole on the home device, so that every callback reads it as a run on
one device gives it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from helios_tpu_torch.forward import ModelArrays, Phys
from helios_tpu_torch.ops.members import loop_counter, running_members
from helios_tpu_torch.parallel import sharding as shd
from helios_tpu_torch.rce.loop import convection_loop
from helios_tpu_torch.rce.radiative import (RadLoopState, init_rad_state,
                                            radiation_loop)


class ChunkInfo(NamedTuple):
    state: RadLoopState    # or ConvLoopState in the convection phase
    its_done: int          # iterations in this chunk
    wall_s: float          # wall time of this chunk (device finished)
    phase: str             # "radiation" | "convection"
    includes_compile: bool = False   # the first chunk of a loop: in a new
    #                                  process its wall includes the
    #                                  kernels' first-use build and load,
    #                                  so its ms/iter is not steady-state


Callback = Callable[[ChunkInfo], None]


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _run_chunks(state, step, phase: str, callbacks: Sequence[Callback],
                profile_dir: Optional[str] = None):
    """Call ``step`` until the state stops (every member of a batch), the
    callbacks after each call; the second call under the profiler when
    ``profile_dir`` is set."""
    chunk_idx = 0
    while running_members(state).any():
        it_before = loop_counter(state)
        t0 = time.perf_counter()
        if chunk_idx == 1 and profile_dir:
            state = _profiled(step, state, profile_dir)
        else:
            state = step(state)
            _sync(state.T_lay)
        info = ChunkInfo(state=state,
                         its_done=loop_counter(state) - it_before,
                         wall_s=time.perf_counter() - t0, phase=phase,
                         includes_compile=(chunk_idx == 0))
        for cb in callbacks:
            cb(info)
        chunk_idx += 1
    return state


def _profiled(step, state, profile_dir: str):
    """One chunk under torch.profiler (CPU, and CUDA on the card); the
    Chrome trace goes to ``profile_dir/trace_<pid>.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if state.T_lay.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        state = step(state)
        _sync(state.T_lay)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"trace_{os.getpid()}.json"))
    return state


def run_radiation_chunked(phys: Phys, m: ModelArrays, thermo, T_lay0, *,
                          chunk_iters: Optional[int] = 100, sset=None,
                          callbacks: Sequence[Callback] = (),
                          state0: Optional[RadLoopState] = None,
                          profile_dir: Optional[str] = None,
                          mesh: Optional[shd.Mesh] = None) -> RadLoopState:
    """Radiation loop with host observation every ``chunk_iters`` steps
    (None: one chunk).  The same trajectory as the straight loop, bit for
    bit: a chunk is one call of the loop with ``max_steps``.  ``state0``
    resumes from a restored state.  A post-processing run is one flux
    solve, with no callbacks.  ``mesh``: the loop runs on this mesh, ``m``
    and ``sset`` placed on it (sharding.place_model, place_species)."""
    if mesh is not None:
        rad_init, rad_run, _, _ = shd.production_runners(
            phys, mesh, thermo, sset, chunk_iters=chunk_iters)
        state = state0 if state0 is not None else rad_init(m, T_lay0)
        if phys.singlewalk:
            return rad_run(m, state)
        step = lambda s: rad_run(m, s)
    else:
        if phys.singlewalk:
            return radiation_loop(phys, m, thermo, T_lay0, sset=sset)
        state = state0 if state0 is not None else init_rad_state(
            phys, m, T_lay0, sset)
        step = lambda s: radiation_loop(phys, m, thermo, s.T_lay,
                                        max_steps=chunk_iters, sset=sset,
                                        state0=s)
    return _run_chunks(state, step, "radiation", callbacks, profile_dir)


def run_convection_chunked(phys: Phys, m: ModelArrays, thermo, rad, *,
                           chunk_iters: Optional[int] = 100, sset=None,
                           callbacks: Sequence[Callback] = (),
                           state0=None, mesh: Optional[shd.Mesh] = None):
    """Convection loop with host observation every ``chunk_iters`` steps
    (the same continuation as run_radiation_chunked).  ``state0`` resumes
    from a restored ConvLoopState instead of entering from the radiation
    result ``rad``.  ``mesh``: as in run_radiation_chunked."""
    if mesh is not None:
        _, _, conv_enter, conv_run = shd.production_runners(
            phys, mesh, thermo, sset, chunk_iters=chunk_iters)
        state = state0 if state0 is not None else conv_enter(m, rad)
        step = lambda s: conv_run(m, s)
    else:
        state = state0 if state0 is not None else convection_loop(
            phys, m, thermo, rad, max_steps=0, sset=sset)
        step = lambda s: convection_loop(phys, m, thermo, rad,
                                         max_steps=chunk_iters, sset=sset,
                                         state0=s)
    return _run_chunks(state, step, "convection", callbacks)


def _converged_layers(state) -> int:
    """Converged-layer count of either loop state: the radiation loop
    carries per-layer abort flags; the convection loop marks the
    non-converged radiative layers as marked_red."""
    if hasattr(state, "abort"):
        return int(state.abort.sum())
    return int((~state.marked_red).sum())


class ProgressPrinter:
    """Reference-style progress lines (computation.py:902-905, 934-935)."""

    def __init__(self, nlayer: int, stream=None):
        self.nlayer = nlayer
        self.stream = stream

    def __call__(self, info: ChunkInfo) -> None:
        s = info.state
        line = (f"[{info.phase[:4]}] iteration {int(s.it):6d} "
                f"| converged layers "
                f"{_converged_layers(s)}/{self.nlayer + 1} | criterion "
                f"{float(s.local_limit):.1e} | "
                f"{info.wall_s / max(info.its_done, 1) * 1e3:6.2f} ms/iter"
                f" ({info.its_done / max(info.wall_s, 1e-9):7.1f} it/s)"
                + (" [incl. first launch]" if info.includes_compile else ""))
        print(line, file=self.stream, flush=True)


class MetricsWriter:
    """Structured metrics: one JSON object per chunk, append-only.

    Opens in append mode so a resumed (checkpoint-restored) run keeps the
    previous history; each construction writes a run-start marker record
    instead of truncating."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"event": "run_start",
                                 "time": time.time()}) + "\n")

    def __call__(self, info: ChunkInfo) -> None:
        s = info.state
        rec = {
            "phase": info.phase,
            "iteration": int(s.it),
            "chunk_iters": info.its_done,
            "wall_s": round(info.wall_s, 6),
            "it_per_s": round(info.its_done / max(info.wall_s, 1e-9), 2),
            "includes_compile": bool(info.includes_compile),
            "converged_layers": _converged_layers(s),
            "criterion": float(s.local_limit),
            "T_min": float(s.T_lay.min()),
            "T_max": float(s.T_lay.max()),
            "F_net_toa": float(s.totals.F_net[-1]),
        }
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


class PlotCallback:
    """Realtime TP / flux panel per chunk (the reference draws every
    n_plot iterations; the pipeline caps the chunk at n_plot).  ``p_boa``
    and ``p_toa`` [10^-6 bar] bound the pressure axis."""

    def __init__(self, phys: Phys, p_boa: float, p_toa: float,
                 interactive: bool = True, save_dir: Optional[str] = None):
        from helios_tpu_torch.plotting import Plot
        self.phys = phys
        self.p_boa, self.p_toa = float(p_boa), float(p_toa)
        self.plot = Plot(interactive=interactive)
        self.save_dir = save_dir
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    def __call__(self, info: ChunkInfo) -> None:
        s = info.state
        h = lambda x: x.detach().cpu().numpy()
        save = (os.path.join(self.save_dir, f"frame_{int(s.it):06d}.png")
                if self.save_dir else None)
        if hasattr(s, "abort"):
            marked_red, conv_layer = ~h(s.abort), None
        else:
            marked_red, conv_layer = h(s.marked_red), h(s.conv_layer)
        self.plot.plot_tp_and_flux(
            T_lay=h(s.T_lay), F_net=h(s.totals.F_net),
            F_intern=self.phys.F_intern, p_boa=self.p_boa, p_toa=self.p_toa,
            marked_red=marked_red, conv_layer=conv_layer,
            iter_value=int(s.it), savefig=save)
        if self.plot.interactive:
            import matplotlib.pyplot as plt
            plt.pause(0.001)


class DebugChecker:
    """``debug = yes`` runtime diagnostics.

    The reference's debug mode warns from inside its CUDA kernels on
    negative spectral fluxes (kernels.cu:1456-1459).  Here the loop state
    is checked at every chunk boundary: non-finite temperatures or fluxes
    raise FloatingPointError, negative fluxes are counted and printed as
    warnings."""

    def __init__(self, stream=None):
        self.stream = stream

    def __call__(self, info: ChunkInfo) -> None:
        s = info.state
        it = int(s.it)
        T = np.asarray(s.T_lay.detach().cpu())
        if not np.all(np.isfinite(T)):
            raise FloatingPointError(
                f"[debug] non-finite temperature at iteration {it}: {T}")
        for name in ("F_down", "F_up"):
            arr = np.asarray(getattr(s.flux, name).detach().cpu())
            if not np.all(np.isfinite(arr)):
                raise FloatingPointError(
                    f"[debug] non-finite {name} at iteration {it}")
            neg = int((arr < 0).sum())
            if neg:
                print(f"[debug] WARNING: {neg} negative {name} values "
                      f"at iteration {it} (kernels.cu:1456-1459 "
                      "debug warning analogue)",
                      file=self.stream, flush=True)


class CouplingTPWriter:
    """Mid-run coupling TP writes every ``interval`` iterations (reference
    computation.py:967-971, write.py:716-771): an external chemistry code
    watches this file to iterate against a live run."""

    def __init__(self, path: str, nlayer: int, p_lay, p_int,
                 interval: int):
        self.path = path
        self.nlayer = nlayer
        self.p_lay = np.asarray(p_lay)
        self.p_int = np.asarray(p_int)
        self.interval = max(int(interval), 1)
        self._last = None

    def __call__(self, info: ChunkInfo) -> None:
        from helios_tpu_torch.io.writers import write_tp_coupling_snapshot
        it = int(info.state.it)
        if self._last is not None and it - self._last < self.interval:
            return
        self._last = it
        write_tp_coupling_snapshot(
            self.path, self.nlayer, self.p_lay, self.p_int,
            info.state.T_lay.detach().cpu().numpy())

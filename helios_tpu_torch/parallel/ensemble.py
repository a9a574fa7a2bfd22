"""Planet ensembles: one command, N atmospheres (port of
:mod:`helios_tpu.parallel.ensemble`).

The reference runs one planet per process.  An ensemble runs N planets as
one batched computation: every tensor of the loops carries a planet axis
after its layer axis ([L+1, P] temperatures, [L, P, S] spectral arrays,
[P, S] boundary rows), so each flux solve is one kernel launch over the
P*S spectral columns of the batch and the host issues the same launches
for P planets as for one.  The loops iterate while any member runs; a
member that has converged keeps the state of its own last iteration (the
JAX package's ``vmap`` of its ``while_loop`` does the same), so each
member ends as its run alone would.

Members share the compile-time physics (``Phys``: grid shapes and scalar
parameters).  Everything in ``ModelArrays`` may differ per planet
(stellar spectrum, surface albedo, cloud decks, additional heating,
opacity table), as may the initial TP profile.  Config 0 drives the
shared machinery: the thermodynamics source, the species set of
on-the-fly mixing, chunking, progress and checkpoints.

With ``n_planet_batch`` > 1 and ``n_planet_batch`` x ``n_spectral_shards``
devices at hand, the batch runs on a ("planet", "spectral") mesh
(:mod:`helios_tpu_torch.parallel.sharding`), as the JAX package's does:
the members split into ``n_planet_batch`` groups of consecutive members,
each group a batch over its ``n_spectral_shards`` slices (the bin axis
padded to a multiple of them), the groups one after another in every chunk;
with fewer devices it runs on one.  Between chunks the batch's state is
whole on the home device, so the progress lines and the one checkpoint
pair hold every member.
"""

from __future__ import annotations

import copy
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from helios_tpu_torch import checkpoint as ckpt_mod
from helios_tpu_torch import pipeline as pl
from helios_tpu_torch.config import HeliosConfig
from helios_tpu_torch.device import torch_dtype
from helios_tpu_torch.forward import ModelArrays, Phys
from helios_tpu_torch.io import writers
from helios_tpu_torch.monitor import (run_convection_chunked,
                                      run_radiation_chunked)
from helios_tpu_torch.ops.members import (MODEL_AXIS, member_state,
                                          running_members)
from helios_tpu_torch.parallel import sharding as shd
from helios_tpu_torch.rce import graphs

def stack_models(models: Sequence[ModelArrays]) -> ModelArrays:
    """N ModelArrays as one batch: each field with the planet axis where
    the batched loops read it (``members.MODEL_AXIS``).  A field equal in
    every member is an expanded view of member 0's tensor (no copy); the
    Gauss points, set by ``ny``, must be equal."""
    fields = {}
    for name in ModelArrays._fields:
        xs = [getattr(m, name) for m in models]
        same = all(torch.equal(xs[0], x) for x in xs[1:])
        axis = MODEL_AXIS[name]
        if axis is None:
            if not same:
                raise ValueError(f"ensemble members must share {name}")
            fields[name] = xs[0]
        elif same:
            x = xs[0].unsqueeze(axis)
            shape = list(x.shape)
            shape[axis] = len(xs)
            fields[name] = x.expand(shape)
        else:
            fields[name] = torch.stack(xs, dim=axis)
    return ModelArrays(**fields)


def _check_same_phys(physes: Sequence[Phys]) -> Phys:
    p0 = physes[0]
    for i, p in enumerate(physes[1:], 1):
        if p != p0:
            diff = [f for f in p0.__dataclass_fields__
                    if getattr(p, f) != getattr(p0, f)]
            raise ValueError(
                "ensemble members must share the compile-time physics; "
                f"config {i} differs from config 0 in {diff}. Per-planet "
                "variation goes through ModelArrays (star, albedo, "
                "clouds, heating, opacity) and the initial TP profile.")
    return p0


class EnsembleProgress:
    """Chunk callback: ``[ensemble/<phase>] iters=a..b  converged k/N
    planets  (x s/chunk)``, as the JAX package's ensemble prints it."""

    def __init__(self, n_planets: int, stream=None):
        self.n_planets = n_planets
        self.stream = stream

    def __call__(self, info) -> None:
        its = np.asarray(info.state.it).astype(int)
        n_done = int((~running_members(info.state)).sum())
        stream = self.stream or sys.stdout
        stream.write(f"[ensemble/{info.phase}] iters={its.min()}..{its.max()}"
                     f"  converged {n_done}/{self.n_planets} planets  "
                     f"({info.wall_s:.1f} s/chunk)\n")
        stream.flush()


def ensemble_mesh(cfg0: HeliosConfig, device):
    """The JAX package's ensemble mesh (helios_tpu/parallel/ensemble.py:
    364-372): n_planet_batch x n_spectral_shards devices when
    ``n_planet_batch`` > 1 and that many are at hand (see
    sharding.visible_devices), else None (one device)."""
    n_pl = int(cfg0.n_planet_batch)
    if n_pl <= 1:
        return None
    n_spec = max(int(cfg0.n_spectral_shards), 1)
    devs = shd.visible_devices(device, n_pl * n_spec)
    if len(devs) < n_pl * n_spec:
        return None
    return shd.make_mesh(n_pl, n_spec, devs[:n_pl * n_spec])


def ensemble_chunk(cfg0: HeliosConfig, phys: Phys) -> Optional[int]:
    """Iterations per chunk of an ensemble, by the JAX package's ensemble
    rule (helios_tpu/parallel/ensemble.py:349-357): None (one straight
    run) without progress lines and checkpoints or in a single-walk run;
    else ``chunk_iters``, capped at ``checkpoint_every`` when checkpoints
    are on, rounded down to the 10-iteration cache-refresh cadence, at
    least 10.  Unlike a single run's (pipeline.monitored_chunk), the plot
    interval plays no part: an ensemble draws no plots."""
    if not (cfg0.progress or cfg0.checkpoint_every > 0) or phys.singlewalk:
        return None
    chunk = cfg0.chunk_iters
    if cfg0.checkpoint_every > 0:
        chunk = min(chunk, cfg0.checkpoint_every)
    return max(chunk // 10 * 10, 10)


def run_ensemble(cfgs: Sequence, tables: Optional[Sequence] = None,
                 write_output: bool = True, sset=None,
                 device="cuda") -> List[pl.RunOutput]:
    """:func:`helios_tpu_torch.pipeline.run` for N planets in one batch.

    Each config gets its own output directory and files, as a run of its
    own writes them; the loops run batched (every flux solve one kernel
    launch for all members).  Compile-time physics (``Phys``) must match
    across members.  With progress or checkpoints (config 0's) the loops
    run in chunks of :func:`helios_tpu_torch.pipeline.monitored_chunk`
    iterations with a progress line per chunk and one checkpoint pair for
    the batch, and a second call resumes from it.
    ``device`` defaults to CUDA; ``device="cpu"`` runs the plain kernel
    versions.  With ``n_planet_batch`` > 1 (config 0's) the batch runs on
    the mesh of :func:`ensemble_mesh`: the first visible CUDA devices for
    "cuda", the CPU for "cpu", or a sequence of devices (one per mesh
    position, row by row; a device may repeat); the member count must
    divide by ``n_planet_batch``.  Returns one RunOutput per member; the
    walls are the batch's, its spans those of ``pipeline.run``."""
    with graphs.span("helios.run") as whole:
        with graphs.span("helios.prepare"):
            dev = shd.home_device(device)
            cfgs = [c if c._finalized else c.finalize() for c in cfgs]
            cfg0 = cfgs[0]
            mesh = ensemble_mesh(cfg0, device)

            if (sset is None and cfg0.opacity_mixing == "on-the-fly"
                    and tables is None):
                sset, donor = pl.build_species_set_from_files(cfg0,
                                                              device=dev)
                tables = [donor] * len(cfgs)
            if tables is None:
                loaded = {}
                tables = []
                for c in cfgs:
                    if c.opacity_path not in loaded:
                        loaded[c.opacity_path] = pl.load_opacity_file(
                            c.opacity_path)
                    tables.append(loaded[c.opacity_path])

            physes, models, T0s, cloud_results = [], [], [], []
            for cfg, table in zip(cfgs, tables):
                phys, arrays, clouds_i = pl.prepare_model(cfg, table,
                                                          device=dev)
                physes.append(phys)
                models.append(arrays)
                cloud_results.append(clouds_i)
                T0s.append(pl.initial_temperatures(cfg, phys, arrays))
            phys = _check_same_phys(physes)
            thermo = pl.make_thermo(cfg0, device=dev)
            want_conv = (phys.convection and not phys.singlewalk
                         and not phys.iso)

            # on a mesh the loops run on a copy with the bin axis padded to
            # a multiple of the slices, placed on the mesh; restores read
            # the padded copy whole on the home device
            m = stack_models(models)
            phys_run, sset_run = phys, sset
            m_loop, sset_loop = m, sset
            if mesh is not None:
                n_spec = mesh.shape["spectral"]
                phys_run, m = shd.pad_spectral(phys, m, n_spec)
                sset_run = shd.pad_species(sset, n_spec)
                m_loop = shd.place_model(m, mesh)
                sset_loop = shd.place_species(sset_run, mesh)
            T0 = torch.as_tensor(np.stack(T0s, axis=1),
                                 dtype=torch_dtype(cfg0.dtype), device=dev)

            # config 0 drives the chunking, the progress lines and one
            # checkpoint pair for the whole batch, under the first member's
            # directory, written after every chunk as the JAX package's
            # ensemble writes it
            chunk = ensemble_chunk(cfg0, phys)
            rad_cbs, conv_cbs = [], []
            rad0 = conv0 = None
            rad_it0 = np.zeros(len(cfgs), int)
            if chunk is not None and cfg0.progress:
                rad_cbs.append(EnsembleProgress(len(cfgs)))
                conv_cbs.append(EnsembleProgress(len(cfgs)))
            if chunk is not None and cfg0.checkpoint_every > 0:
                path, conv_path = pl.checkpoint_paths(cfg0,
                                                      "ensemble.ckpt.npz")
                ck = ckpt_mod.load_rad_checkpoint(path)
                if (ck is not None
                        and ckpt_mod.checkpoint_phase(ck) == "radiation"):
                    rad0 = ckpt_mod.restore_rad_state(phys_run, m, ck,
                                                      sset_run)
                    rad_it0 = rad0.it.copy()
                cck = (ckpt_mod.load_conv_checkpoint(conv_path) if want_conv
                       else None)
                if (cck is not None
                        and ckpt_mod.checkpoint_phase(cck) == "convection"):
                    conv0 = ckpt_mod.restore_conv_state(phys_run, m, cck,
                                                        sset_run)
                rad_cbs.append(ckpt_mod.CheckpointCallback(path, chunk,
                                                           phys_run))
                conv_cbs.append(ckpt_mod.ConvCheckpointCallback(
                    conv_path, chunk, phys_run))
            pl.settle(dev)

        with graphs.span("helios.radiation") as rad_span:
            rads = run_radiation_chunked(phys_run, m_loop, thermo, T0,
                                         chunk_iters=chunk, sset=sset_loop,
                                         callbacks=rad_cbs, state0=rad0,
                                         mesh=mesh)
            pl.settle(dev)
        with graphs.span("helios.convection") as conv_span:
            convs = None
            if want_conv:
                convs = run_convection_chunked(
                    phys_run, m_loop, thermo, rads, chunk_iters=chunk,
                    sset=sset_loop, callbacks=conv_cbs, state0=conv0,
                    mesh=mesh)
            pl.settle(dev)

        with graphs.span("helios.result"):
            outs = []
            for i, (cfg, arrays) in enumerate(zip(cfgs, models)):
                rad_i = member_state(rads, i)
                conv_i = member_state(convs, i) if convs is not None else None
                final = conv_i if conv_i is not None else rad_i
                final = final._replace(
                    T_lay=final.T_lay.contiguous(),
                    flux=type(final.flux)(*(
                        f.contiguous() for f in shd.strip_flux(
                            final.flux, phys.nbin, phys.ny))))
                # the end-of-run bookkeeping of pipeline.run, so that a
                # member writes exactly the file set its run alone writes
                result = pl.final_result(cfg, phys, arrays, thermo, final,
                                         conv_i, cloud_results[i], sset)
                if write_output:
                    writers.write_all(result)
                    if final.aborted:
                        writers.write_abort_file(result)
                outs.append(pl.RunOutput(
                    phys=phys, arrays=arrays, rad=rad_i, conv=conv_i,
                    T_lay=final.T_lay, flux=final.flux, totals=final.totals,
                    result=result, wall_seconds=0.0,
                    rad_seconds=rad_span.seconds,
                    conv_seconds=conv_span.seconds,
                    rad_it0=int(rad_it0[i])))

    # every member's wall is the batch's, taken after all members' results
    for out in outs:
        out.wall_seconds = whole.seconds
    return outs


# --------------------------------------------------------------------------- #
# planet-ensemble file: the command line's product surface
# --------------------------------------------------------------------------- #

def parse_ensemble_file(path: str):
    """Parse a planet-ensemble override file.

    Format: '#' comments; the first non-comment line names HeliosConfig
    fields (whitespace-separated, e.g. ``name T_star R_star a g``); each
    following line is one planet's values.  Values keep their string
    form -- HeliosConfig.finalize coerces/validates exactly as it does
    for param.dat entries.  Returns a list of {field: value} dicts.
    """
    rows, header = [], None
    with open(path) as f:
        for ln in f:
            ln = ln.split("#", 1)[0].strip()
            if not ln:
                continue
            cols = ln.split()
            if header is None:
                header = cols
                continue
            if len(cols) != len(header):
                raise ValueError(
                    f"{path}: row {ln!r} has {len(cols)} values, header "
                    f"names {len(header)} fields")
            rows.append(dict(zip(header, cols)))
    if header is None:
        raise ValueError(f"{path}: empty ensemble file")
    if not rows:
        raise ValueError(
            f"{path}: ensemble file names fields {header} but contains "
            "no planet rows")
    bad = [h for h in header
           if h not in HeliosConfig.__dataclass_fields__]
    if bad:
        raise ValueError(f"{path}: unknown config fields {bad}")
    return rows


def _coerce_like(cur, v: str):
    if isinstance(cur, bool):
        return v.lower() in ("1", "yes", "true", "on")
    if isinstance(cur, int) and not isinstance(cur, bool):
        try:
            return int(v)
        except ValueError:
            return v
    if isinstance(cur, float):
        try:
            return float(v)
        except ValueError:
            return v
    return v


def configs_from_ensemble(base_cfg, rows):
    """One HeliosConfig per planet: a copy of ``base_cfg`` with the row's
    overrides applied, then finalized."""
    cfgs = []
    for i, row in enumerate(rows):
        c = copy.deepcopy(base_cfg)
        c._finalized = False
        for field, v in row.items():
            setattr(c, field, _coerce_like(getattr(c, field), v))
        if "name" not in row:
            c.name = f"{base_cfg.name}_{i}"
        cfgs.append(c.finalize())
    names = [c.name for c in cfgs]
    if len(set(names)) != len(names):
        raise ValueError(f"ensemble planet names must be unique: {names}")
    return cfgs

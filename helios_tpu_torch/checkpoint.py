"""Checkpoint / resume of the RCE iteration state (port of
:mod:`helios_tpu.checkpoint`).

The reference's only resume mechanism is re-reading a previous run's
``*_tp.dat`` as the initial temperature profile (read.py:1274-1322), which
loses the adaptive-timestep prefactors, the oscillation store and the
iteration counter.  Here the full restartable loop state is written every
N iterations, so a preempted job continues where it stopped.

The file format is the JAX package's, key for key and dtype for dtype: one
``.npz`` written atomically (temporary file + rename) with
``format_version`` 1, ``phase`` ("radiation" / "convection"), the
``fp__*`` model fingerprint, the state fields (``it`` int32, the flags 0-d
bools, ``local_limit`` in the run's dtype), ``flux__*`` and, for the
convection loop, ``totals__*`` and two ``cache__*`` fields.  A checkpoint
written by either package resumes in the other.  The cell cache and band
totals of the radiation loop are derived data and are rebuilt on restore.
The port keeps ``it``, ``local_limit``, ``aborted`` (and in the convection
loop ``keep_running``) as host values; they are written as the JAX
package's arrays and read back into host values
(:mod:`helios_tpu_torch.convert`).

A batch of planets (:mod:`helios_tpu_torch.parallel.ensemble`) is written
as the JAX package's ensemble writes its ``vmap``-ed state: every field
with a leading planet axis [N, ...] (the port keeps that axis after the
layer axis and moves it here), the counters and flags [N].
"""

from __future__ import annotations

import os
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

from helios_tpu_torch import convert
from helios_tpu_torch.forward import (ModelArrays, Phys, compute_cells,
                                      integrate_flux_flat)
from helios_tpu_torch.ops import interp as interp_ops
from helios_tpu_torch.ops.members import (loop_counter, planet_first,
                                          planet_second, running_members)
from helios_tpu_torch.rce.loop import ConvLoopState
from helios_tpu_torch.monitor import run_radiation_chunked
from helios_tpu_torch.rce.radiative import RadLoopState, init_rad_state

_FORMAT_VERSION = 1

# Model-identity fingerprint stored in every checkpoint: a leftover file
# from a differently-configured run at the same path must fail loudly
# instead of resuming into shape errors or silently wrong physics.
_FINGERPRINT_FIELDS = ("nlayer", "nbin", "ny", "iso", "T_star", "T_intern",
                       "g", "a")

# RadLoopState fields that determine a resume (cache and totals are
# recomputed); FluxState is stored field-wise with a "flux__" prefix.
_STATE_FIELDS = ("T_lay", "T_store", "prefactor", "F_smooth_sum", "abort",
                 "it", "local_limit", "keep_running", "goto_convection",
                 "aborted")

# ConvLoopState restartable fields (the same recompute rule for the cache)
_CONV_FIELDS = ("T_lay", "T_store", "prefactor", "F_smooth_sum",
                "conv_layer", "marked_red", "it", "local_limit",
                "keep_running", "aborted")

# the cache fields the convection body reads before its next refresh
_CONV_CACHE_FIELDS = ("meanmolmass_lay", "F_add_heat_sum")


def _fingerprint(phys: Phys) -> dict:
    return {"fp__" + f: np.float64(getattr(phys, f))
            for f in _FINGERPRINT_FIELDS}


def _check_fingerprint(phys: Phys, ckpt: dict) -> None:
    mismatches = []
    for f in _FINGERPRINT_FIELDS:
        key = "fp__" + f
        if key not in ckpt:
            return   # a checkpoint written without a fingerprint: accept
        have, want = float(ckpt[key]), float(getattr(phys, f))
        if have != want:
            mismatches.append(f"{f}: checkpoint={have:g} run={want:g}")
    if mismatches:
        raise ValueError(
            "checkpoint does not match this run's configuration "
            f"({'; '.join(mismatches)}). Delete the stale checkpoint "
            "or point -checkpoint_path elsewhere.")


def _host(x, dtype, batched=False):
    """A state field as the JAX package stores it: tensors as numpy (a
    batch's with the planet axis first), the host counter as int32, the
    host criterion in the run's dtype, host flags as bools (0-d, or [N]
    for a batch)."""
    if hasattr(x, "detach"):
        return planet_first(x.detach().cpu().numpy(), batched)
    if isinstance(x, (bool, np.bool_)) or (
            isinstance(x, np.ndarray) and x.dtype == bool):
        return np.asarray(x, bool)
    if isinstance(x, (int, np.integer)) or (
            isinstance(x, np.ndarray) and x.dtype.kind == "i"):
        return np.asarray(x, np.int32)
    return np.asarray(x, dtype)


def _state_payload(state, phase: str, fields, phys: Optional[Phys]) -> dict:
    dtype = state.T_lay.detach().cpu().numpy().dtype
    batched = state.T_lay.dim() == 2
    payload = {"format_version": np.int64(_FORMAT_VERSION),
               "phase": np.bytes_(phase.encode())}
    if phys is not None:
        payload.update(_fingerprint(phys))
    for f in fields:
        payload[f] = _host(getattr(state, f), dtype, batched)
    for f, v in state.flux._asdict().items():
        payload["flux__" + f] = _host(v, dtype, batched)
    return payload


def _write_atomic(path: str, payload: dict) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_rad_checkpoint(path: str, state: RadLoopState,
                        phys: Optional[Phys] = None) -> None:
    """Atomically write the restartable radiation-loop state."""
    _write_atomic(path, _state_payload(state, "radiation", _STATE_FIELDS,
                                       phys))


def save_conv_checkpoint(path: str, state: ConvLoopState,
                         phys: Optional[Phys] = None) -> None:
    """Atomically write the restartable convection-loop state.

    Unlike the radiation body, the convection body consumes the previous
    iteration's band totals and two cache fields (mean molecular mass,
    cumulative additional-heating flux) in the convective adjustment
    before the 10-step cache refresh, so those are written too."""
    payload = _state_payload(state, "convection", _CONV_FIELDS, phys)
    dtype = payload["T_lay"].dtype
    batched = state.T_lay.dim() == 2
    for f, v in state.totals._asdict().items():
        payload["totals__" + f] = _host(v, dtype, batched)
    for f in _CONV_CACHE_FIELDS:
        payload["cache__" + f] = _host(getattr(state.cache, f), dtype,
                                       batched)
    _write_atomic(path, payload)


def load_rad_checkpoint(path: str) -> Optional[dict]:
    """Read a checkpoint; None if absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["format_version"]) != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path}: format {int(z['format_version'])}, "
                f"expected {_FORMAT_VERSION}")
        return {k: z[k] for k in z.files if k != "format_version"}


load_conv_checkpoint = load_rad_checkpoint   # same container format


def checkpoint_phase(ckpt: dict) -> str:
    """"radiation" or "convection" (files without the phase tag are
    radiation checkpoints)."""
    ph = ckpt.get("phase")
    return bytes(ph).decode() if ph is not None else "radiation"


def _nested(ckpt: dict) -> dict:
    """The flat ``prefix__field`` keys as nested mappings."""
    out = {}
    for k, v in ckpt.items():
        if "__" in k:
            group, field = k.split("__", 1)
            out.setdefault(group, {})[field] = v
        else:
            out[k] = v
    return out


def restore_rad_state(phys: Phys, m: ModelArrays, ckpt: dict,
                      sset=None) -> RadLoopState:
    """Rebuild a full RadLoopState, on the model's device and in its
    dtype, from a checkpoint payload.

    The cell cache and band totals are recomputed from the restored
    temperatures.  The resume is bit for bit the uninterrupted run when
    the saved iteration is a multiple of the 10-step cache-refresh cadence
    (the pipeline rounds its chunk size to make it so); otherwise the
    resumed cache is fresher than the one the uninterrupted run would have
    used: equivalent, not bit for bit.  A batch's checkpoint restores a
    batched state over stacked arrays."""
    if checkpoint_phase(ckpt) != "radiation":
        raise ValueError(
            "checkpoint holds a convection-phase payload; refusing to "
            "restore it as radiation state (stale or misrouted "
            "checkpoint path).")
    _check_fingerprint(phys, ckpt)
    if not np.any(ckpt["keep_running"]):
        warnings.warn("resuming from an already-converged checkpoint; "
                      "the loop will exit immediately", stacklevel=2)
    fields = convert.rad_loop_fields_from_numpy(
        _nested(ckpt), device=m.p_lay.device, dtype=m.p_lay.dtype)
    fresh = init_rad_state(phys, m, fields["T_lay"], sset)
    totals = integrate_flux_flat(phys, m, fields["flux"], fresh.cache.F_dir)
    return fresh._replace(totals=totals, **fields)


def restore_conv_state(phys: Phys, m: ModelArrays, ckpt: dict,
                       sset=None) -> ConvLoopState:
    """Rebuild a ConvLoopState from a checkpoint payload.

    The bulk cell cache is recomputed from the restored temperatures; the
    stale fields the body reads before the refresh (totals,
    meanmolmass_lay, F_add_heat_sum) come from the checkpoint.  The resume
    is bit for bit when the checkpoint interval is a multiple of the
    10-iteration cache-refresh cadence.  A batch's checkpoint restores a
    batched state over stacked arrays."""
    if checkpoint_phase(ckpt) != "convection":
        raise ValueError(
            "checkpoint holds a radiation-phase payload; refusing to "
            "restore it as convection state.")
    _check_fingerprint(phys, ckpt)
    d = _nested(ckpt)
    dev, dt = m.p_lay.device, m.p_lay.dtype
    T_lay = torch.tensor(planet_second(d["T_lay"], np.ndim(d["T_lay"]) == 2),
                         dtype=dt, device=dev)
    cache = compute_cells(phys, m, T_lay,
                          interp_ops.interface_temperatures(T_lay), sset)
    return convert.conv_state_from_numpy(d, cache, device=dev, dtype=dt)


class CheckpointCallback:
    """Chunk callback of :func:`helios_tpu_torch.monitor.run_radiation_chunked`:
    a checkpoint every N iterations, and always on the final chunk."""

    save = staticmethod(save_rad_checkpoint)

    def __init__(self, path: str, every: int,
                 phys: Optional[Phys] = None):
        self.path = path
        self.every = max(int(every), 1)
        self.phys = phys
        self._last_saved = None

    def __call__(self, info) -> None:
        it = loop_counter(info.state)
        done = not running_members(info.state).any()
        if (self._last_saved is None or done
                or it - self._last_saved >= self.every):
            self.save(self.path, info.state, self.phys)
            self._last_saved = it


class ConvCheckpointCallback(CheckpointCallback):
    """Chunk callback of
    :func:`helios_tpu_torch.monitor.run_convection_chunked`: a checkpoint
    every N iterations, and always on the final chunk."""

    save = staticmethod(save_conv_checkpoint)


def run_radiation_checkpointed(phys: Phys, m: ModelArrays, thermo,
                               T_lay0, *, path: str, every: int = 1000,
                               sset=None) -> RadLoopState:
    """Radiation loop in chunks of ``every`` iterations with a checkpoint
    written after each chunk; resumes from ``path`` if it exists.  A chunk
    is one call of the loop with ``max_steps``: the same iterations, and
    at most one chunk of work is lost on preemption."""
    ckpt = None if phys.singlewalk else load_rad_checkpoint(path)
    state0 = (restore_rad_state(phys, m, ckpt, sset) if ckpt is not None
              else None)
    return run_radiation_chunked(
        phys, m, thermo, T_lay0, chunk_iters=every, sset=sset,
        callbacks=[CheckpointCallback(path, every, phys)], state0=state0)

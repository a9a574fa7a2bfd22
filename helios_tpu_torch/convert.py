"""State carried across from the JAX package.

HELIOS has no weights: its state is the model's static arrays, the
species set of on-the-fly mixing and the loop state (also as a checkpoint
file holds it, :mod:`helios_tpu_torch.checkpoint`).  These functions take
that state as numpy arrays (for example
``{name: np.asarray(x)}`` of a :class:`helios_tpu.forward.ModelArrays`) and
return the port's tensors, so both packages can start from the same
mid-run state.  Nested states are mappings of the same form; the loop
counters and flags are plain numbers.

A batch of planets comes as the JAX package's ``vmap`` gives it (and its
ensemble checkpoints hold it): every array with a leading planet axis
[N, ...].  The port puts that axis after the layer axis
(:mod:`helios_tpu_torch.ops.members`), so ``planet_second`` moves it,
and the counters and flags become numpy arrays [N].
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from helios_tpu_torch import chem
from helios_tpu_torch import fastpath as fp
from helios_tpu_torch.forward import CellCache, FluxState, ModelArrays
from helios_tpu_torch.ops.integrate import FluxTotals
from helios_tpu_torch.ops.members import planet_second
from helios_tpu_torch.rce.loop import ConvLoopState
from helios_tpu_torch.rce.radiative import RadLoopState


def _tensor(x, device, dtype, batched=False):
    # a writable copy: the port owns its tensors
    a = np.array(planet_second(x, batched))
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _build(cls, d: Mapping[str, Any], device, dtype, batched=False):
    return cls(**{k: _tensor(d[k], device, dtype, batched)
                  for k in cls._fields})


def model_arrays_from_numpy(d: Mapping[str, Any], *, device,
                            dtype=torch.float64) -> ModelArrays:
    """The port's ModelArrays from the JAX ModelArrays' fields as numpy
    arrays (``planck_grid_pairs``, the TPU's two-float32 split of the
    Planck grid, is dropped)."""
    return _build(ModelArrays, d, device, dtype)


def flux_state_from_numpy(d: Mapping[str, Any], *, device,
                          dtype=torch.float64, batched=False) -> FluxState:
    return _build(FluxState, d, device, dtype, batched)


def _counters(d, batched, names):
    """The host counters and flags: numbers for a planet, numpy arrays [N]
    (int64 counters, float64 criteria, bool flags) for a batch."""
    kinds = dict(it=int, steps=int, local_limit=float, aborted=bool,
                 keep_running=bool)
    if batched:
        dt = dict(zip((int, float, bool), (np.int64, np.float64, bool)))
        return {k: np.asarray(d[k], dt[kinds[k]]) for k in names}
    return {k: kinds[k](d[k]) for k in names}


def _cell_cache_from_numpy(d, device, dtype) -> CellCache:
    """An isothermal cache is told apart by its coefficient cache's
    fields (IsoCoeffCache has ``planck_coeff``)."""
    fields = {k: _tensor(d[k], device, dtype) for k in CellCache._fields
              if k not in ("cells_or_upper", "lower", "coeff")}
    coeff_cls = (fp.IsoCoeffCache if "planck_coeff" in d["coeff"]
                 else fp.NonIsoCoeffCache)
    return CellCache(
        cells_or_upper=_build(fp.FlatCells, d["cells_or_upper"], device,
                              dtype),
        lower=_build(fp.FlatCells, d["lower"], device, dtype),
        coeff=_build(coeff_cls, d["coeff"], device, dtype),
        **fields)


def rad_loop_fields_from_numpy(d: Mapping[str, Any], *, device,
                               dtype=torch.float64) -> dict:
    """Every RadLoopState field but the cell cache and the totals (which
    follow from them), from numpy: the arrays and ``flux`` (a mapping) as
    tensors, ``it`` and ``local_limit`` as the host numbers the port keeps
    (the JAX package stores them as 0-d arrays), ``keep_running`` and
    ``goto_convection`` as 0-d bool tensors and ``aborted`` as a host
    bool.  A batch (``T_lay`` [N, L+1]) gives the batched state: the
    planet axis after the layer axis, [N] flags and numpy counters."""
    batched = np.ndim(d["T_lay"]) == 2
    t = lambda k: _tensor(d[k], device, dtype, batched)
    flag = lambda k: torch.as_tensor(np.asarray(d[k], bool), device=device)
    return dict(
        T_lay=t("T_lay"),
        flux=flux_state_from_numpy(d["flux"], device=device, dtype=dtype,
                                   batched=batched),
        T_store=t("T_store"), prefactor=t("prefactor"),
        F_smooth_sum=t("F_smooth_sum"), abort=t("abort"),
        keep_running=flag("keep_running"),
        goto_convection=flag("goto_convection"),
        **_counters(d, batched, ("it", "local_limit", "aborted")))


def rad_state_from_numpy(d: Mapping[str, Any], *, device,
                         dtype=torch.float64) -> RadLoopState:
    """The port's RadLoopState from a radiation-loop state given as nested
    mappings of numpy arrays (flux, cache with its cells and coefficient
    cache, totals) and numbers (it, local_limit, keep_running,
    goto_convection, aborted)."""
    return RadLoopState(
        cache=_cell_cache_from_numpy(d["cache"], device, dtype),
        totals=_build(FluxTotals, d["totals"], device, dtype),
        **rad_loop_fields_from_numpy(d, device=device, dtype=dtype))


def conv_state_from_numpy(d: Mapping[str, Any], cache: CellCache, *,
                          device, dtype=torch.float64) -> ConvLoopState:
    """The port's ConvLoopState from a convection-loop state given as
    numpy arrays and numbers (the ConvLoopState fields of the JAX package,
    with ``flux`` and ``totals`` as mappings), over a cell cache of the
    port whose ``meanmolmass_lay`` and ``F_add_heat_sum`` are replaced by
    ``d["cache"]``'s (the fields the convection body reads before its next
    refresh).  ``it``, ``local_limit``, ``keep_running`` and ``aborted``
    become the host values the port keeps; ``steps`` counts the loop
    bodies run from here, so it starts at 0.  A batch ([N, ...] arrays)
    gives the batched state, as :func:`rad_loop_fields_from_numpy`."""
    batched = np.ndim(d["T_lay"]) == 2
    t = lambda k: _tensor(d[k], device, dtype, batched)
    counters = _counters(d, batched, ("it", "local_limit", "keep_running",
                                      "aborted"))
    return ConvLoopState(
        T_lay=t("T_lay"),
        flux=flux_state_from_numpy(d["flux"], device=device, dtype=dtype,
                                   batched=batched),
        cache=cache._replace(**{k: _tensor(v, device, dtype, batched)
                                for k, v in d["cache"].items()}),
        totals=_build(FluxTotals, d["totals"], device, dtype, batched),
        T_store=t("T_store"), prefactor=t("prefactor"),
        F_smooth_sum=t("F_smooth_sum"), conv_layer=t("conv_layer"),
        marked_red=t("marked_red"),
        steps=np.zeros_like(counters["it"]) if batched else 0, **counters)


def species_set_from_numpy(specs: Sequence, data: Sequence[Mapping[str, Any]],
                           ktemps, kpress, *, device,
                           dtype=torch.float64) -> chem.SpeciesSet:
    """The port's SpeciesSet from the parts of a JAX one: its species specs
    (objects with the SpeciesSpec fields), its per-species device data as
    mappings of numpy arrays (the SpeciesDeviceData fields), in the same
    order, and the opacity table's T and P grids.  The order is kept: the
    JAX set already holds an absorbing species first."""
    return chem.SpeciesSet(
        specs=[chem.SpeciesSpec(
            name=s.name, absorbing=bool(s.absorbing),
            scattering=bool(s.scattering), source_for_vmr=s.source_for_vmr,
            weight=float(s.weight), fc_name=s.fc_name) for s in specs],
        data=[_build(chem.SpeciesDeviceData, d, device, dtype)
              for d in data],
        ktemps=_tensor(ktemps, device, dtype),
        kpress=_tensor(kpress, device, dtype))

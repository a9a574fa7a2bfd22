"""State carried across from the JAX package.

HELIOS has no weights: its state is the model's static arrays, the
species set of on-the-fly mixing and the loop state.  These functions take
that state as numpy arrays (for example
``{name: np.asarray(x)}`` of a :class:`helios_tpu.forward.ModelArrays`) and
return the port's tensors, so both packages can start from the same
mid-run state.  Nested states are mappings of the same form; the loop
counters and flags are plain numbers.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from helios_tpu_torch import chem
from helios_tpu_torch import fastpath as fp
from helios_tpu_torch.forward import CellCache, FluxState, ModelArrays
from helios_tpu_torch.ops.integrate import FluxTotals
from helios_tpu_torch.rce.radiative import RadLoopState


def _tensor(x, device, dtype):
    a = np.array(x)        # a writable copy: the port owns its tensors
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _build(cls, d: Mapping[str, Any], device, dtype):
    return cls(**{k: _tensor(d[k], device, dtype) for k in cls._fields})


def model_arrays_from_numpy(d: Mapping[str, Any], *, device,
                            dtype=torch.float64) -> ModelArrays:
    """The port's ModelArrays from the JAX ModelArrays' fields as numpy
    arrays (``planck_grid_pairs``, the TPU's two-float32 split of the
    Planck grid, is dropped)."""
    return _build(ModelArrays, d, device, dtype)


def flux_state_from_numpy(d: Mapping[str, Any], *, device,
                          dtype=torch.float64) -> FluxState:
    return _build(FluxState, d, device, dtype)


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


def rad_state_from_numpy(d: Mapping[str, Any], *, device,
                         dtype=torch.float64) -> RadLoopState:
    """The port's RadLoopState from a radiation-loop state given as nested
    mappings of numpy arrays (flux, cache with its cells and coefficient
    cache, totals) and numbers (it, local_limit, keep_running,
    goto_convection, aborted)."""
    t = lambda k: _tensor(d[k], device, dtype)
    return RadLoopState(
        T_lay=t("T_lay"),
        flux=flux_state_from_numpy(d["flux"], device=device, dtype=dtype),
        cache=_cell_cache_from_numpy(d["cache"], device, dtype),
        totals=_build(FluxTotals, d["totals"], device, dtype),
        T_store=t("T_store"), prefactor=t("prefactor"),
        F_smooth_sum=t("F_smooth_sum"), abort=t("abort"),
        it=int(d["it"]), local_limit=float(d["local_limit"]),
        keep_running=torch.as_tensor(bool(d["keep_running"]),
                                     device=device),
        goto_convection=torch.as_tensor(bool(d["goto_convection"]),
                                        device=device),
        aborted=bool(d["aborted"]))


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

"""The spectral slices of a mesh (:mod:`helios_tpu_torch.parallel.sharding`):
which arrays carry the bin axis, one slice taken out, the slices' results
joined, and a whole state split onto the slices and gathered back.

A model on a mesh keeps every array that carries the bin axis as
:class:`Slices`, one contiguous block of bins per slice, each on its own
device; the arrays without one (the vertical grid, the (T, P) grids) stay
whole on the home device, slice 0's.  The loops' state follows the same
rule: the spectral fields (fluxes, the cell cache, the band totals) are
:class:`Slices`, the rest (temperatures, the total fluxes, the counters
and flags) lies once on the home device.  The bin axis is the last axis of
every such array, in a batch too.

The forward functions (:func:`over_slices`) run once per slice on the
slice's device with its share of the bins; every op of the loops is local
to a bin but the band->total sum, which
:func:`helios_tpu_torch.forward.integrate_flux_flat` carries from slice to
slice.  Between chunks the monitored runners hold a whole state
(:func:`gather` / :func:`scatter`): what callbacks and checkpoints read.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import torch

# ModelArrays fields that carry the bin axis (last); the others every slice
# reads whole (the JAX package's _MODEL_SPECS)
MODEL_SPECTRAL = frozenset((
    "ktable", "scat_cross_table", "lambda_centers", "delta_lambda",
    "planck_grid", "starflux", "surf_albedo", "cloud_abs_cross_lay",
    "cloud_scat_cross_lay", "g_0_cloud_lay", "cloud_abs_cross_int",
    "cloud_scat_cross_int", "g_0_cloud_int"))

# SpeciesDeviceData fields that carry the bin axis: the opacity table's
# is [T, P, B, Y], the Rayleigh cross section's [B]
SPECIES_SPECTRAL = {"opacity_pretab": -2, "scat_cross": -1}

# fields of the loops' spectral groups (flux, cache, totals) that every
# slice computes alike: slice 0's are kept, on the home device
REPLICATED = frozenset(("meanmolmass_lay", "z_lay", "F_add_heat_lay",
                        "F_add_heat_sum", "F_down_tot", "F_up_tot", "F_net"))

# loop-state fields whose tensors are spectral (apart from REPLICATED)
SPECTRAL_GROUPS = frozenset(("flux", "cache", "totals"))


class Slices(tuple):
    """One value per spectral slice: slice k's on its own device."""


def count(x) -> int:
    """The number of slices of a sliced NamedTuple (a model), 0 for one
    that is whole."""
    for v in x:
        if isinstance(v, Slices):
            return len(v)
    return 0


def devices(x) -> List[torch.device]:
    """The devices of a sliced NamedTuple's slices, in slice order."""
    for v in x:
        if isinstance(v, Slices):
            return [t.device for t in v]
    raise ValueError("not sliced")


def home(x) -> torch.device:
    """The home device of a model, sliced or whole: slice 0's."""
    return devices(x)[0] if count(x) else x[0].device


def take(x, k: int, device):
    """Slice k's part of ``x``: a :class:`Slices`' k-th value, a whole
    tensor moved to ``device`` (no copy when it lies there), a NamedTuple
    field by field, anything else as it is."""
    if isinstance(x, Slices):
        return x[k]
    if hasattr(x, "_fields"):
        return type(x)(*(take(v, k, device) for v in x))
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def join(parts):
    """The per-slice results of a forward function (NamedTuples of tensors)
    as one: each spectral field a :class:`Slices`, each REPLICATED field
    slice 0's."""
    def walk(name, xs):
        x0 = xs[0]
        if hasattr(x0, "_fields"):
            return type(x0)(*(walk(f, [getattr(x, f) for x in xs])
                              for f in x0._fields))
        if name in REPLICATED or not isinstance(x0, torch.Tensor):
            return x0
        return Slices(xs)

    return walk(None, parts)


def over_slices(fn):
    """``fn(phys, m, *args)`` also on a sliced model: once per slice, on the
    slice's device with its share of the bins (``phys.nbin`` divided by the
    slices), the arguments' slices taken out (:func:`take`) and the
    results joined (:func:`join`)."""
    @functools.wraps(fn)
    def run(phys, m, *args, **kw):
        n = count(m)
        if not n:
            return fn(phys, m, *args, **kw)
        if phys.nbin % n:
            raise ValueError(f"nbin {phys.nbin} is not divisible by the "
                             f"{n} spectral slices")
        local = dataclasses.replace(phys, nbin=phys.nbin // n)
        return join([fn(local, take(m, k, d),
                        *(take(a, k, d) for a in args),
                        **{name: take(a, k, d) for name, a in kw.items()})
                     for k, d in enumerate(devices(m))])

    return run


def split(x: torch.Tensor, devs, axis: int = -1) -> Slices:
    """A whole array's equal contiguous blocks along ``axis`` (the bin
    axis), block k copied to ``devs[k]``."""
    n = x.shape[axis] // len(devs)
    return Slices(x.narrow(axis, k * n, n).to(d).contiguous()
                  for k, d in enumerate(devs))


def _walk_state(fn, x, spectral=False, name=None):
    """``fn(leaf, spectral)`` over a loop state's tensors (NamedTuples);
    ``spectral``: the leaf lies in a spectral group and is not
    REPLICATED."""
    if hasattr(x, "_fields"):
        return type(x)(*(_walk_state(fn, v, spectral
                                     or f in SPECTRAL_GROUPS, f)
                         for f, v in zip(x._fields, x)))
    if isinstance(x, (torch.Tensor, Slices)):
        return fn(x, spectral and name not in REPLICATED)
    return x


def gather(x, device):
    """A sliced loop state (or temperatures) whole on ``device``: every
    :class:`Slices` concatenated along its bin axis, the other tensors
    moved there."""
    def one(v, _spectral):
        if isinstance(v, Slices):
            return torch.cat([t.to(device) for t in v], dim=-1)
        return v.to(device)

    return _walk_state(one, x)


def scatter(x, m):
    """A whole loop state (or temperatures) split onto the slices of the
    sliced model ``m``: each spectral tensor in blocks of bins (copies on
    the slices' devices), the others on the home device; ``x`` as it is
    for a model that is whole."""
    if not count(m):
        return x
    devs = devices(m)
    return _walk_state(lambda v, spectral: (split(v, devs) if spectral
                                            else v.to(devs[0])), x)

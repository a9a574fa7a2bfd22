"""Meshes: planet ensembles over a planet axis x spectral slices (port of
:mod:`helios_tpu.parallel.sharding`).

* spectral axis: the wavelength bins of every [.., bin, y] array are split
  into contiguous slices, one per device.  Every op of the loops is local
  to a bin (the opacity lookup, the cells, the layer sweeps), so the only
  step that reaches across slices is the band->total sum of
  :func:`helios_tpu_torch.forward.integrate_flux_flat`, which runs on from
  slice to slice in slice order.  The total, and with it every quantity
  the temperature step, the convective adjustment and the convergence
  tests read, is one value on the home device (slice 0's), so the slices
  iterate in lockstep and the host reads one flag per iteration.  On the
  card the chain of adds over the slices is the chain over the whole bin
  axis, and a sliced run is bit for bit its run on one device.
* planet axis: the members of an ensemble split into contiguous groups,
  one per planet position, each group a batch over its row's slices; the
  groups share nothing.

One process drives every device, as the JAX package's command line does.
A mesh is an ordered list of torch devices (:func:`make_mesh`); a device
may repeat, so that one card holds several slices.  A model is placed on
it by :func:`place_model` (the arrays with a bin axis split into
:class:`helios_tpu_torch.ops.slices.Slices`), and the runners of
:func:`production_runners` take and return whole states on the home
device: the chunked runners' callbacks and checkpoints read them as a run
on one device gives them.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from helios_tpu_torch.chem import SpeciesDeviceData
from helios_tpu_torch.device import resolve_device
from helios_tpu_torch.forward import (FluxState, ModelArrays, Phys,
                                      forward_fluxes)
from helios_tpu_torch.ops import slices
from helios_tpu_torch.ops.members import (MODEL_AXIS, join_members,
                                          member_groups)
from helios_tpu_torch.rce.loop import convection_loop
from helios_tpu_torch.rce.radiative import (ThermoProps, init_rad_state,
                                            radiation_loop)


class Mesh(NamedTuple):
    """Devices with ("planet", "spectral") axes: one row of spectral
    slices per planet position."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"planet": len(self.devices),
                "spectral": len(self.devices[0])}


def visible_devices(device, n: int) -> List[torch.device]:
    """The devices a mesh of ``n`` positions may take, in order (what
    ``jax.devices()`` is to the JAX package): a sequence's entries; ``n``
    times the CPU for "cpu"; every visible CUDA device for "cuda", or the
    one named with an index.  Raises when a CUDA device is named and CUDA
    is absent."""
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def home_device(device) -> torch.device:
    """The device of a run's host-side state: ``device``, or a sequence's
    first entry."""
    if isinstance(device, (list, tuple)):
        device = device[0]
    return resolve_device(device)


def make_mesh(n_planet: int = 1, n_spectral: Optional[int] = None,
              devices="cuda") -> Mesh:
    """The ("planet", "spectral") mesh over ``devices`` (see
    :func:`visible_devices`), row by row; ``n_spectral`` defaults to the
    devices per planet position."""
    devs = visible_devices(devices, n_planet * (n_spectral or 1))
    if n_spectral is None:
        n_spectral = len(devs) // n_planet
    if n_planet * n_spectral != len(devs):
        raise ValueError(f"{n_planet} x {n_spectral} != {len(devs)} devices")
    return Mesh(tuple(tuple(devs[r * n_spectral:(r + 1) * n_spectral])
                      for r in range(n_planet)))


# --------------------------------------------------------------------------- #
# spectral padding: any bin count on any number of slices
# --------------------------------------------------------------------------- #
# The flagship grid has 385 = 5*7*11 bins, which no power of two divides.
# The bin axis is padded to a multiple of the slices: a padded bin copies
# the last real bin, so every per-cell quantity stays finite, and its
# delta_lambda is 0, so it adds an exact zero to the band->total sum.  The
# temperatures and every convergence test are unchanged.

def padded_nbin(nbin: int, n_shards: int) -> int:
    return -(-nbin // n_shards) * n_shards


def _edge_pad(a: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Pad ``axis`` by ``n`` entries that copy its last one."""
    if n == 0:
        return a
    last = a.narrow(axis, a.shape[axis] - 1, 1)
    reps = [1] * a.dim()
    reps[axis] = n
    return torch.cat([a, last.repeat(reps)], dim=axis)


def pad_spectral(phys: Phys, m: ModelArrays,
                 n_shards: int) -> Tuple[Phys, ModelArrays]:
    """(Phys, ModelArrays) with the bin axis padded to a multiple of
    ``n_shards``; as they are when it divides."""
    B, Y = phys.nbin, phys.ny
    nb = padded_nbin(B, n_shards) - B
    if nb == 0:
        return phys, m

    def pad_S(a):    # [.., S], S = B*Y bin-major
        cube = a.reshape(a.shape[:-1] + (B, Y))
        return _edge_pad(cube, -2, nb).reshape(a.shape[:-1] + ((B + nb) * Y,))

    edge = (slices.MODEL_SPECTRAL - {"ktable", "delta_lambda"}) | {
        "lambda_edges"}
    pad = {f: _edge_pad(getattr(m, f), -1, nb) for f in edge}
    pad.update(ktable=pad_S(m.ktable), delta_lambda=torch.cat(
        [m.delta_lambda, m.delta_lambda.new_zeros(
            m.delta_lambda.shape[:-1] + (nb,))], dim=-1))
    return dataclasses.replace(phys, nbin=B + nb), m._replace(**pad)


def pad_species(sset, n_shards: int):
    """A species set with every bin axis padded like :func:`pad_spectral`."""
    if sset is None:
        return None
    B = sset.data[0].opacity_pretab.shape[2]
    nb = padded_nbin(B, n_shards) - B
    if nb == 0:
        return sset
    data = [d._replace(**{f: _edge_pad(getattr(d, f), axis, nb)
                          for f, axis in slices.SPECIES_SPECTRAL.items()})
            for d in sset.data]
    return dataclasses.replace(sset, data=data)


def strip_flux(flux: FluxState, nbin: int, ny: int) -> FluxState:
    """A flux state without its padded bins ([.., S_pad] -> [.., nbin*ny]);
    as it is without padding."""
    if flux.F_down.shape[-1] == nbin * ny:
        return flux
    return FluxState(*(x[..., :nbin * ny] for x in flux))


# --------------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------------- #

def _model_members(m: ModelArrays, n: int) -> List[ModelArrays]:
    """A batch's stacked arrays as ``n`` batches of consecutive members
    (views)."""
    P = m.p_lay.shape[1]
    size = P // n
    return [ModelArrays(*(
        x if MODEL_AXIS[f] is None
        else x.narrow(MODEL_AXIS[f], g * size, size)
        for f, x in zip(m._fields, m))) for g in range(n)]


def place_model(m: ModelArrays, mesh: Mesh) -> List[ModelArrays]:
    """The model on the mesh, one sliced ModelArrays per planet position:
    each array with a bin axis split into that row's slices, the others on
    the row's first device.  A batch's stacked arrays (a planet axis) split
    into consecutive groups of members, one per position; one planet's
    arrays go to every position."""
    n = mesh.shape["planet"]
    if m.p_lay.dim() > 1:
        if m.p_lay.shape[1] % n:
            raise ValueError(f"{m.p_lay.shape[1]} planets not divisible by "
                             f"planet axis {n}")
        groups = _model_members(m, n)
    else:
        groups = [m] * n
    return [ModelArrays(**{
        f: (slices.split(x, row) if f in slices.MODEL_SPECTRAL
            else x.to(row[0]))
        for f, x in g._asdict().items()})
        for g, row in zip(groups, mesh.devices)]


def place_species(sset, mesh: Mesh) -> list:
    """The species set of on-the-fly mixing on the mesh: per planet
    position, one set per slice (:class:`Slices`) holding its bins of the
    opacity tables and Rayleigh cross sections, the rest copied; None for
    no set."""
    if sset is None:
        return [None] * mesh.shape["planet"]

    def row_sets(row):
        parts = [{f: slices.split(getattr(d, f), row, axis)
                  for f, axis in slices.SPECIES_SPECTRAL.items()}
                 for d in sset.data]
        return slices.Slices(dataclasses.replace(
            sset, ktemps=sset.ktemps.to(dev), kpress=sset.kpress.to(dev),
            data=[SpeciesDeviceData(**{
                f: (p[f][k] if f in p else getattr(d, f).to(dev))
                for f in SpeciesDeviceData._fields})
                for d, p in zip(sset.data, parts)])
            for k, dev in enumerate(row))

    return [row_sets(row) for row in mesh.devices]


def on_mesh(fn, models: Sequence[ModelArrays], ssets: Sequence, x):
    """``fn(m, sset, x)`` at every planet position of a placed model, in
    position order: ``x`` (a whole loop state, or temperatures, on the home
    device) split into the positions' members and onto their slices, the
    results gathered whole on the home device and joined member by member.
    One planet (``x`` without a planet axis) runs at the first position."""
    home = slices.home(models[0])
    T = x.T_lay if hasattr(x, "T_lay") else x
    n = len(models) if T.dim() > 1 else 1
    parts = member_groups(x, n) if n > 1 else [x]
    outs = [slices.gather(fn(m, s, slices.scatter(p, m)), home)
            for m, s, p in zip(models[:n], ssets[:n], parts)]
    return join_members(outs, home) if n > 1 else outs[0]


def _thermo_on(thermo: Optional[ThermoProps], m: ModelArrays):
    """The thermodynamics tables on a placed model's home device."""
    if thermo is None:
        return None
    return slices.take(thermo, 0, slices.home(m))


# --------------------------------------------------------------------------- #
# the runners (the JAX package's names)
# --------------------------------------------------------------------------- #

def sharded_forward(phys: Phys, mesh: Mesh):
    """``fwd(m, T_lay) -> FluxTotals``: the forward model on a placed
    model (:func:`place_model`), the totals whole on the home device."""
    def fwd(m, T_lay):
        return on_mesh(lambda mg, _s, t: forward_fluxes(phys, mg, t)[1],
                       m, [None] * len(m), T_lay)

    return fwd


def sharded_radiation_loop(phys: Phys, mesh: Mesh,
                           thermo: Optional[ThermoProps],
                           max_steps: Optional[int] = None):
    """``run(m, T0) -> RadLoopState``: the radiation loop at every planet
    position of a placed batch (T0 [L+1, N]), each group of members over
    its slices."""
    def run(m, T0):
        return on_mesh(lambda mg, _s, t: radiation_loop(
            phys, mg, _thermo_on(thermo, mg), t, max_steps=max_steps),
            m, [None] * len(m), T0)

    return run


def batched_rce_step(phys: Phys, mesh: Mesh, thermo: Optional[ThermoProps]):
    """(``init(m, T0) -> state``, ``step(m, state) -> state``): the state
    before the first radiation iteration and one iteration (flux solve,
    integration, temperature step) of a placed batch."""
    def init(m, T0):
        return on_mesh(lambda mg, _s, t: init_rad_state(phys, mg, t),
                       m, [None] * len(m), T0)

    def step(m, state):
        return on_mesh(lambda mg, _s, s: radiation_loop(
            phys, mg, _thermo_on(thermo, mg), s.T_lay, max_steps=1,
            state0=s), m, [None] * len(m), state)

    return init, step


def production_runners(phys: Phys, mesh: Mesh,
                       thermo: Optional[ThermoProps], sset=None,
                       chunk_iters: Optional[int] = None):
    """The loops of a run on a mesh: (rad_init, rad_run, conv_enter,
    conv_run), each ``fn(m, x)`` of a placed model ``m`` and a whole
    state ``x`` (temperatures for rad_init) on the home device:

      rad_init(m, T0)      -> RadLoopState (before the first iteration)
      rad_run(m, state)    -> RadLoopState (at most chunk_iters iterations)
      conv_enter(m, rad)   -> ConvLoopState (the entry check only)
      conv_run(m, state)   -> ConvLoopState (at most chunk_iters)

    ``sset``: the placed species set (:func:`place_species`) of on-the-fly
    mixing.  ``chunk_iters=None`` runs to convergence in one call."""
    ssets = sset if sset is not None else [None] * mesh.shape["planet"]

    def rad_init(m, T0):
        return on_mesh(lambda mg, sg, t: init_rad_state(phys, mg, t, sg),
                       m, ssets, T0)

    def rad_run(m, state):
        return on_mesh(lambda mg, sg, s: radiation_loop(
            phys, mg, _thermo_on(thermo, mg), s.T_lay,
            max_steps=chunk_iters, sset=sg, state0=s), m, ssets, state)

    def conv_enter(m, rad):
        return on_mesh(lambda mg, sg, r: convection_loop(
            phys, mg, _thermo_on(thermo, mg), r, max_steps=0, sset=sg),
            m, ssets, rad)

    def conv_run(m, state):
        return on_mesh(lambda mg, sg, s: convection_loop(
            phys, mg, _thermo_on(thermo, mg), None, max_steps=chunk_iters,
            sset=sg, state0=s), m, ssets, state)

    return rad_init, rad_run, conv_enter, conv_run

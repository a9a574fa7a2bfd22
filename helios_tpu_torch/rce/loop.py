"""The radiative-convective interplay loop (port of
:mod:`helios_tpu.rce.loop`; reference convection_loop, computation.py:
992-1174, and conv_temp_iter, kernels.cu:2768-2884).

As in the radiation loop, the body keeps its counters on the device and
branches on the host's copy of the counter (:func:`conv_key`), and
:mod:`helios_tpu_torch.rce.graphs` runs one planet's iterations as
replayed CUDA graphs, reading the device once per chunk.  The counter
advances only while the run is not done (computation.py:1109-1164), a
device flag from iteration 400 on (before it the run cannot be done).
Inside a graph the convective adjustment runs a fixed number of rounds.
With a physical timestep the loop makes one convective adjustment and
flux solve and no temperature step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from helios_tpu_torch.forward import (CellCache, FluxState, ModelArrays, Phys,
                                      compute_cells, integrate_flux_flat,
                                      layer_index, solve_fluxes)
from helios_tpu_torch.ops import integrate as int_ops
from helios_tpu_torch.ops import interp as interp_ops
from helios_tpu_torch.rce import convect, graphs
from helios_tpu_torch.rce.radiative import (RadLoopState, ThermoProps,
                                            kappa_cp_lay, kappa_int,
                                            smoothing_flux)


class ConvLoopState(NamedTuple):
    """The convection loop's state; for a batch of P planets laid out as
    :class:`helios_tpu_torch.rce.radiative.RadLoopState` is, with the host
    counters and flags (``keep_running`` too) numpy arrays [P].  Inside the
    loop they are tensors on the device (``graphs.to_device``)."""
    T_lay: torch.Tensor
    flux: FluxState
    cache: CellCache
    totals: int_ops.FluxTotals
    T_store: torch.Tensor
    prefactor: torch.Tensor
    F_smooth_sum: torch.Tensor      # [L]
    conv_layer: torch.Tensor        # [L+1] bool
    marked_red: torch.Tensor        # [L+1] bool (non-converged radiative)
    it: int                         # host counter (advances while not done)
    local_limit: float
    keep_running: bool
    aborted: bool
    steps: int = 0                  # loop bodies run = flux solves


def conv_temp_step(phys: Phys, m: ModelArrays, totals: int_ops.FluxTotals,
                   T_lay, T_store, prefactor, marked_red, it: int,
                   F_add_heat_lay=None):
    """Radiative forward step during the convective phase
    (conv_temp_iter, kernels.cu:2768-2884): prefactor seeds 1e-2 (reset
    1e-3 at iteration 6000), exponent 0.5, delta-T clamp +-20 K, the
    surface driven by the net flux at the first non-converged radiative
    layer, only the lower temperature bound enforced."""
    L = phys.nlayer
    F_net = totals.F_net
    if F_add_heat_lay is None:
        F_add_heat_lay = torch.zeros_like(T_lay[:L])
    F_net_diff = F_net[:L] - F_net[1:L + 1] + F_add_heat_lay
    F_smooth, F_smooth_sum = smoothing_flux(phys, T_lay, m.p_lay)
    combined_lay = F_net_diff + F_smooth

    # surface: F_intern - F_net[j+1] for the first marked_red layer j,
    # falling back to F_net[0] (kernels.cu:2825-2837)
    idx = layer_index(L, T_lay)
    first_red = torch.where(marked_red[:L], idx, L).amin(dim=0)
    at_red = F_net.gather(0, (torch.clamp(first_red, max=L - 1) + 1)[None])[0]
    combined_surf = torch.where(first_red < L, phys.F_intern - at_red,
                                phys.F_intern - F_net[0])
    combined = torch.cat([combined_lay, combined_surf[None]])

    if it == 0:
        prefactor = torch.full_like(prefactor, 1e-2)
    if it == 6000:
        prefactor = torch.full_like(prefactor, 1e-3)

    # pref*p0/dp * sign(c)*|c|^0.5, the form of the JAX package
    absc = torch.abs(combined)
    delta_T = (prefactor * m.p_lay[0] / (m.p_int[0] - m.p_int[1])
               * torch.sign(combined) * absc ** 0.5)
    delta_T = torch.where(torch.abs(delta_T) > 20.0,
                          20.0 * torch.sign(combined), delta_T)

    if it % phys.adapt_interval == 0:
        T_store = T_lay
    if it % phys.adapt_interval == phys.adapt_interval - 1:
        oscillating = (torch.abs(T_lay - T_store)
                       < phys.adapt_interval / 2.0 * torch.abs(delta_T))
        prefactor = torch.where(oscillating, prefactor / 1.5,
                                prefactor * 1.1)

    T_new = torch.clamp(T_lay + delta_T, min=1.001)
    return T_new, T_store, prefactor, F_smooth_sum


def _convection_step(phys: Phys, m: ModelArrays, thermo: ThermoProps,
                     s: ConvLoopState, it: int, local_limit, sset,
                     members=None, rounds=None):
    """The device work of one convection iteration at counter ``it``, up to
    the convergence test (computation.py:1030-1108): (adjusted T, flux,
    cache, totals, conv_layer, marked_red, criterion, adjustment).
    ``members``: the running members of a batch (or the planet's flag),
    the only ones the adjustment corrects; ``rounds``: the adjustment's
    rounds (None: until stable), whose count and overflow flag are
    ``adjustment`` (else None)."""
    # --- convective adjustment (uses the previous iteration's fluxes) ---
    kappa_lay, c_p_lay = kappa_cp_lay(thermo, s.T_lay, m.p_lay)
    T_int = interp_ops.interface_temperatures(s.T_lay)
    kap_int = kappa_int(thermo, T_int, m.p_int)
    T_adj, _conv, *adjustment = convect.convective_adjustment(
        s.T_lay, m.p_lay, m.p_int, kappa_lay, kap_int, c_p_lay,
        s.cache.meanmolmass_lay, iter_value=it,
        T_star=phys.T_star, input_dampara=phys.input_dampara,
        F_intern=phys.F_intern, F_add_heat_sum=s.cache.F_add_heat_sum,
        F_smooth_sum=s.F_smooth_sum, F_down_tot=s.totals.F_down_tot,
        F_up_tot=s.totals.F_up_tot, members=members, rounds=rounds)

    # --- flux calculation with the adjusted profile ---
    T_int = interp_ops.interface_temperatures(T_adj)
    if it % 10 == 0:
        with graphs.span("helios.refresh"):
            cache = compute_cells(phys, m, T_adj, T_int, sset)
    else:
        cache = s.cache
    flux = solve_fluxes(phys, m, cache, T_adj, s.flux)
    totals = integrate_flux_flat(phys, m, flux, cache.F_dir)

    # --- re-mark convective zones with the post-solve temperatures ---
    kappa_lay, c_p_lay = kappa_cp_lay(thermo, T_adj, m.p_lay)
    kap_int = kappa_int(thermo, T_int, m.p_int)
    conv_layer = convect.mark_convective_layers(
        T_adj, m.p_lay, m.p_int, kappa_lay, kap_int, stitching=1,
        iter_value=it)

    # --- convergence on radiative layers only; min 400 iterations ---
    criterion, _converged, marked_red = convect.check_for_radiative_eq(
        T_adj, conv_layer, totals.F_net, totals.F_down_tot,
        F_intern=phys.F_intern, F_add_heat_sum=cache.F_add_heat_sum,
        F_smooth_sum=s.F_smooth_sum, rad_convergence_limit=local_limit)
    return (T_adj, flux, cache, totals, conv_layer, marked_red, criterion,
            tuple(adjustment) or None)


def conv_key(phys: Phys, it: int) -> tuple:
    """The host branches that the body takes at counter ``it``: the cell
    refresh, the prefactor seeds, the adaptive store and adjustment, zone
    stitching past 5000 and the 400 iterations before the run can be
    done.  Iterations of one key run the same ops."""
    a = phys.adapt_interval
    return (it % 10 == 0, it == 0, it == 6000, it % a == 0, it % a == a - 1,
            it > 5000, it < 400)


def _one_convection_iteration(phys: Phys, m: ModelArrays,
                              thermo: ThermoProps, s: ConvLoopState, it: int,
                              sset=None, rounds=None):
    """Body of the convection loop (computation.py:1030-1164) at host
    counter ``it``, on a state with device counters: (the new state,
    unfrozen, and the adjustment's rounds and overflow flag or None).
    The adjustment corrects only the running planet (members of a batch);
    ``not_done`` and the counter's advance are per member."""
    T_adj, flux, cache, totals, conv_layer, marked_red, criterion, adj = (
        _convection_step(phys, m, thermo, s, it,
                         s.local_limit.to(s.T_lay.dtype), sset,
                         members=s.keep_running, rounds=rounds))
    if phys.physical_tstep != 0.0:
        # one convective adjustment only, no temperature iteration
        # (computation.py:1109-1111)
        not_done = torch.zeros_like(criterion)
    elif it < 400:
        not_done = torch.ones_like(criterion)
    else:
        not_done = (~criterion) | (conv_layer.sum(dim=0) == 0)

    # --- radiative forward step while not converged ---
    T_new, T_store, prefactor, F_smooth_sum = (
        T_adj, s.T_store, s.prefactor, s.F_smooth_sum)
    if phys.physical_tstep == 0.0:
        stepped = conv_temp_step(
            phys, m, totals, T_adj, s.T_store, s.prefactor, marked_red, it,
            F_add_heat_lay=cache.F_add_heat_lay)
        if it < 400:
            T_new, T_store, prefactor, F_smooth_sum = stepped
        else:
            T_new, T_store, prefactor, F_smooth_sum = (
                torch.where(not_done, a, b) for a, b in zip(
                    stepped, (T_adj, s.T_store, s.prefactor,
                              s.F_smooth_sum)))
    it_next = s.it + not_done

    local_limit = s.local_limit
    for n in phys.crit_relaxation_numbers:
        local_limit = torch.where(it_next == int(n), local_limit * 10.0,
                                  local_limit)

    hit_cap = it_next > phys.max_nr_iterations
    new = ConvLoopState(
        T_lay=T_new, flux=flux, cache=cache, totals=totals,
        T_store=T_store, prefactor=prefactor, F_smooth_sum=F_smooth_sum,
        conv_layer=conv_layer, marked_red=marked_red, it=it_next,
        local_limit=local_limit, keep_running=not_done & ~hit_cap,
        aborted=s.aborted | hit_cap, steps=s.steps + 1)
    return new, adj


def convection_loop(phys: Phys, m: ModelArrays, thermo: ThermoProps,
                    rad: Optional[RadLoopState],
                    max_steps: Optional[int] = None,
                    sset=None,
                    state0: Optional[ConvLoopState] = None) -> ConvLoopState:
    """Run the radiative-convective interplay to equilibrium.

    Entered from the final radiation-loop state; like the reference, the
    loop runs only when convection is on, the layers are non-isothermal
    and an instability is present (or the radiation loop hit the surface
    overheat), computation.py:996-1009.  ``max_steps`` caps the counter
    (relative to entry); ``sset`` is the species set of on-the-fly opacity
    mixing; ``state0`` continues a previous state instead.

    A batch (a batched ``rad`` or ``state0``) decides the entry per member
    and iterates while any member runs; a member that is done keeps the
    state of its own last iteration.
    """
    if state0 is not None:
        state = state0
    else:
        L = phys.nlayer
        T = rad.T_lay
        batch = tuple(T.shape[1:])
        no = torch.zeros(T.shape, dtype=torch.bool, device=T.device)
        it, limit, keep, aborted, steps = (
            0, float(phys.rad_convergence_limit), True, False, 0)
        if batch:     # one host counter, criterion and flag per member
            it, steps = np.zeros(batch, np.int64), np.zeros(batch, np.int64)
            limit = np.full(batch, limit)
            keep, aborted = np.ones(batch, bool), np.zeros(batch, bool)
        state = ConvLoopState(
            T_lay=T, flux=rad.flux, cache=rad.cache,
            totals=rad.totals, T_store=torch.zeros_like(T),
            prefactor=torch.full_like(T, 1e-2),
            F_smooth_sum=rad.F_smooth_sum, conv_layer=no, marked_red=no,
            it=it, local_limit=limit, keep_running=keep, aborted=aborted,
            steps=steps)
        if phys.singlewalk or not phys.convection or phys.iso:
            return state._replace(keep_running=keep & False)
        # entry check: any convectively unstable layers?
        kappa_lay, _ = kappa_cp_lay(thermo, T, m.p_lay)
        T_int = interp_ops.interface_temperatures(T)
        kap_int = kappa_int(thermo, T_int, m.p_int)
        unstable = convect.conv_check(T, m.p_lay, m.p_int, kappa_lay,
                                      kap_int)
        enter = unstable.any(dim=0) | rad.goto_convection
        with graphs.span("helios.read", graphs.loop_stats("convection"),
                         "read_s"):
            keep = enter.cpu().numpy() if batch else bool(enter)
        state = state._replace(keep_running=keep)

    def bind(phys, m, thermo, sset):
        def body(s, it, rounds):
            return _one_convection_iteration(phys, m, thermo, s, it, sset,
                                             rounds)
        return body, lambda it: conv_key(phys, it)

    if phys.physical_tstep != 0.0:
        # one adjustment and solve, after which the loop is done: no
        # chunk replays iterations past it
        max_steps = 1 if max_steps is None else min(max_steps, 1)

    return graphs.run_loop("convection", (phys, m, thermo, sset), bind,
                           state, max_steps, done_count="steps",
                           adjusts=True)

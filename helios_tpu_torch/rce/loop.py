"""The radiative-convective interplay loop (port of
:mod:`helios_tpu.rce.loop`; reference convection_loop, computation.py:
992-1174, and conv_temp_iter, kernels.cu:2768-2884).

As in the radiation loop, the iteration counter is a host int.  The
counter advances only while the run is not done (computation.py:1109-1164),
so each iteration reads that one device flag back; from iteration 400 on,
since before it the run cannot be done.  With a physical timestep the loop
makes one convective adjustment and flux solve and no temperature step.
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
from helios_tpu_torch.ops.members import (DeviceCopy, freeze_members,
                                          host_value, running_members,
                                          shared_counter)
from helios_tpu_torch.rce import convect
from helios_tpu_torch.rce.radiative import (RadLoopState, ThermoProps,
                                            kappa_cp_lay, kappa_int,
                                            smoothing_flux)


class ConvLoopState(NamedTuple):
    """The convection loop's state; for a batch of P planets laid out as
    :class:`helios_tpu_torch.rce.radiative.RadLoopState` is, with the host
    counters and flags (``keep_running`` too) numpy arrays [P]."""
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
                     members=None):
    """The device work of one convection iteration at counter ``it``, up to
    the convergence test (computation.py:1030-1108): (adjusted T, flux,
    cache, totals, conv_layer, marked_red, criterion).  ``members``: the
    running members of a batch, the only ones the adjustment corrects."""
    # --- convective adjustment (uses the previous iteration's fluxes) ---
    kappa_lay, c_p_lay = kappa_cp_lay(thermo, s.T_lay, m.p_lay)
    T_int = interp_ops.interface_temperatures(s.T_lay)
    kap_int = kappa_int(thermo, T_int, m.p_int)
    T_adj, _conv = convect.convective_adjustment(
        s.T_lay, m.p_lay, m.p_int, kappa_lay, kap_int, c_p_lay,
        s.cache.meanmolmass_lay, iter_value=it,
        T_star=phys.T_star, input_dampara=phys.input_dampara,
        F_intern=phys.F_intern, F_add_heat_sum=s.cache.F_add_heat_sum,
        F_smooth_sum=s.F_smooth_sum, F_down_tot=s.totals.F_down_tot,
        F_up_tot=s.totals.F_up_tot, members=members)

    # --- flux calculation with the adjusted profile ---
    T_int = interp_ops.interface_temperatures(T_adj)
    if it % 10 == 0:
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
    return T_adj, flux, cache, totals, conv_layer, marked_red, criterion


def _one_convection_iteration(phys: Phys, m: ModelArrays,
                              thermo: ThermoProps, s: ConvLoopState,
                              running: np.ndarray, copies,
                              sset=None) -> ConvLoopState:
    """Body of the convection loop (computation.py:1030-1164).  In a batch
    the host branches follow the running members' shared counter,
    ``not_done`` and the counter's advance are per member, and a member
    that has stopped keeps its old state.  ``copies``: the DeviceCopy of
    the criteria, the running members and ``not_done``."""
    limits, run_copy, step_copy = copies
    it = shared_counter(s, running)
    every = running.all()
    run_dev = None if every else run_copy(running)
    T_adj, flux, cache, totals, conv_layer, marked_red, criterion = (
        _convection_step(phys, m, thermo, s, it, limits(s.local_limit),
                         sset, members=run_dev))
    if phys.physical_tstep != 0.0:
        # one convective adjustment only, no temperature iteration
        # (computation.py:1109-1111)
        not_done = np.zeros(running.shape, bool)
    elif it < 400:
        not_done = np.ones(running.shape, bool)
    else:
        not_done = ((~criterion) | (conv_layer.sum(dim=0) == 0)).cpu().numpy()

    # --- radiative forward step while not converged ---
    T_new, T_store, prefactor, F_smooth_sum = (
        T_adj, s.T_store, s.prefactor, s.F_smooth_sum)
    if (not_done & running).any():
        stepped = conv_temp_step(
            phys, m, totals, T_adj, s.T_store, s.prefactor, marked_red, it,
            F_add_heat_lay=cache.F_add_heat_lay)
        if not_done.all():
            T_new, T_store, prefactor, F_smooth_sum = stepped
        else:
            step_dev = step_copy(not_done)
            T_new, T_store, prefactor, F_smooth_sum = (
                torch.where(step_dev, a, b) for a, b in zip(
                    stepped, (T_adj, s.T_store, s.prefactor,
                              s.F_smooth_sum)))
    it_next = it + not_done

    local_limit = s.local_limit
    for n in phys.crit_relaxation_numbers:
        local_limit = np.where(it_next == int(n), local_limit * 10.0,
                               local_limit)

    hit_cap = it_next > phys.max_nr_iterations
    new = ConvLoopState(
        T_lay=T_new, flux=flux, cache=cache, totals=totals,
        T_store=T_store, prefactor=prefactor, F_smooth_sum=F_smooth_sum,
        conv_layer=conv_layer, marked_red=marked_red,
        it=host_value(it_next, s.it),
        local_limit=host_value(local_limit, s.local_limit),
        keep_running=host_value(not_done & ~hit_cap, s.keep_running),
        aborted=host_value(s.aborted | hit_cap, s.aborted),
        steps=s.steps + 1)
    if every:
        return new
    return freeze_members(new, s, (run_dev, running))


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
        state = state._replace(keep_running=(
            enter.cpu().numpy() if batch else bool(enter)))

    T = state.T_lay
    copies = (DeviceCopy(T, T.dtype), DeviceCopy(T), DeviceCopy(T))
    start_it = None
    while True:
        running = running_members(state)
        if not running.any():
            break
        it = shared_counter(state, running)
        start_it = it if start_it is None else start_it
        if max_steps is not None and it - start_it >= max_steps:
            break
        state = _one_convection_iteration(phys, m, thermo, state, running,
                                          copies, sset)
    return state

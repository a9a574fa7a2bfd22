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

import torch

from helios_tpu_torch.forward import (CellCache, FluxState, ModelArrays, Phys,
                                      compute_cells, integrate_flux_flat,
                                      solve_fluxes)
from helios_tpu_torch.ops import integrate as int_ops
from helios_tpu_torch.ops import interp as interp_ops
from helios_tpu_torch.rce import convect
from helios_tpu_torch.rce.radiative import (RadLoopState, ThermoProps,
                                            kappa_cp_lay, kappa_int,
                                            smoothing_flux)


class ConvLoopState(NamedTuple):
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
    idx = torch.arange(L, device=T_lay.device)
    first_red = torch.min(torch.where(marked_red[:L], idx, L))
    combined_surf = torch.where(
        first_red < L,
        phys.F_intern - F_net[torch.clamp(first_red, max=L - 1) + 1],
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


def _one_convection_iteration(phys: Phys, m: ModelArrays,
                              thermo: ThermoProps, s: ConvLoopState,
                              sset=None) -> ConvLoopState:
    """Body of the convection loop (computation.py:1030-1164)."""
    # --- convective adjustment (uses the previous iteration's fluxes) ---
    kappa_lay, c_p_lay = kappa_cp_lay(thermo, s.T_lay, m.p_lay)
    T_int = interp_ops.interface_temperatures(s.T_lay)
    kap_int = kappa_int(thermo, T_int, m.p_int)
    T_adj, _conv = convect.convective_adjustment(
        s.T_lay, m.p_lay, m.p_int, kappa_lay, kap_int, c_p_lay,
        s.cache.meanmolmass_lay, iter_value=s.it,
        T_star=phys.T_star, input_dampara=phys.input_dampara,
        F_intern=phys.F_intern, F_add_heat_sum=s.cache.F_add_heat_sum,
        F_smooth_sum=s.F_smooth_sum, F_down_tot=s.totals.F_down_tot,
        F_up_tot=s.totals.F_up_tot)

    # --- flux calculation with the adjusted profile ---
    T_int = interp_ops.interface_temperatures(T_adj)
    if s.it % 10 == 0:
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
        iter_value=s.it)

    # --- convergence on radiative layers only; min 400 iterations ---
    criterion, _converged, marked_red = convect.check_for_radiative_eq(
        T_adj, conv_layer, totals.F_net, totals.F_down_tot,
        F_intern=phys.F_intern, F_add_heat_sum=cache.F_add_heat_sum,
        F_smooth_sum=s.F_smooth_sum, rad_convergence_limit=s.local_limit)
    if phys.physical_tstep != 0.0:
        # one convective adjustment only, no temperature iteration
        # (computation.py:1109-1111)
        not_done = False
    else:
        not_done = s.it < 400 or bool((~criterion)
                                      | (conv_layer.sum() == 0))

    # --- radiative forward step while not converged ---
    if not_done:
        T_new, T_store, prefactor, F_smooth_sum = conv_temp_step(
            phys, m, totals, T_adj, s.T_store, s.prefactor, marked_red,
            s.it, F_add_heat_lay=cache.F_add_heat_lay)
        it_next = s.it + 1
    else:
        T_new, T_store, prefactor, F_smooth_sum = (
            T_adj, s.T_store, s.prefactor, s.F_smooth_sum)
        it_next = s.it

    local_limit = s.local_limit
    for n in phys.crit_relaxation_numbers:
        if it_next == int(n):
            local_limit = local_limit * 10.0

    hit_cap = it_next > phys.max_nr_iterations
    return ConvLoopState(
        T_lay=T_new, flux=flux, cache=cache, totals=totals,
        T_store=T_store, prefactor=prefactor, F_smooth_sum=F_smooth_sum,
        conv_layer=conv_layer, marked_red=marked_red, it=it_next,
        local_limit=local_limit, keep_running=not_done and not hit_cap,
        aborted=s.aborted or hit_cap, steps=s.steps + 1)


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
    """
    if state0 is not None:
        state = state0
        start_it = state0.it
    else:
        L = phys.nlayer
        kw = dict(dtype=rad.T_lay.dtype, device=rad.T_lay.device)
        no = torch.zeros(L + 1, dtype=torch.bool, device=rad.T_lay.device)
        state = ConvLoopState(
            T_lay=rad.T_lay, flux=rad.flux, cache=rad.cache,
            totals=rad.totals, T_store=torch.zeros(L + 1, **kw),
            prefactor=torch.full((L + 1,), 1e-2, **kw),
            F_smooth_sum=rad.F_smooth_sum, conv_layer=no, marked_red=no,
            it=0, local_limit=float(phys.rad_convergence_limit),
            keep_running=True, aborted=False)
        start_it = 0
        if phys.singlewalk or not phys.convection or phys.iso:
            return state._replace(keep_running=False)
        # entry check: any convectively unstable layers?
        kappa_lay, _ = kappa_cp_lay(thermo, rad.T_lay, m.p_lay)
        T_int = interp_ops.interface_temperatures(rad.T_lay)
        kap_int = kappa_int(thermo, T_int, m.p_int)
        unstable = convect.conv_check(rad.T_lay, m.p_lay, m.p_int,
                                      kappa_lay, kap_int)
        state = state._replace(keep_running=bool(
            torch.any(unstable) | rad.goto_convection))

    while (state.keep_running
           and (max_steps is None or state.it - start_it < max_steps)):
        state = _one_convection_iteration(phys, m, thermo, state, sset)
    return state

"""Radiative temperature iteration (port of :mod:`helios_tpu.rce.radiative`;
reference rad_temp_iter, kernels.cu:2606-2763, and radiation_loop,
computation.py:827-990).

The JAX package runs the loop as one device ``lax.while_loop`` whose
branches are ``lax.cond`` on the iteration counter.  Here the body keeps
its counter, criterion and flags on the device and branches on the host's
copy of the counter (cell refresh every 10th iteration, foreplay,
prefactor resets, criterion relaxation, the overheat check every 100th
iteration, the cap: :func:`rad_key`); :mod:`helios_tpu_torch.rce.graphs`
runs a planet's or a batch's iterations as replayed CUDA graphs, reading
the device once per chunk, and a sliced model one iteration at a time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from helios_tpu_torch import constants as pc
from helios_tpu_torch.device import resolve_device
from helios_tpu_torch.forward import (CellCache, FluxState, ModelArrays, Phys,
                                      compute_cells, integrate_flux_flat,
                                      layer_index, solve_fluxes,
                                      zero_fluxes)
from helios_tpu_torch.kernels.ordered import ordered_cumsum
from helios_tpu_torch.ops import integrate as int_ops
from helios_tpu_torch.ops import interp as interp_ops
from helios_tpu_torch.ops.members import memberwise
from helios_tpu_torch.rce import graphs
from helios_tpu_torch.tracing import span


class ThermoProps(NamedTuple):
    """kappa / c_p / entropy / phase source: a constant kappa
    (c_p = R_univ / kappa [erg/K/mol], reference read.py:1105-1193), or a
    (T, P) table ("file"/"water_atmo" modes) that everything is
    interpolated from (kernels.cu:703-919).  The tables are None for a
    constant kappa; ``phase_table`` is None without the water_atmo
    format."""
    const_kappa: float                          # used when not from_table
    kappa_table: Optional[torch.Tensor] = None  # [nt, np]
    cp_table: Optional[torch.Tensor] = None     # [nt, np]
    entropy_table: Optional[torch.Tensor] = None  # [nt, np] (0 = absent)
    phase_table: Optional[torch.Tensor] = None  # [nt, np] water_atmo only
    temps: Optional[torch.Tensor] = None        # [nt]
    press: Optional[torch.Tensor] = None        # [np]

    @property
    def from_table(self) -> bool:
        return self.kappa_table is not None

    @property
    def has_phase(self) -> bool:
        return self.phase_table is not None


def make_const_thermo(kappa_value: float) -> ThermoProps:
    return ThermoProps(const_kappa=float(kappa_value))


def make_table_thermo(tbl, dtype=torch.float64, device="cuda") -> ThermoProps:
    """ThermoProps from a loaded :class:`helios_tpu_torch.thermo.EntropyTable`
    (the kappa_value = "file"/"water_atmo" modes, read.py:1121-1165), with
    the tables on ``device`` (default CUDA; raises if CUDA is absent)."""
    dev = resolve_device(device)
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    return ThermoProps(
        const_kappa=0.0, kappa_table=t(tbl.kappa), cp_table=t(tbl.cp),
        entropy_table=t(tbl.entropy),
        phase_table=t(tbl.phase) if tbl.phase is not None else None,
        temps=t(tbl.temps), press=t(tbl.press))


def kappa_cp_lay(thermo: ThermoProps, T_lay, p_lay):
    """kappa and c_p on layer centers (computation.py:199-232)."""
    L = p_lay.shape[0]
    if thermo.from_table:
        kappa = interp_ops.interpolate_kappa(
            thermo.kappa_table, thermo.temps, thermo.press, T_lay[:L], p_lay)
        cp = interp_ops.interpolate_cp(
            thermo.cp_table, thermo.temps, thermo.press, T_lay[:L], p_lay)
        return kappa, cp
    kappa = torch.full_like(p_lay, thermo.const_kappa, dtype=T_lay.dtype)
    cp = torch.full_like(p_lay, pc.R_UNIV / thermo.const_kappa,
                         dtype=T_lay.dtype)
    return kappa, cp


def kappa_int(thermo: ThermoProps, T_int, p_int):
    """kappa on the interfaces."""
    if thermo.from_table:
        return interp_ops.interpolate_kappa(
            thermo.kappa_table, thermo.temps, thermo.press, T_int, p_int)
    return torch.full_like(p_int, thermo.const_kappa, dtype=T_int.dtype)


# --------------------------------------------------------------------------- #
# smoothing flux
# --------------------------------------------------------------------------- #

def smoothing_flux(phys: Phys, T_lay, p_lay):
    """Temperature smoothing force and its cumulative sum
    (kernels.cu:2653-2670): F_smooth[i] = (t_mid - T[i])^7, t_mid the
    neighbour mean for 0 < i < L-1 with p_lay < 1 bar, else T[i].
    Returns (F_smooth [L], F_smooth_sum [L])."""
    L = phys.nlayer
    if not phys.smooth:
        z = torch.zeros_like(T_lay[:L])
        return z, z
    t = T_lay[:L]
    mid = torch.cat([t[:1], 0.5 * (t[:-2] + t[2:]), t[-1:]])
    idx = layer_index(L, t)
    use_mid = (p_lay < 1e6) & (idx > 0) & (idx < L - 1)
    t_mid = torch.where(use_mid, mid, t)
    # odd power of a signed base: pow keeps the sign, as in the reference
    F_smooth = memberwise(lambda x: torch.pow(x, 7.0), t_mid - t,
                          batched=t.dim() > 1)
    return F_smooth, ordered_cumsum(F_smooth, 0)


# --------------------------------------------------------------------------- #
# the temperature step
# --------------------------------------------------------------------------- #

class RadTempResult(NamedTuple):
    T_lay: torch.Tensor
    T_store: torch.Tensor
    prefactor: torch.Tensor
    F_smooth_sum: torch.Tensor   # [L]
    abort: torch.Tensor          # [L+1] bool


def rad_temp_step(phys: Phys, m: ModelArrays, totals: int_ops.FluxTotals,
                  T_lay, T_store, prefactor, it: int, local_limit: float,
                  c_p_lay=None, meanmolmass_lay=None,
                  F_add_heat_lay=None, F_add_heat_sum=None) -> RadTempResult:
    """One radiative temperature update (rad_temp_iter, kernels.cu:
    2606-2763): the adaptive pseudo-timestep, or with
    ``phys.physical_tstep`` the constant physical timestep, which needs
    ``c_p_lay`` [erg/K/mol] and ``meanmolmass_lay`` [g].  [L+1] vectors
    include the surface/BOA ghost layer at index L; ``it`` is the host
    counter; ``local_limit`` the criterion, a number or a tensor of the
    run's dtype ([P] for a batch)."""
    L = phys.nlayer
    F_net = totals.F_net
    if F_add_heat_lay is None:
        F_add_heat_lay = torch.zeros_like(T_lay[:L])
        F_add_heat_sum = torch.zeros_like(T_lay[:L])
    F_net_diff = F_net[:L] - F_net[1:L + 1] + F_add_heat_lay
    F_smooth, F_smooth_sum = smoothing_flux(phys, T_lay, m.p_lay)
    combined_lay = F_net_diff + F_smooth

    # ghost layer: driven by F_intern - F_net[0], or F_net[1] when the
    # bottom layer is not converged (kernels.cu:2675-2683)
    denom_crit = totals.F_down_tot[L] + phys.F_intern
    use_above = (torch.abs(phys.F_intern - F_net[1]) / denom_crit
                 > 0.5 * local_limit)
    combined_surf = torch.where(use_above, phys.F_intern - F_net[1],
                                phys.F_intern - F_net[0])
    combined = torch.cat([combined_lay, combined_surf[None]])

    if phys.physical_tstep == 0.0:
        if it == phys.foreplay:
            prefactor = torch.ones_like(prefactor)
        if it == 10000:
            prefactor = torch.full_like(prefactor, 1e-1)

        # delta_T = pref*p0/dp * sign(c)*|c|^0.1, the form of the JAX
        # package (algebraically kernels.cu:2695-2698)
        absc = torch.abs(combined)
        delta_T = (prefactor * m.p_lay[0] / (m.p_int[0] - m.p_int[1])
                   * torch.sign(combined)
                   * memberwise(lambda x: x ** 0.1, absc,
                                batched=absc.dim() > 1))
        delta_T = torch.where(torch.abs(delta_T) > 500.0,
                              500.0 * torch.sign(combined), delta_T)

        if it % phys.adapt_interval == 0:
            T_store = T_lay
        if it % phys.adapt_interval == phys.adapt_interval - 1:
            oscillating = (torch.abs(T_lay - T_store)
                           < phys.adapt_interval / 2.0 * torch.abs(delta_T))
            prefactor = torch.where(oscillating, prefactor / 1.5,
                                    prefactor * 1.1)
    else:
        # constant physical timestep with c_p (kernels.cu:2727-2735)
        cp_per_g = c_p_lay / (meanmolmass_lay / pc.AMU)
        dp = m.p_int[:L] - m.p_int[1:]
        dT_lay = (phys.g / cp_per_g * combined_lay / dp
                  * phys.physical_tstep)
        dT_surf = (phys.g / cp_per_g[0] * combined_surf
                   / (m.p_int[0] - m.p_int[1]) * phys.physical_tstep)
        delta_T = torch.cat([dT_lay, dT_surf[None]])

    T_new = T_lay + delta_T
    if phys.no_atmo:
        # no atmosphere above the surface (kernels.cu:2741-2743)
        T_new = torch.cat([torch.full_like(T_new[:L], 1.001), T_new[L:]])
    max_limit = phys.plancktable_dim * phys.plancktable_step - 1.001
    T_new = torch.clamp(T_new, 1.001, max_limit)

    # per-layer convergence flags (kernels.cu:2750-2762)
    crit_lay = (torch.abs(phys.F_intern + F_add_heat_sum + F_smooth_sum
                          - F_net[1:L + 1]) / denom_crit < local_limit)
    crit_surf = (torch.abs(phys.F_intern - F_net[0]) / denom_crit
                 < local_limit)
    abort = torch.cat([crit_lay, crit_surf[None]])
    return RadTempResult(T_lay=T_new, T_store=T_store, prefactor=prefactor,
                         F_smooth_sum=F_smooth_sum, abort=abort)


# --------------------------------------------------------------------------- #
# the radiation loop
# --------------------------------------------------------------------------- #

class RadLoopState(NamedTuple):
    """The radiation loop's state.  For a batch of P planets the tensors
    carry the planet axis after the layer axis ([L+1, P], [I, P, S]), the
    device flags are [P], and the host counters and flags are numpy arrays
    [P]: one value per member.  Inside the loop the counters are tensors on
    the device (``graphs.to_device``): ``it`` int64, ``local_limit``
    float64, ``aborted`` bool."""
    T_lay: torch.Tensor
    flux: FluxState
    cache: CellCache
    totals: int_ops.FluxTotals
    T_store: torch.Tensor
    prefactor: torch.Tensor
    F_smooth_sum: torch.Tensor
    abort: torch.Tensor
    it: int                         # host iteration counter
    local_limit: float              # relaxable convergence criterion
    keep_running: torch.Tensor      # 0-d bool on the device
    goto_convection: torch.Tensor   # 0-d bool (surface overheat)
    aborted: bool                   # max iteration cap hit


def _radiation_step(phys: Phys, m: ModelArrays,
                    thermo: Optional[ThermoProps], s: RadLoopState, it: int,
                    local_limit, sset):
    """The device work of one radiation iteration at counter ``it``
    (computation.py:851-981): (cache, flux, totals, temperature result,
    overheat, converged)."""
    L = phys.nlayer
    if it % 10 == 0:
        T_int = interp_ops.interface_temperatures(s.T_lay)
        with span("helios.refresh"):
            cache = compute_cells(phys, m, s.T_lay, T_int, sset)
    else:
        cache = s.cache

    flux = solve_fluxes(phys, m, cache, s.T_lay, s.flux)
    totals = integrate_flux_flat(phys, m, flux, cache.F_dir)

    c_p_lay = None
    if phys.physical_tstep != 0.0 and thermo is not None:
        _kappa_lay, c_p_lay = kappa_cp_lay(thermo, s.T_lay, m.p_lay)

    # temperature stepping only after the foreplay prerun
    # (computation.py:906-932)
    stepping = it >= phys.foreplay
    if stepping:
        res = rad_temp_step(phys, m, totals, s.T_lay, s.T_store,
                            s.prefactor, it, local_limit,
                            c_p_lay=c_p_lay,
                            meanmolmass_lay=cache.meanmolmass_lay,
                            F_add_heat_lay=cache.F_add_heat_lay,
                            F_add_heat_sum=cache.F_add_heat_sum)
    else:
        res = RadTempResult(T_lay=s.T_lay, T_store=s.T_store,
                            prefactor=s.prefactor,
                            F_smooth_sum=s.F_smooth_sum,
                            abort=torch.zeros_like(s.abort))

    # surface overheat -> jump to the convection loop (computation.py:
    # 946-952); checked every 100th iteration like the reference
    no = torch.zeros_like(s.keep_running)
    overheat = no
    if it % 100 == 0:
        overheat = (res.T_lay[L]
                    >= phys.plancktable_dim * phys.plancktable_step - 2)
    converged = res.abort.all(dim=0) if stepping else no
    return cache, flux, totals, res, overheat, converged


def _relaxed(phys: Phys, it_next: int, local_limit):
    """The criterion relaxation x10 at the configured iteration numbers
    (computation.py:974-975, host_functions.py:243-248)."""
    for n in phys.crit_relaxation_numbers:
        if it_next == int(n):
            local_limit = local_limit * 10.0
    return local_limit


def _stop(phys: Phys, it_next: int):
    """(iteration cap hit, out of time): a physical timestep runs until the
    run time reaches its limit (computation.py:941-943)."""
    hit_cap = it_next > phys.max_nr_iterations
    out_of_time = (phys.physical_tstep != 0.0
                   and not it_next * phys.physical_tstep < phys.runtime_limit)
    return hit_cap, out_of_time


def rad_key(phys: Phys, it: int) -> tuple:
    """The host branches that the body takes at counter ``it``: the cell
    refresh, the stepping after the foreplay, the prefactor resets, the
    adaptive store and adjustment, the overheat check, the relaxations and
    the stop at ``it + 1``.  Iterations of one key run the same ops."""
    a, nxt = phys.adapt_interval, it + 1
    relax = sum(nxt == int(n) for n in phys.crit_relaxation_numbers)
    return (it % 10 == 0, it >= phys.foreplay, it == phys.foreplay,
            it == 10000, it % a == 0, it % a == a - 1, it % 100 == 0, relax,
            *_stop(phys, nxt))


def _one_radiation_iteration(phys: Phys, m: ModelArrays,
                             thermo: Optional[ThermoProps],
                             s: RadLoopState, it: int, sset=None):
    """Body of the radiation loop (computation.py:851-981) at host counter
    ``it``, on a state with device counters: the new state, unfrozen (the
    loops of :mod:`graphs` keep a stopped planet's or member's state)."""
    cache, flux, totals, res, overheat, converged = _radiation_step(
        phys, m, thermo, s, it, s.local_limit.to(s.T_lay.dtype), sset)
    it_next = it + 1
    hit_cap, out_of_time = _stop(phys, it_next)
    keep = (torch.zeros_like(converged) if hit_cap or out_of_time
            else ~converged & ~overheat)
    return RadLoopState(
        T_lay=res.T_lay, flux=flux, cache=cache, totals=totals,
        T_store=res.T_store, prefactor=res.prefactor,
        F_smooth_sum=res.F_smooth_sum, abort=res.abort, it=s.it + 1,
        local_limit=_relaxed(phys, it_next, s.local_limit),
        keep_running=keep, goto_convection=s.goto_convection | overheat,
        aborted=s.aborted | hit_cap)


def init_rad_state(phys: Phys, m: ModelArrays, T_lay0,
                   sset=None) -> RadLoopState:
    """The state before the first iteration; T_lay0 [L+1], or [L+1, P] for
    a batch (with stacked arrays)."""
    L = phys.nlayer
    dev = T_lay0.device
    batch = tuple(T_lay0.shape[1:])
    T_int = interp_ops.interface_temperatures(T_lay0)
    cache = compute_cells(phys, m, T_lay0, T_int, sset)
    flux = zero_fluxes(phys, m, T_lay0)
    totals = integrate_flux_flat(phys, m, flux, cache.F_dir)
    limit = float(phys.rad_convergence_limit)
    it, aborted = 0, False
    if batch:     # one host counter, criterion and flag per member
        it, limit = np.zeros(batch, np.int64), np.full(batch, limit)
        aborted = np.zeros(batch, bool)
    return RadLoopState(
        T_lay=T_lay0, flux=flux, cache=cache, totals=totals,
        T_store=torch.zeros_like(T_lay0), prefactor=torch.ones_like(T_lay0),
        F_smooth_sum=torch.zeros_like(T_lay0[:L]),
        abort=torch.zeros(T_lay0.shape, dtype=torch.bool, device=dev),
        it=it, local_limit=limit,
        keep_running=torch.ones(batch, dtype=torch.bool, device=dev),
        goto_convection=torch.zeros(batch, dtype=torch.bool, device=dev),
        aborted=aborted)


def radiation_loop(phys: Phys, m: ModelArrays, thermo: Optional[ThermoProps],
                   T_lay0, max_steps: Optional[int] = None,
                   sset=None,
                   state0: Optional[RadLoopState] = None) -> RadLoopState:
    """Run the radiative-equilibrium iteration to convergence
    (computation.py:827-990).  A model whole on one device, a planet's or
    a batch's, runs in chunks of :mod:`graphs` (on the card each iteration
    a replayed CUDA graph), with one read of the device per chunk; a
    sliced model reads its flags after every iteration.  The runner is the
    one kept from an earlier loop of the same key, or one of this call
    alone (``graphs.Loops.runner``).

    ``max_steps`` caps this call; ``sset`` is the species set of on-the-fly
    opacity mixing; ``state0`` continues from a prior state instead of
    initializing from ``T_lay0``.  ``thermo`` gives c_p to a physical
    timestep; the adaptive-timestep iteration does not use it.
    A post-processing run (``phys.singlewalk``) makes one flux solve with
    1000*scat+1 sweep passes and no temperature step
    (computation.py:983-984); it reads nothing back.

    A batch of planets (T_lay0 [L+1, P] with stacked arrays, or a batched
    ``state0``) iterates while any member runs, each flux solve one kernel
    launch for all of them; a member that converges keeps the state of its
    own last iteration, so it ends as its run alone would.
    """
    state = (state0 if state0 is not None
             else init_rad_state(phys, m, T_lay0, sset))
    if phys.singlewalk:
        flux = solve_fluxes(phys, m, state.cache, state.T_lay, state.flux)
        totals = integrate_flux_flat(phys, m, flux, state.cache.F_dir)
        return state._replace(flux=flux, totals=totals)

    def bind(phys, m, thermo, sset):
        def body(s, it, rounds):
            return _one_radiation_iteration(phys, m, thermo, s, it,
                                            sset), None
        return body, lambda it: rad_key(phys, it)

    return graphs.run_loop("radiation", (phys, m, thermo, sset), bind, state,
                           max_steps, done_count="it", adjusts=False)

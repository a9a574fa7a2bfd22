"""Convective adjustment on the device (port of :mod:`helios_tpu.rce.convect`;
reference host_functions.py:337-635).

Instability check, zone marking, hole stitching and the enthalpy-conserving
dry-adiabat correction with fudge-factor rebalancing, as vectorized segment
operations over the layer column.  The one loop, the adjustment's
"correct until stable" iteration, either runs on the host and reads one
flag per round, or runs a fixed number of rounds on the device (inside the
loops' CUDA graphs) and reports whether that was enough.

On the CPU the adjustment is this chain of PyTorch ops
(:func:`plain_adjustment`); on the card it is the CUDA kernel
:func:`helios_tpu_torch.kernels.adjust.conv_adjust`, bit for bit the chain
on the card, one launch for a fixed number of rounds and one per round
(and one more) for the host's loop.  The checks and marks that the loops
make outside the adjustment stay the chain's on either device.

Index conventions follow the reference: layers 0..L-1 bottom-up, plus a
surface/BOA "ghost layer" at index L.  A convective zone that includes the
ghost layer starts at virtual index -1 (host_functions.py:388-389).

A batch of P planets passes every per-layer array as [L, P] (the layer
axis first): zones, segment sums and fudge factors are then per member,
and the adjustment's host loop runs while any member is unstable,
correcting only those.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from helios_tpu_torch import constants as pc
from helios_tpu_torch.forward import layer_index
from helios_tpu_torch.kernels import adjust
from helios_tpu_torch.kernels.ordered import ordered_cumsum
from helios_tpu_torch.ops.members import memberwise
from helios_tpu_torch.tracing import running_stats, span

# pressure above which the top atmosphere is ignored by the instability
# check (artificial temperature peaks occur there); host_functions.py:345
P_TOP_IGNORE = 1e1
# zone-gap width threshold: gaps narrower than one scale height (ratio 1/e)
# are stitched / skipped when picking the fudge test interface
# (host_functions.py:418, :631)
GAP_RATIO = 1.0 / math.e


def _pair_unstable(T_lay, p_lay, p_int, kappa_lay, kappa_int, pert):
    """Adjacent-layer instability flags pair[i], i = 0..L-2: layer i+1 is
    colder than the adiabat through layer i (host_functions.py:343-355,
    :552-565).  Layers with p_lay <= 10 ubar are masked."""
    L = T_lay.shape[0] - 1
    pow_ = lambda x, e: memberwise(torch.pow, x, e, batched=T_lay.dim() > 1)
    T_between = T_lay[:L - 1] * pow_(p_int[1:L] / p_lay[:L - 1],
                                     kappa_lay[:L - 1] * (1.0 + pert))
    T_ad = T_between * pow_(p_lay[1:L] / p_int[1:L],
                            kappa_int[1:L] * (1.0 + pert))
    mask = p_lay[:L - 1] > P_TOP_IGNORE
    return (T_lay[1:L] < T_ad) & mask


def _surface_unstable(T_lay, p_lay, p_int, kappa_int, pert):
    """Ghost-layer/BOA instability (host_functions.py:357-362, :572-577)."""
    L = T_lay.shape[0] - 1
    T_ad = T_lay[L] * memberwise(torch.pow, p_lay[0] / p_int[0],
                                 kappa_int[0] * (1.0 + pert),
                                 batched=T_lay.dim() > 1)
    return T_lay[0] < T_ad


def _take(x, idx):
    """x[idx] along the layer axis, per member of a batch (idx has x's
    trailing shape)."""
    return x.gather(0, idx)


def _mark_pairs(pair, surf):
    """[L+1] flags: pair i marks layers i and i+1; the surface flag marks
    the ghost and layer 0."""
    L = pair.shape[0] + 1
    flags = torch.zeros((L + 1,) + pair.shape[1:], dtype=torch.bool,
                        device=pair.device)
    flags[:L - 1] = pair
    flags[1:L] |= pair
    flags[L] = surf
    flags[0] |= surf
    return flags


def conv_check(T_lay, p_lay, p_int, kappa_lay, kappa_int):
    """Unstable-layer flags [L+1] (host_functions.py:337-362)."""
    pair = _pair_unstable(T_lay, p_lay, p_int, kappa_lay, kappa_int, +1e-6)
    surf = _surface_unstable(T_lay, p_lay, p_int, kappa_int, +1e-6)
    return _mark_pairs(pair, surf)


def mark_convective_layers(T_lay, p_lay, p_int, kappa_lay, kappa_int, *,
                           stitching, iter_value: int):
    """Convective-zone flags [L+1] (host_functions.py:545-582):
    conv[k] = pair[k-1] | pair[k], then the kink removal (conv[i] = 0
    where T[i+1] > T[i]) and the surface condition; holes are stitched
    after iteration 5000 when ``stitching``."""
    L = T_lay.shape[0] - 1
    pair = _pair_unstable(T_lay, p_lay, p_int, kappa_lay, kappa_int, -1e-6)
    conv = torch.zeros(T_lay.shape, dtype=torch.bool, device=T_lay.device)
    conv[:L - 1] = pair
    conv[1:L] |= pair
    # kink removal at the top edge of convective zones (:568-570)
    conv[:L - 1] &= ~(T_lay[1:L] > T_lay[:L - 1])
    surf = _surface_unstable(T_lay, p_lay, p_int, kappa_int, -1e-6)
    conv[L] = surf
    conv[0] |= surf
    if stitching and iter_value > 5000:  # reference threshold (:581)
        conv = stitch_zone_holes(conv, p_lay, p_int)
    return conv


def stitch_zone_holes(conv, p_lay, p_int):
    """Fill radiative gaps narrower than one scale height between
    convective zones (host_functions.py:585-635): a radiative layer is
    filled iff convective layers exist below (or the ghost, index -1) and
    above, and p_lay[above] / p_bot > 1/e."""
    L = p_lay.shape[0]
    dt = p_lay.dtype
    idx = layer_index(L, p_lay).to(dt)
    inf = torch.full((), math.inf, dtype=dt, device=p_lay.device)

    # nearest convective index below (inclusive running max); ghost = -1
    ghost_below = torch.where(conv[L], torch.full_like(inf, -1.0), -inf)
    below_seed = torch.where(conv[:L], idx, -inf)
    below = torch.cummax(torch.cat([ghost_below[None], below_seed]),
                         0).values[1:]
    # nearest convective index above (reverse running min)
    above_seed = torch.where(conv[:L], idx, inf)
    above = torch.flip(torch.cummin(torch.flip(above_seed, [0]), 0).values,
                       [0])

    has_below = below > -inf
    has_above = above < inf
    below_i = torch.clamp(below, -1, L - 1).long()
    above_i = torch.clamp(above, 0, L - 1).long()

    p_bot = torch.where(below_i >= 0,
                        _take(p_lay, torch.clamp(below_i, min=0)), p_int[0])
    p_top = _take(p_lay, above_i)
    fill = (~conv[:L]) & has_below & has_above & (p_top / p_bot > GAP_RATIO)
    out = conv.clone()
    out[:L] |= fill
    return out


# --------------------------------------------------------------------------- #
# zone segmentation
# --------------------------------------------------------------------------- #

class Zones(NamedTuple):
    """Fixed-size zone description over the extended index range
    (position 0 = ghost layer, position i+1 = layer i).  Up to L+1
    zones, padded with -2."""
    zone_of_layer: torch.Tensor   # [L] zone id of each layer (-1 radiative)
    start: torch.Tensor           # [L+1] start layer per zone (-1 = ghost)
    end: torch.Tensor             # [L+1] end layer per zone
    n_zones: torch.Tensor         # 0-d
    ghost_in_zone0: torch.Tensor  # 0-d bool: ghost belongs to zone 0


def find_zones(corrected) -> Zones:
    """Segment the corrected [L+1] flags (index L = ghost) into contiguous
    zones (host_functions.py:371-395)."""
    L = corrected.shape[0] - 1
    dev = corrected.device
    ext = torch.cat([corrected[L:L + 1], corrected[:L]])
    false = torch.zeros_like(ext[:1])
    prev = torch.cat([false, ext[:-1]])
    is_start = ext & ~prev
    nxt = torch.cat([ext[1:], false])
    is_end = ext & ~nxt

    zone_id_ext = torch.cumsum(is_start.long(), 0) - 1   # 0-based
    zone_id_ext = torch.where(ext, zone_id_ext, -1)

    # ghost -1
    layer_index_ext = (layer_index(L + 1, ext) - 1).expand(ext.shape)
    n_max = L + 1
    # slot n_max is a sentinel that takes every non-start/non-end position
    # and is sliced off (the JAX package drops such out-of-range updates)
    sidx = torch.where(is_start, zone_id_ext, n_max)
    eidx = torch.where(is_end, zone_id_ext, n_max)
    shape = (n_max + 1,) + ext.shape[1:]
    start = torch.full(shape, -2, dtype=torch.long, device=dev)
    end = torch.full(shape, -2, dtype=torch.long, device=dev)
    start = start.scatter(0, sidx, layer_index_ext)[:n_max]
    end = end.scatter(0, eidx, layer_index_ext)[:n_max]
    return Zones(zone_of_layer=zone_id_ext[1:], start=start, end=end,
                 n_zones=is_start.sum(dim=0), ghost_in_zone0=ext[0])


# --------------------------------------------------------------------------- #
# dry-adiabat correction
# --------------------------------------------------------------------------- #

def _adiabat_factors(p_lay, p_int, kappa_lay, kappa_int, zones: Zones):
    """Per-layer adiabat factor within its zone (host_functions.py:467-499):
    factor(i) = b[i] * prod_{j=s..i-1} a[j], with
      a[j] = (p_lay[j]/p_int[j])^kappa_int[j] * (p_int[j+1]/p_lay[j])^kappa_lay[j]
      b[i] = (p_lay[i]/p_int[i])^kappa_int[i],  s = max(0, zone start)."""
    L = p_lay.shape[0]
    batched = p_lay.dim() > 1
    log = lambda x: memberwise(torch.log, x, batched=batched)
    log_a = (kappa_int[:L] * log(p_lay / p_int[:L])
             + kappa_lay * log(p_int[1:] / p_lay))
    log_b = kappa_int[:L] * log(p_lay / p_int[:L])

    cs = ordered_cumsum(log_a, 0)
    cs_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])   # sum_{j<i}

    s = torch.clamp(_take(zones.start,
                          torch.clamp(zones.zone_of_layer, min=0)), min=0)
    seg_sum = cs_prev - _take(cs_prev, s)
    idx = layer_index(L, p_lay)
    seg_sum = torch.where(idx > s, seg_sum, torch.zeros_like(seg_sum))
    return memberwise(torch.exp, log_b + seg_sum, batched=batched)


def _segment_sum(values, seg, n):
    """sum of values[j] over j with seg[j] == k, for k < n.

    A one-hot [n, len] mask summed in index order (cumsum's last column,
    kernels.ordered on the card): deterministic, unlike an atomic
    ``index_add_``, the same for a planet alone and in a batch, and the
    same order as the sequential scatter-add of the JAX package on the
    CPU, so a 1-ulp difference cannot flip a convergence decision."""
    onehot = seg[None] == layer_index(n, seg[None])
    masked = torch.where(onehot, values[None], torch.zeros_like(values))
    return ordered_cumsum(masked, 1)[:, -1]


def conv_correct(T_lay, p_lay, p_int, kappa_lay, kappa_int, c_p_lay,
                 meanmolmass_lay, corrected, fudge_per_zone=None):
    """Set each corrected zone onto its dry adiabat, conserving enthalpy
    (host_functions.py:368-506).  ``corrected``: [L+1] bool flags;
    ``fudge_per_zone``: optional [L+1] factors.  Returns T_lay [L+1]."""
    L = T_lay.shape[0] - 1
    zones = find_zones(corrected)
    factor = _adiabat_factors(p_lay, p_int, kappa_lay, kappa_int, zones)

    # enthalpy weight c_p/mmm * delta_p, rescaled by AMU/p_int[0] as in
    # the JAX package (the global scale cancels in num/denom)
    w = (c_p_lay / (meanmolmass_lay / pc.AMU)
         * ((p_int[:L] - p_int[1:]) / p_int[0]))
    zl = zones.zone_of_layer
    in_zone = zl >= 0
    seg = torch.where(in_zone, zl, L)   # radiative layers go to slot L
    zero = torch.zeros_like(w)

    num = _segment_sum(torch.where(in_zone, w * T_lay[:L], zero), seg, L + 1)
    denom = _segment_sum(torch.where(in_zone, w * factor, zero), seg, L + 1)
    mean_pot = torch.where(
        denom != 0.0,
        num / torch.where(denom == 0, torch.ones_like(denom), denom),
        torch.zeros_like(num))
    if fudge_per_zone is not None:
        mean_pot = mean_pot * fudge_per_zone
    T_new_lay = torch.where(in_zone, _take(mean_pot, seg) * factor,
                            T_lay[:L])

    # ghost layer: if zone 0 includes the ghost, T_surface takes the zone's
    # mean potential temperature (host_functions.py:503-506)
    T_surf = torch.where(zones.ghost_in_zone0, mean_pot[0], T_lay[L])
    return torch.cat([T_new_lay, T_surf[None]])


def fudge_factors(zones: Zones, p_lay, p_int, T_star, input_dampara,
                  F_intern, F_add_heat_sum, F_smooth_sum, F_down_tot,
                  F_up_tot):
    """Per-zone energy-rebalancing fudge factors (host_functions.py:404-447).

    For zone n the test interface is the middle of the first radiative gap
    above a zone m >= n that is wider than a scale height, else
    int(0.8*end_last + 0.2*L).  dampara: 0.5 intermediate / 4 top (stellar
    irradiation) or 8 (self-luminous), unless user-set.
    Returns [L+1] factors (1.0 for empty slots)."""
    L = p_lay.shape[0]
    n_max = L + 1
    dt, dev = p_lay.dtype, p_lay.device
    z = layer_index(n_max, p_lay)
    valid = z < zones.n_zones
    last = zones.n_zones - 1

    start_next = torch.cat([zones.start[1:], zones.start[-1:]])
    end_m = zones.end
    p_bot = torch.where(end_m >= 0, _take(p_lay, torch.clamp(end_m, min=0)),
                        p_int[0])
    p_top = _take(p_lay, torch.clamp(start_next, 0, L - 1))
    wide = ((p_top / p_bot) < GAP_RATIO) & (z < last) & valid

    cand_itf = torch.div(end_m + start_next + 1, 2, rounding_mode="floor")

    # first wide gap at index >= n: reverse running min of the wide
    # indices (n_max where not wide), -1 if none
    wide_idx = torch.where(wide, z, n_max)
    first_wide = torch.flip(torch.cummin(torch.flip(wide_idx, [0]), 0).values,
                            [0])
    has_wide = first_wide < n_max

    end_last = _take(zones.end, torch.clamp(last, min=0)[None])[0]
    itf_top = (0.8 * end_last.to(dt) + 0.2 * L).long()
    itf = torch.where(has_wide,
                      _take(cand_itf, torch.clamp(first_wide, max=n_max - 1)),
                      itf_top)
    itf = torch.clamp(itf, 1, L)   # itf-1 indexes F_*_sum

    shape = zones.end.shape
    full = lambda v: torch.full(shape, v, dtype=dt, device=dev)
    if input_dampara == "automatic":
        if T_star > 10.0:
            dampara = torch.where(z < last, full(0.5), full(4.0))
        else:
            dampara = full(8.0)
    else:
        dampara = full(float(input_dampara))

    fudge = memberwise(
        torch.pow, (F_intern + _take(F_add_heat_sum, itf - 1)
                    + _take(F_smooth_sum, itf - 1) + _take(F_down_tot, itf))
        / _take(F_up_tot, itf), 1.0 / dampara, batched=p_lay.dim() > 1)
    fudge = torch.clamp(fudge, 0.99, 1.01)
    return torch.where(valid, fudge, torch.ones_like(fudge))


def convective_adjustment(T_lay, p_lay, p_int, kappa_lay, kappa_int,
                          c_p_lay, meanmolmass_lay, *, iter_value: int,
                          T_star, input_dampara, F_intern, F_add_heat_sum,
                          F_smooth_sum, F_down_tot, F_up_tot, members=None,
                          rounds=None):
    """Full convective adjustment (host_functions.py:509-542): correct
    (mark -> correct -> re-check) until no instability remains, then apply
    the stitched, fudged final correction.  Returns (T_lay, conv_layer
    [L+1] bool).

    A round changes only the layers of planets unstable at its start, so a
    round after stability changes no bit.  With ``rounds`` None the rounds
    run while any is unstable, a host loop reading one flag per round;
    with ``rounds`` = K exactly K rounds run, nothing is read, and the
    result gains two 0-d device tensors: the rounds that had an unstable
    planet, and whether one is still unstable after the K-th (the result
    is then not the adjustment's).

    A batch loops while any member is unstable, and a round changes only
    the members unstable at its start, so each member goes through the
    rounds of its own adjustment.  ``members`` [P] bool (or a 0-d bool for
    a planet) limits the rounds to those members (the running ones).

    CPU tensors take :func:`plain_adjustment`, any other the CUDA kernel
    (``kernels.adjust.conv_adjust``): one launch with ``rounds``, and
    without, one launch of one round per read of the host's loop, the last
    one's final correction the result."""
    if T_lay.is_cpu:
        return plain_adjustment(
            T_lay, p_lay, p_int, kappa_lay, kappa_int, c_p_lay,
            meanmolmass_lay, iter_value=iter_value, T_star=T_star,
            input_dampara=input_dampara, F_intern=F_intern,
            F_add_heat_sum=F_add_heat_sum, F_smooth_sum=F_smooth_sum,
            F_down_tot=F_down_tot, F_up_tot=F_up_tot, members=members,
            rounds=rounds)
    if members is None:
        members = torch.ones(T_lay.shape[1:], dtype=torch.bool,
                             device=T_lay.device)
    # a batch's model arrays that the members share are expanded views,
    # which the kernel reads as they are; the molar masses go in units of
    # AMU, the chain's own quotient (conv_correct), so that the weights
    # are the chain's to the bit
    args = [adjust.readable(x) for x in (
        p_lay, p_int, kappa_lay, kappa_int, c_p_lay,
        meanmolmass_lay / pc.AMU, F_add_heat_sum, F_smooth_sum, F_down_tot,
        F_up_tot)]

    def launch(T, k):
        return adjust.conv_adjust(
            T.contiguous(), *args, members.contiguous(), rounds=k,
            stitching=iter_value > 5000, T_star=T_star,
            input_dampara=input_dampara, F_intern=F_intern)

    if rounds is not None:
        out = launch(T_lay, rounds)
        return out.T_lay, out.conv_layer, out.needed, out.unstable
    with span("helios.adjust"):
        stats = running_stats()
        while True:
            out = launch(T_lay, 1)
            # a round ran: some member was unstable at the launch's start
            if not _adjust_read(out.needed, stats):
                return out.T_lay, out.conv_layer
            T_lay = out.T_round


def _adjust_read(flag, stats) -> bool:
    """One round's blocking read of ``flag``, counted and timed into the
    running loop's Stats."""
    with span("helios.adjust_read", stats, "adjust_read_s"):
        value = bool(flag)
    if stats is not None:
        stats.adjust_reads += 1
    return value


def plain_adjustment(T_lay, p_lay, p_int, kappa_lay, kappa_int, c_p_lay,
                     meanmolmass_lay, *, iter_value: int, T_star,
                     input_dampara, F_intern, F_add_heat_sum, F_smooth_sum,
                     F_down_tot, F_up_tot, members=None, rounds=None):
    """:func:`convective_adjustment` as a chain of PyTorch ops on any
    device: the CPU's route, and on the card the yardstick of the kernel,
    which computes it bit for bit in one launch."""
    def unstable_members(T):
        unstable = conv_check(T, p_lay, p_int, kappa_lay, kappa_int)
        active = unstable.any(dim=0)
        return unstable, active if members is None else active & members

    def correct(T_lay, unstable, active):
        conv_layer = mark_convective_layers(
            T_lay, p_lay, p_int, kappa_lay, kappa_int, stitching=0,
            iter_value=iter_value)
        T_new = conv_correct(T_lay, p_lay, p_int, kappa_lay, kappa_int,
                             c_p_lay, meanmolmass_lay, unstable | conv_layer)
        return torch.where(active, T_new, T_lay)

    with (span("helios.adjust") if rounds is None
          else contextlib.nullcontext()):
        unstable, active = unstable_members(T_lay)
        if rounds is None:
            stats = running_stats()
            while _adjust_read(active.any(), stats):
                T_lay = correct(T_lay, unstable, active)
                unstable, active = unstable_members(T_lay)
        else:
            needed = torch.zeros((), dtype=torch.int64, device=T_lay.device)
            for _ in range(rounds):
                needed = needed + active.any()
                T_lay = correct(T_lay, unstable, active)
                unstable, active = unstable_members(T_lay)

        conv_layer = mark_convective_layers(
            T_lay, p_lay, p_int, kappa_lay, kappa_int, stitching=1,
            iter_value=iter_value)
        unstable = conv_check(T_lay, p_lay, p_int, kappa_lay, kappa_int)
        corrected = unstable | conv_layer
        zones = find_zones(corrected)
        fudge = fudge_factors(zones, p_lay, p_int, T_star, input_dampara,
                              F_intern, F_add_heat_sum, F_smooth_sum,
                              F_down_tot, F_up_tot)
        T_lay = conv_correct(T_lay, p_lay, p_int, kappa_lay, kappa_int,
                             c_p_lay, meanmolmass_lay, corrected,
                             fudge_per_zone=fudge)
    if rounds is None:
        return T_lay, conv_layer
    return T_lay, conv_layer, needed, active.any()


def check_for_radiative_eq(T_lay, conv_layer, F_net, F_down_tot, *,
                           F_intern, F_add_heat_sum, F_smooth_sum,
                           rad_convergence_limit):
    """Per-layer radiative equilibrium on non-convective layers
    (host_functions.py:251-286).  Returns (criterion_met 0-d bool,
    converged [L+1], marked_red [L+1])."""
    L = T_lay.shape[0] - 1
    diff_lay = torch.abs(F_intern + F_add_heat_sum + F_smooth_sum
                         - F_net[1:L + 1])
    diff_surf = torch.abs(F_intern - F_net[0])
    local_diff = torch.cat([diff_lay, diff_surf[None]])
    denom = F_down_tot[L] + F_intern
    is_rad = ~conv_layer
    converged = is_rad & (local_diff < rad_convergence_limit * denom)
    marked_red = is_rad & ~converged
    criterion = converged.sum(dim=0) == is_rad.sum(dim=0)
    return criterion, converged, marked_red

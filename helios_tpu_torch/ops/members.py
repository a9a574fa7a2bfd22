"""The planet axis of a batch (:mod:`helios_tpu_torch.parallel.ensemble`):
where each array carries it, one member taken out, the mask that keeps a
stopped member's state, the move to and from the JAX package's [N, ...]
order, and elementwise functions rounded as each member's own run rounds
them.

A batch of P planets keeps the planet axis after the layer axis: per-layer
arrays [n, P], spectral arrays [n, P, S], so that a contiguous [L, P, S]
is the kernels' [L, P*S].  Boundary rows ([P, S]) and per-member flags
([P]) carry it first.  The loops' host counters and flags are numpy
arrays [P]; for one planet they are Python numbers.  Inside a loop they
are device tensors ([P], or 0-d for a planet;
:mod:`helios_tpu_torch.rce.graphs`).

PyTorch's CPU kernels evaluate a transcendental function (exp, log, pow)
with vector code over a tensor and finish its last elements with scalar
code, and the two can differ in the last bit; a member's n values sit at
other positions of the batch's [n, P] than of its own [n].  So on the CPU
such a function of a batch is evaluated member by member
(:func:`memberwise`), and every member rounds exactly as its run alone
does.  On the card every element takes the same code, and the batch is
one call.
"""

from __future__ import annotations

import numpy as np
import torch

from helios_tpu_torch.ops.slices import Slices

# ModelArrays fields: where each takes the planet axis (after the layer
# axis of per-layer arrays, after the (T, P) axes of the opacity tables
# and their grids, first in per-band rows); None: one tensor for the batch
MODEL_AXIS = dict(
    p_lay=1, p_int=1, delta_colmass=1, delta_col_upper=1, delta_col_lower=1,
    ktable=2, scat_cross_table=2, meanmolmass_table=2, ktemps=1, kpress=1,
    lambda_centers=0, lambda_edges=0, delta_lambda=0, gauss_y=None,
    gauss_weight=None, planck_grid=1, starflux=0, surf_albedo=0,
    cloud_abs_cross_lay=1, cloud_scat_cross_lay=1, g_0_cloud_lay=1,
    cloud_abs_cross_int=1, cloud_scat_cross_int=1, g_0_cloud_int=1,
    add_heat_dens=1, star_corr_factor=0)

# loop-state fields whose planet axis is the first (boundary rows and
# per-member flags); every other batched tensor has it second
ROW_FIELDS = frozenset(("scat_trigger", "boa_coeff", "boa_refl", "toa",
                        "keep_running", "goto_convection"))


def state_axis(name: str, x: torch.Tensor) -> int:
    """The planet axis of a batched loop-state tensor."""
    return 0 if name in ROW_FIELDS or x.dim() == 1 else 1


def _map_state(fn, state, *others):
    """``fn(name, leaf, *other_leaves)`` over a NamedTuple tree (the
    values of spectral :class:`Slices` one by one)."""
    def walk(name, x, *ys):
        if hasattr(x, "_fields"):
            return type(x)(*(walk(f, *v) for f, *v
                             in zip(x._fields, x, *ys)))
        if isinstance(x, Slices):
            return Slices(walk(name, *v) for v in zip(x, *ys))
        return fn(name, x, *ys)

    return type(state)(*(walk(f, *v) for f, *v
                         in zip(state._fields, state, *others)))


def member_state(state, i: int):
    """Member ``i`` of a batched loop state, shaped as a single planet's
    (tensors are views; the host counters and flags become numbers)."""
    def pick(name, x):
        if isinstance(x, np.ndarray):
            return x[i].item()
        return x.select(state_axis(name, x), i)

    return _map_state(pick, state)


def member_mask(name: str, x: torch.Tensor, run: torch.Tensor):
    """``run`` ([P] bool, or 0-d for one planet) shaped to broadcast along
    the planet axis of the loop-state tensor ``x`` of field ``name``."""
    if not run.dim():
        return run
    axis = state_axis(name, x)
    return run.reshape((1,) * axis + run.shape + (1,) * (x.dim() - axis - 1))


def member_groups(state, n: int):
    """A batch's state (or temperatures [L+1, P]) as ``n`` batches of
    consecutive members, views of it."""
    is_state = hasattr(state, "_fields")
    size = (state.T_lay if is_state else state).shape[1] // n

    def part(g):
        def pick(name, x):
            if isinstance(x, np.ndarray):
                return x[g * size:(g + 1) * size]
            return x.narrow(state_axis(name, x), g * size, size)
        return _map_state(pick, state) if is_state else pick(None, state)

    return [part(g) for g in range(n)]


def join_members(states, device):
    """The inverse of :func:`member_groups`: whole batches' states joined
    member by member on ``device``."""
    def cat(name, *xs):
        if isinstance(xs[0], np.ndarray):
            return np.concatenate(xs)
        return torch.cat([x.to(device) for x in xs],
                         dim=state_axis(name, xs[0]))

    return _map_state(cat, states[0], *states[1:])


def running_members(state) -> np.ndarray:
    """Whether the planet, or each member of a batch, still runs: the
    state's keep_running read to the host (a bool, or [P])."""
    keep = state.keep_running
    return np.asarray(keep.cpu() if hasattr(keep, "cpu") else keep, bool)


def loop_counter(state) -> int:
    """The counter of a loop state, also after its last member stopped: a
    stopped member's counter stays behind the running ones'."""
    return int(np.max(state.it))


def planet_first(a: np.ndarray, batched: bool) -> np.ndarray:
    """A batch's [n, N, ...] array in the JAX package's order, [N, n, ...]
    (vectors [N] stay as they are); anything of a single planet as it
    is."""
    return np.moveaxis(a, 1, 0) if batched and a.ndim >= 2 else a


def planet_second(a, batched: bool) -> np.ndarray:
    """The inverse of :func:`planet_first`: a batch's [N, n, ...] array as
    the port lays it out, [n, N, ...]."""
    a = np.asarray(a)
    return np.moveaxis(a, 0, 1) if batched and a.ndim >= 2 else a


def memberwise(fn, *args, batched: bool):
    """``fn(*args)`` for an elementwise ``fn``.  With ``batched``, the
    tensor arguments carry the planet axis last ([n, P] or [P]) and on the
    CPU ``fn`` runs once per member, each on a contiguous copy."""
    shaped = [a for a in args if isinstance(a, torch.Tensor) and a.dim() > 0]
    if not batched or not shaped or shaped[0].device.type != "cpu":
        return fn(*args)

    def take(a, p):
        if isinstance(a, torch.Tensor) and a.dim() > 0:
            return a[..., p].contiguous()
        return a

    P = max(a.shape[-1] for a in shaped)
    return torch.stack([fn(*(take(a, p) for a in args)) for p in range(P)],
                       dim=-1)

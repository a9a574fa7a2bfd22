"""The convective adjustment of a column in one launch: wrapper of the CUDA
kernel ``csrc/conv_adjust.cu``.

:func:`conv_adjust` launches the kernel for CUDA tensors and refuses CPU
ones: their route, and the kernel's plain version, is the chain of PyTorch
ops in :func:`helios_tpu_torch.rce.convect.plain_adjustment`, which
:func:`helios_tpu_torch.rce.convect.convective_adjustment` takes for them.
There is no fallback from one to the other.  ``conv_adjust.launches``
counts kernel launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from helios_tpu_torch.kernels import _launch

# the fudge factors' dampara (convect.fudge_factors): 0.5 below the top
# zone and 4 at it with a star, 8 without one, else the user's value
DAMP_AUTOMATIC_STAR, DAMP_AUTOMATIC_NO_STAR, DAMP_USER = 0, 1, 2


class Adjusted(NamedTuple):
    """What one launch returns: the temperatures after the rounds and
    after the final correction, the final marks, the most rounds a member
    ran (0-d int64) and whether a running member was still unstable after
    them (0-d bool)."""
    T_round: torch.Tensor
    T_lay: torch.Tensor
    conv_layer: torch.Tensor
    needed: torch.Tensor
    unstable: torch.Tensor


def conv_adjust(T_lay, p_lay, p_int, kappa_lay, kappa_int, c_p_lay,
                mmm_amu, F_add_heat_sum, F_smooth_sum, F_down_tot, F_up_tot,
                members, *, rounds: int, stitching: bool, T_star,
                input_dampara, F_intern) -> Adjusted:
    """Up to ``rounds`` correction rounds of each running, unstable member,
    then the final correction of every member, as
    :func:`helios_tpu_torch.rce.convect.plain_adjustment` computes them.

    ``mmm_amu``: the molar masses in units of AMU, ``meanmolmass_lay /
    constants.AMU`` taken with torch as the chain takes it (torch's
    quotient by a Python scalar is its own, so the kernel does not take
    it).  T_lay, p_int, kappa_int, F_down_tot, F_up_tot: [L+1] for a
    planet or [L+1, P] for a batch; p_lay, kappa_lay, c_p_lay, mmm_amu,
    F_add_heat_sum, F_smooth_sum: [L] or [L, P]; one dtype (float32 or
    float64), one CUDA device, contiguous; of a batch, the arrays but T may
    also be one column that every member shares, an expanded view [n, P]
    with strides (1, 0) (:func:`shared_column`), which the kernel reads as
    it is.  ``members``: bool, 0-d or [P], the running members.
    ``stitching``: the final marks stitch holes (past iteration 5000).  T_star, input_dampara ("automatic" or a
    number) and F_intern as in ``Phys``."""
    if T_lay.is_cpu:
        raise ValueError("conv_adjust takes CUDA tensors; on the CPU the "
                         "adjustment is rce.convect.plain_adjustment")
    if T_lay.dim() not in (1, 2) or T_lay.shape[0] < 2:
        raise ValueError(f"T_lay must be [L+1] or [L+1, P] with L >= 1, got "
                         f"shape {tuple(T_lay.shape)}")
    n, lead = T_lay.shape[0], tuple(T_lay.shape[1:])
    layers, faces = (n - 1,) + lead, (n,) + lead
    args = (T_lay, p_lay, p_int, kappa_lay, kappa_int, c_p_lay, mmm_amu,
            F_add_heat_sum, F_smooth_sum, F_down_tot, F_up_tot)
    want = [faces, layers, faces, layers, faces, layers, layers, layers,
            layers, faces, faces]
    shared, checked = 0, list(args)
    for k in range(1, len(args)):
        if shared_column(args[k], want[k]):
            shared |= 1 << (k - 1)
            checked[k], want[k] = args[k][:, 0], want[k][:1]
    _launch.check_tensors(checked, want)
    if (not isinstance(members, torch.Tensor) or members.dtype != torch.bool
            or tuple(members.shape) != lead
            or members.device != T_lay.device
            or not members.is_contiguous()):
        raise ValueError(f"members must be a contiguous bool tensor of shape "
                         f"{lead} on {T_lay.device}")
    rounds = _launch.check_count("rounds", rounds)
    P = _launch.check_count("P", math.prod(lead))
    if input_dampara == "automatic":
        mode = (DAMP_AUTOMATIC_STAR if T_star > 10.0
                else DAMP_AUTOMATIC_NO_STAR)
        dampara = 0.0
    else:
        mode, dampara = DAMP_USER, float(input_dampara)
    out = Adjusted(torch.empty_like(T_lay), torch.empty_like(T_lay),
                   torch.empty_like(T_lay, dtype=torch.bool),
                   torch.empty((), dtype=torch.int64, device=T_lay.device),
                   torch.empty((), dtype=torch.bool, device=T_lay.device))
    _launch.launch("conv_adjust", args + (members,) + tuple(out),
                   (n - 1, P, rounds, int(bool(stitching)), mode, shared),
                   (float(F_intern), dampara))
    conv_adjust.launches += 1
    return out


conv_adjust.launches = 0


def shared_column(x, shape) -> bool:
    """Whether ``x`` is one column that the members of a batch share: an
    expanded view of ``shape`` [n, P] with strides (1, 0)."""
    return (isinstance(x, torch.Tensor) and len(shape) == 2
            and tuple(x.shape) == tuple(shape) and x.stride() == (1, 0))


def readable(x):
    """``x`` if the kernel reads it as it is (contiguous, or a column the
    members share), else a contiguous copy."""
    if x.is_contiguous() or (x.dim() == 2 and x.stride() == (1, 0)):
        return x
    return x.contiguous()

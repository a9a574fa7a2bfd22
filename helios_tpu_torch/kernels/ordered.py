"""Sums and cumulative sums in a fixed order: wrappers of the CUDA kernel
``csrc/ordered_sum.cu`` and their plain PyTorch versions.

:func:`ordered_sum` and :func:`ordered_cumsum` launch the kernel for CUDA
tensors, which adds the elements along ``dim`` in index order whatever the
tensor's shape and alignment, so that a planet's sums in a batch are bit
for bit its sums alone.  For CPU tensors they run their plain versions,
``torch.sum`` and ``torch.cumsum``, whose CPU order already depends on
nothing but the row; there is no fallback from one to the other.
``ordered_sum.launches`` counts the kernel's launches, of both.
:func:`in_order_reference` is the kernel's arithmetic as a loop of
elementwise adds, for the comparison on the card.
"""

from __future__ import annotations

import math

import torch

from helios_tpu_torch.kernels import _launch


def _launch_ordered(x, dim: int, scan: bool):
    """[O, K, I] view of ``x`` around ``dim``; the kernel's output.  A
    non-contiguous ``x`` (a restored state's transposed view) is copied to
    its logical layout first, which keeps the order of every sum."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.numel() == 0:
        raise ValueError("ordered sums take a non-empty tensor of at least "
                         "one dimension")
    x = x.contiguous()
    _launch.check_tensors((x,), [tuple(x.shape)])
    dim = dim % x.dim()
    O = math.prod(x.shape[:dim])
    K = x.shape[dim]
    I = math.prod(x.shape[dim + 1:])
    for name, n in (("rows", O * I), ("K", K), ("O*K*I", O * K * I)):
        _launch.check_count(name, n)
    shape = x.shape if scan else x.shape[:dim] + x.shape[dim + 1:]
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _launch.launch("ordered_sum", (x, out), (O, K, I, int(scan)))
    ordered_sum.launches += 1
    return out


def ordered_sum(x, dim: int):
    """``x`` summed over ``dim`` (torch.sum's result shape), in index
    order on the card.  ``x``: float32/float64."""
    if x.device.type == "cpu":
        return torch.sum(x, dim=dim)
    return _launch_ordered(x, dim, scan=False)


ordered_sum.launches = 0


def ordered_cumsum(x, dim: int):
    """The cumulative sum of ``x`` along ``dim`` (torch.cumsum's), in
    index order on the card.  ``x``: float32/float64."""
    if x.device.type == "cpu":
        return torch.cumsum(x, dim=dim)
    return _launch_ordered(x, dim, scan=True)


def in_order_reference(x, dim: int, scan: bool):
    """The kernel's arithmetic in plain PyTorch: a running sum along
    ``dim`` as one elementwise add per index, from zero."""
    dim = dim % x.dim()
    acc = torch.zeros_like(x.select(dim, 0))
    steps = []
    for k in range(x.shape[dim]):
        acc = acc + x.select(dim, k)
        steps.append(acc)
    return torch.stack(steps, dim=dim) if scan else acc

"""Device and dtype policy.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
the port never falls back to the CPU on its own.  ``precision="double"``
runs in float64 (the H100 computes fp64 in hardware), ``"single"`` in
float32; :meth:`HeliosConfig.finalize` resolves the choice into
``cfg.dtype``.
"""

from __future__ import annotations

import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and CUDA is
    not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """The tensor dtype for a config dtype name ("float64" | "float32")."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None

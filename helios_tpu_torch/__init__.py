"""HELIOS in PyTorch and CUDA: the radiative-convective-equilibrium solver
of :mod:`helios_tpu`, ported to an NVIDIA H100.

The package covers the default run (``run_type="iterative"``: non-isothermal
layers, scattering, convection, premixed opacities, the iterative flux
method, fp64).  Plain tensor code is PyTorch; the one kernel on that path,
the non-isothermal two-stream sweep, is hand-written CUDA C++ for Hopper
(``csrc/noniso_sweep.cu``), built with ``nvcc`` at first use.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``
and raises when CUDA is absent; only an explicit ``device="cpu"`` runs on
the CPU (the kernels' plain PyTorch versions then run in their place).

The package imports neither JAX nor :mod:`helios_tpu`: the host modules it
shares with the JAX package (``config``, ``constants``, ``planets``,
``grid``, ``io/opacity``) are copies.
"""

__version__ = "0.1.0"

from helios_tpu_torch import constants  # noqa: E402,F401
from helios_tpu_torch.config import HeliosConfig  # noqa: E402,F401

"""HELIOS in PyTorch and CUDA: the radiative-convective-equilibrium solver
of :mod:`helios_tpu`, ported to an NVIDIA H100.

The package runs what a single-device run of :mod:`helios_tpu` runs,
from ``python -m helios_tpu_torch -parameter_file param.dat`` (quickstart
inputs: ``python -m helios_tpu_torch.examples``) or
:func:`helios_tpu_torch.pipeline.run`: iterative and post-processing runs,
isothermal or non-isothermal layers, premixed or on-the-fly opacities, the
iterative or the matrix flux method, clouds, surfaces, real-gas
thermodynamics, stellar spectra from files, the monitored runner,
checkpoints and coupling, and planet ensembles (``-planet_ensemble_file``,
:func:`helios_tpu_torch.parallel.ensemble.run_ensemble`: N planets as one
batch, each kernel launch shared by all).  Meshes are not ported.
Plain tensor code is PyTorch; the four kernels (``csrc/``: the
non-isothermal and isothermal sweeps, the Thomas solve and the Random
Overlap mix) are hand-written CUDA C++ for Hopper, built with ``nvcc`` at
first use.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``
and raises when CUDA is absent; only an explicit ``device="cpu"`` runs on
the CPU (the kernels' plain PyTorch versions then run in their place).

The package imports neither JAX nor :mod:`helios_tpu`: the host modules it
shares with the JAX package (``config``, ``constants``, ``planets``,
``grid``, ``io/opacity``, ``thermo``, ``plotting``, ``examples`` and
others) are copies.
"""

__version__ = "0.1.0"

from helios_tpu_torch import constants  # noqa: E402,F401
from helios_tpu_torch.config import HeliosConfig  # noqa: E402,F401

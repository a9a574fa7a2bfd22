"""The benchmark of helios_tpu_torch on an NVIDIA H100 (see README.md)."""

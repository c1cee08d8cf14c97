"""The benchmark of tpuseg_torch on one NVIDIA H100 (see README.md)."""

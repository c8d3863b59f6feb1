"""Build, load and launch the CUDA kernels of ``csrc/``."""

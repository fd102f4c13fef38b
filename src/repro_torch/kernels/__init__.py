"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the numpy oracles. Nothing is compiled at import: ``build.library`` builds
a kernel's source at its first launch."""

"""Hand-written Hopper kernels (CUDA C++ for sm_90a) with plain PyTorch
versions beside them; see ``build.py`` for how they are compiled."""

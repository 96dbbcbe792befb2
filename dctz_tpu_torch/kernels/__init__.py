"""Build and load the hand-written CUDA kernels (see build.py)."""

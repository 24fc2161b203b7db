"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

Sources live in ``csrc/``; ``build`` compiles them with nvcc for sm_90a at
first use.  Importing this package builds nothing.
"""

"""Hand-written Hopper kernels of the port, their wrappers and oracles.

``csrc/`` holds the CUDA sources, ``build`` compiles and loads them,
``circconv`` wraps the HRR kernels (with their plain versions and launch
counts), ``ops`` adds the autograd Functions, ``ref`` the plain oracles.
"""

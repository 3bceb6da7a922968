"""repro_torch: the C3-SL split-learning system in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``repro`` (which stays the reference), module for
module at the same paths: ``repro/core/hrr.py`` becomes
``repro_torch/core/hrr.py`` and so on.  The port imports ``torch``, never
``jax`` and nothing of ``repro``.  Parameters are nested dicts and lists of
tensors with the reference's key paths and layouts (NCHW/OIHW convs, dense
weights ``(d_in, d_out)`` applied as ``x @ w``), so reference weights carry
across one to one through ``repro_torch.interop``.

The TPU's Pallas kernels on this package's path are hand-written CUDA
kernels for ``sm_90a`` (``repro_torch.kernels``), built on first use.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.
"""

"""The active mesh (the port's ``jax.set_mesh``): the one decision the
model's constraints, ``sharding.constraints`` and the launchers share.
Torch-free; ``launch.mesh`` re-exports :func:`set_mesh` and
:func:`active_mesh` beside its factories."""
from __future__ import annotations

import contextlib

_ACTIVE: list = []


def active_mesh():
    """The mesh of the innermost :func:`set_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def set_mesh(mesh):
    """Context manager activating ``mesh`` (as ``jax.set_mesh``): the
    constraints inside the model place over it."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()

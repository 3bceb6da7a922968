"""Mesh factories and the active mesh (port of ``repro/launch/mesh.py``).

Never touches device or process-group state at import time: everything
is a function.  The reference's production meshes, single pod (data 16,
model 16) = 256 chips and multi-pod (pod 2, data 16, model 16) = 512,
exist here only as shapes (:class:`MeshShape`): the rules and the dry run
read a mesh's ``.shape`` and ``.axis_names`` and nothing else, and no one
launches 256 ranks.  :func:`make_host_mesh` builds a real
``torch.distributed`` ``DeviceMesh`` over the ranks of the current process
group: ``"cpu"`` over gloo (the tests' 4-rank runs), ``"cuda"`` over NCCL
on the card.  :func:`set_mesh` makes a mesh the active one, as
``jax.set_mesh`` does; ``sharding.constraints.constrain`` and the stack's
activation constraint read it through :func:`active_mesh`.  Both live in
``sharding.active`` (the model depends on ``sharding`` only) and are
re-exported here.

The H100's peak rates, which the reference keeps here for a TPU v5e, stay
in ``launch/dryrun.py``.
"""
from __future__ import annotations

import math

from repro_torch.sharding.active import active_mesh, set_mesh  # noqa: F401


class MeshShape:
    """A device-free mesh: axis names and sizes, no devices.  Carries
    ``.shape`` (a dict of axis sizes, in order), ``.axis_names`` and
    ``.size``, which is all the rules and the dry run read."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _axes(data: int, model: int, pod: int | None):
    if pod:
        return (pod, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes as shapes: (data 16, model 16),
    or (pod 2, data 16, model 16) with ``multi_pod``."""
    return mesh_shape(16, 16, 2 if multi_pod else None)


def mesh_shape(data: int = 1, model: int = 1, pod: int | None = None) -> MeshShape:
    """A device-free mesh of any shape (the dry run over (data 4, model 1),
    (2, 2) or (1, 4), say)."""
    return MeshShape(*_axes(data, model, pod))


class HostMesh:
    """A ``DeviceMesh`` with the reference mesh's reading surface:
    ``.shape`` (a dict of axis sizes) and ``.axis_names`` beside the
    ``DeviceMesh`` itself (``.device_mesh``), which DTensor takes."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))


def make_host_mesh(data: int = 1, model: int = 1, pod: int | None = None, *,
                   device_type: str) -> HostMesh:
    """A mesh over the ranks of the current process group (its world size
    must equal the mesh's size): ``init_device_mesh`` on ``device_type``,
    "cpu" (gloo) or "cuda" (NCCL), which the caller must name (DTensor
    moves every tensor placed on the mesh to its device type).  The
    caller starts the process group (``torch.distributed.init_process_group``
    with its address, world size and rank) and destroys it."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = _axes(data, model, pod)
    forget_mesh_caches()
    return HostMesh(init_device_mesh(device_type, shape, mesh_dim_names=names))


def forget_mesh_caches():
    """Drop DTensor's caches of sharding decisions.  They are keyed by
    ``DeviceMesh`` equality (shape, axis names, device type), which a new
    mesh of the same shape over a new process group shares with an old
    one, so a decision cached on the old mesh would run its collectives
    on the old, destroyed groups.  Called for each new mesh."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    # each cache where this torch has it (the native one is newer)
    for clear in (getattr(DTensor._op_dispatcher.sharding_propagator
                          .propagate_op_sharding, "cache_clear", None),
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None),
                  getattr(getattr(_redistribute, "_gen_transform_infos", None),
                          "cache_clear", None)):
        if clear is not None:
            clear()

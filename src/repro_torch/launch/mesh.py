"""Production and debug meshes as ``DeviceMesh`` es.

Defined as FUNCTIONS (never module-level constants) so importing this
module sets up no process group.  The production target is 16×16 = 256
chips per pod ("data", "model"); the multi-pod mesh adds a leading "pod"
axis (2×16×16 = 512 chips).  One process builds either over torch's
*fake* backend (``torch.testing._internal.distributed.fake_pg``): a
process group of 512 ranks whose collectives do nothing, so rules,
placements and local shapes can be checked without the chips.  The
debug mesh is 1×1 over a one-rank group on the local device: ``gloo``
for the CPU, ``nccl`` for the card.

A mesh function sets up the default process group only when none is set
up; :func:`destroy_mesh_group` destroys it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

#: ranks of the fake group: enough for either production mesh
FAKE_WORLD = 512


def _fake_store():
    """The fake backend's store; importing its module registers the
    ``fake`` backend.  It is a private module of torch: where it is
    missing the dry-run cannot run, so this raises instead of building
    a mesh some other way."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as exc:
        raise RuntimeError(
            "torch.testing._internal.distributed.fake_pg is missing from "
            f"torch {torch.__version__}: the production meshes need its "
            "fake process group"
        ) from exc
    return FakeStore()


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the first ranks of a fake group of
    FAKE_WORLD ranks (set up here when no group is)."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


def make_fake_mesh(shape, axes=("data", "model")):
    """A ``shape`` mesh named ``axes`` over the first ranks of a fake
    group of FAKE_WORLD ranks (set up here when no group is): the
    production meshes, and small ones (1×1, 2×4) whose collectives can
    be worked out by hand."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(shape), tuple(axes)
    store = None if dist.is_initialized() else _fake_store()
    if store is not None:
        dist.init_process_group("fake", store=store, rank=0,
                                world_size=FAKE_WORLD)
    if dist.get_world_size() < math.prod(shape):
        raise RuntimeError(
            f"a {shape} mesh needs {math.prod(shape)} ranks; the process "
            f"group set up has {dist.get_world_size()}"
        )
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def make_debug_mesh(device="cpu"):
    """A 1×1 ("data", "model") mesh on ``device`` ("cpu" or "cuda"), over
    a one-rank group on a ``HashStore`` (``gloo`` on the CPU, ``nccl`` on
    the card), set up here when no group is — smoke tests and one-card
    runs."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if dev.type == "cuda":  # the card the one-rank NCCL group binds
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(
            "make_debug_mesh needs a one-rank group; the group set up has "
            f"{dist.get_world_size()} ranks"
        )
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


def destroy_mesh_group() -> None:
    """Destroy the default process group (a no-op where none is set up),
    so that another mesh function can set up its own."""
    if dist.is_initialized():
        dist.destroy_process_group()

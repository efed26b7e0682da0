"""Meshes of the port, with the JAX package's axis names.

  * ``make_production_mesh``: ``(16, 16)`` over ``("data", "model")``
    or, multi-pod, ``(2, 16, 16)`` over ``("pod", "data", "model")``, on
    the cards of a launched process group (``torchrun`` with 256 or 512
    ranks, one card a rank). Any other world size raises, naming the
    size it needs: no smaller mesh is built.
  * ``make_local_mesh``: ``(1, 1)`` with the production names, over a
    one-rank group it starts when none runs (NCCL on the card, gloo on
    the CPU).
  * ``fake_mesh``: a mesh of any shape in one process, over PyTorch's
    fake process group (its collectives move nothing), for the dry-run's
    sizing on the meta device. A fake group is torn down before another
    is made; a real group is never replaced.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
LOCAL_NAMES = ("data", "model")

_FAKE = {"on": False}


def make_production_mesh(*, multi_pod: bool = False):
    shape, names = PRODUCTION[multi_pod]
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need or _FAKE["on"]:
        raise RuntimeError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh "
            f"{shape} needs a launch of {need} ranks, one card each "
            f"(torchrun); this process has a world of "
            f"{0 if _FAKE['on'] else world}")
    return init_device_mesh("cuda", shape, mesh_dim_names=names)


def make_local_mesh(device="cuda"):
    """The ``(1, 1)`` mesh on ``device``, over a one-rank group (started
    here if none runs: NCCL on a card, gloo on the CPU)."""
    dev = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"the local mesh is one rank; this group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=LOCAL_NAMES)


def fake_mesh(shape, names):
    """A CPU mesh of ``shape`` over the fake process group, for sizing
    on the meta device. The group registers itself from PyTorch's test
    utilities (``torch.testing._internal.distributed.fake_pg``): the one
    private module the port imports, only here."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if not _FAKE["on"]:
            raise RuntimeError("fake_mesh: a real process group runs")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    _FAKE["on"] = True
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def teardown_fake() -> None:
    """Destroy the fake group, if one runs."""
    if _FAKE["on"] and dist.is_initialized():
        dist.destroy_process_group()
    _FAKE["on"] = False

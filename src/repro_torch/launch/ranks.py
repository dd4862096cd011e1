"""The launchers' ranks: the process group from the ``torchrun``
environment, each rank's device and the mesh plan.

``torchrun --nproc-per-node N -m repro_torch.launch.{train,serve} --mesh
D,M`` starts N = D*M ranks; without ``torchrun`` a launcher is one rank
with no process group.  ``--backend`` defaults to nccl on the card and gloo
on the CPU.  NCCL will not put two ranks of one communicator on one GPU,
so nccl with more ranks than cards is refused; gloo takes CUDA tensors by
staging them through the host, and can share one card between ranks.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.device import resolve_device

NCCL_ONE_CARD = ("NCCL will not put two ranks of one communicator on one GPU: "
                 "{world} ranks over {cards} card(s); use --backend gloo (it stages "
                 "CUDA tensors through the host)")


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--mesh", default=None,
                    help="D,M: data x model ranks (world D*M, EP = gcd(E, M)); default "
                         "1,WORLD_SIZE")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend; default nccl on the card, gloo "
                         "on the CPU")


def world_size() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    return int(os.environ.get("RANK", "0"))


def mesh_of(args: argparse.Namespace, world: int) -> Tuple[int, int]:
    """The run's (data, model) grid: ``--mesh``, else (1, world); refuses a
    grid that is not the world, and a pod axis."""
    if args.mesh is None:
        return 1, world
    shape = tuple(int(n) for n in args.mesh.split(","))
    if len(shape) != 2:
        raise SystemExit(f"--mesh {args.mesh}: need D,M (the pod axis and --pipeline "
                         f"wait for the pipeline executor, ROADMAP.md Queue 1 item 3)")
    if shape[0] * shape[1] != world:
        raise SystemExit(f"--mesh {args.mesh} needs {shape[0] * shape[1]} ranks, the "
                         f"launch has {world} (torchrun --nproc-per-node)")
    return shape


def check(args: argparse.Namespace, arch, world: int, cards: int) -> str:
    """Refuse TP > 1 and nccl with more ranks than cards, before any
    process group exists.  Returns the backend."""
    data, model = mesh_of(args, world)
    ep = sharding.choose_ep(arch.moe.num_experts if arch.moe else model, model)
    if model // ep != 1:
        raise SystemExit(f"--mesh {data},{model}: ep = {ep}, tp = {model // ep}; "
                         f"{sharding.TP_TODO}")
    backend = args.backend or ("nccl" if resolve_device(args.device).type == "cuda"
                               else "gloo")
    if backend == "nccl" and world > max(cards, 1):
        raise SystemExit(NCCL_ONE_CARD.format(world=world, cards=cards))
    return backend


def init(args: argparse.Namespace, arch, a2a_algo: str = "flat", a2a_chunks: int = 1):
    """Check the launch, join the ``torchrun`` process group (when there is
    one and none is joined yet), and return (this rank's device, the mesh
    plan).  A rank's card is ``cuda:{LOCAL_RANK % device_count}``."""
    world = world_size()
    cards = torch.cuda.device_count()
    backend = check(args, arch, world, cards)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % cards)
        torch.cuda.set_device(device)
    if "RANK" in os.environ and not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    plan = sharding.make_plan(arch, mesh_of(args, world),
                              hierarchical_a2a=a2a_algo == "halo", a2a_chunks=a2a_chunks)
    return device, plan


def shutdown() -> None:
    """Leave the process group a launcher's ``__main__`` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()

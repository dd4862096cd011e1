"""The launchers' ranks: the process group from the ``torchrun``
environment, each rank's device and the mesh plan.

``torchrun --nproc-per-node N -m repro_torch.launch.{train,serve} --mesh
D,M`` starts N = D*M ranks (``--mesh P,D,M``: N = P*D*M, the pod axis a
pipeline with the train launcher's ``--pipeline``, else joined to data),
the model axis M split into ep = gcd(E, M) expert ranks times tp = M / ep
lanes; without ``torchrun`` a launcher is one rank with no process group.
``--backend`` defaults to nccl on the card and gloo on the CPU.  NCCL will
not put two ranks of one communicator on one GPU, so nccl with more ranks
than cards is refused; gloo takes CUDA tensors by staging them through the
host, and can share one card between ranks.
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
                    help="D,M or P,D,M: [pod x] data x model ranks (world P*D*M, EP = "
                         "gcd(E, M), TP = M / EP); default 1,WORLD_SIZE")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend; default nccl on the card, gloo "
                         "on the CPU")


def world_size() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    return int(os.environ.get("RANK", "0"))


def mesh_of(args: argparse.Namespace, world: int) -> Tuple[int, ...]:
    """The run's (data, model) or (pod, data, model) grid: ``--mesh``, else
    (1, world); refuses a grid that is not the world."""
    if args.mesh is None:
        return 1, world
    shape = tuple(int(n) for n in args.mesh.split(","))
    if len(shape) not in (2, 3):
        raise SystemExit(f"--mesh {args.mesh}: need D,M or P,D,M")
    n = 1
    for k in shape:
        n *= k
    if n != world:
        raise SystemExit(f"--mesh {args.mesh} needs {n} ranks, the launch has {world} "
                         f"(torchrun --nproc-per-node)")
    return shape


def check(args: argparse.Namespace, world: int, cards: int) -> str:
    """Refuse ``--pipeline`` without a pod axis of at least 2, and nccl with
    more ranks than cards, before any process group exists.  Any tp =
    M / gcd(E, M) is taken.  Returns the backend."""
    shape = mesh_of(args, world)
    if getattr(args, "pipeline", False) and (len(shape) != 3 or shape[0] < 2):
        raise SystemExit(f"--pipeline needs a pod axis of at least 2 stages (--mesh "
                         f"P,D,M with P >= 2), got --mesh {args.mesh}")
    backend = args.backend or ("nccl" if resolve_device(args.device).type == "cuda"
                               else "gloo")
    if backend == "nccl" and world > max(cards, 1):
        raise SystemExit(NCCL_ONE_CARD.format(world=world, cards=cards))
    return backend


def init(args: argparse.Namespace, arch, a2a_algo: str = "flat", a2a_chunks: int = 1,
         **pipeline):
    """Check the launch, join the ``torchrun`` process group (when there is
    one and none is joined yet), and return (this rank's device, the mesh
    plan).  A rank's card is ``cuda:{LOCAL_RANK % device_count}``.
    ``pipeline``: ``sharding.make_plan``'s schedule, vstages and
    compress_p2p, bound with ``args.pipeline``, and its memory policy
    (remat, optimizer_dtype)."""
    world = world_size()
    cards = torch.cuda.device_count()
    backend = check(args, world, cards)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % cards)
        torch.cuda.set_device(device)
    if "RANK" in os.environ and not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    plan = sharding.make_plan(arch, mesh_of(args, world),
                              pipeline_on_pod=getattr(args, "pipeline", False),
                              hierarchical_a2a=a2a_algo == "halo", a2a_chunks=a2a_chunks,
                              **pipeline)
    return device, plan


def shutdown() -> None:
    """Leave the process group a launcher's ``__main__`` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()

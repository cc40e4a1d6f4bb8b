"""The island mesh over `torch.distributed` (counterpart of
`greyjack_tpu/parallel/mesh.py`).

The JAX package lays the islands over a 1-D device mesh whose `islands`
axis carries island shards. The PyTorch idiom is one process per device:
an initialised process group of W ranks is the mesh, rank r holds the
global islands [r·n_local, (r+1)·n_local), and migration and the global
best ride collectives on that group (`parallel/islands.py`).

An optional `facts` axis makes the grid (islands, facts) of the
partitioned-facts scoring (`ops/partitioned.py`): rank i·F + f is island
row i, facts column f. Ranks of one island row share a `facts` group (they
hold the row shards of one distance matrix); ranks of one facts column
form the island group the runner uses.

The backend is NCCL for a mesh on CUDA devices and gloo on the CPU. There
is no fallback between them: NCCL refuses two ranks on one GPU, so a
world of W ranks on CUDA needs W cards.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass
class IslandMesh:
    """A rank's view of the mesh: the island process group (`None` is the
    default group), its size and this rank's index in it, the device this
    rank's islands live on, and the optional facts subgroup with its size
    and this rank's index in it."""

    group: object
    size: int
    index: int
    device: torch.device
    facts_group: object = None
    facts_size: int = 1
    facts_index: int = 0

    @property
    def is_lead(self):
        """True on the rank that logs, observes and writes checkpoints."""
        return self.index == 0 and self.facts_index == 0

    def broadcast(self, obj):
        """The island group's first rank's `obj` (a picklable host value),
        on every rank of the group."""
        box = [obj]
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]


def _local_cuda_device(rank):
    """`cuda:<local rank>`: torchrun's LOCAL_RANK, else the rank modulo the
    cards on this host."""
    return torch.device("cuda", int(os.environ.get(
        "LOCAL_RANK", rank % torch.cuda.device_count())))


def make_island_mesh(group=None, facts=1):
    """The mesh over an initialised default group (or `group`): with
    `facts` = F, its W ranks form a (W / F, F) grid, rank i·F + f in island
    row i and facts column f, each island row's ranks a facts subgroup
    (with F = 1, each rank alone). The mesh's device is `cuda:<local
    rank>` on an NCCL group and the CPU on a gloo group."""
    if not dist.is_initialized():
        raise RuntimeError("make_island_mesh needs an initialised process "
                           "group (init_distributed or "
                           "torch.distributed.init_process_group)")
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    me = ranks.index(dist.get_rank())
    facts = int(facts)
    if facts < 1 or len(ranks) % facts:
        raise ValueError(f"facts={facts} must divide the {len(ranks)} ranks "
                         "of the group")
    device = (_local_cuda_device(dist.get_rank())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    rows = len(ranks) // facts
    island_group, facts_group = group, None
    # every rank creates every subgroup, in the same order
    if facts > 1:
        for f in range(facts):
            g = dist.new_group([ranks[i * facts + f] for i in range(rows)])
            if f == me % facts:
                island_group = g
    for i in range(rows):
        g = dist.new_group(ranks[i * facts:(i + 1) * facts])
        if i == me // facts:
            facts_group = g
    return IslandMesh(island_group, rows, me // facts, device,
                      facts_group, facts, me % facts)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device="cuda"):
    """Initialise the default process group and return its mesh.

    `coordinator_address` is an init URL (`tcp://host:port`, `file://path`)
    or a bare `host:port`; without it the group reads `torchrun`'s
    environment (MASTER_ADDR, WORLD_SIZE, RANK). The mesh's device is
    `cuda:<local rank>` (NCCL) unless `device` names the CPU (gloo)."""
    dev_type = torch.device(device).type
    backend = "nccl" if dev_type == "cuda" else "gloo"
    kwargs = {"backend": backend}
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kwargs.update(init_method=url, world_size=int(num_processes),
                      rank=int(process_id))
    if backend == "nccl":
        card = _local_cuda_device(int(process_id if process_id is not None
                                      else os.environ.get("RANK", 0)))
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(**kwargs)
    return make_island_mesh()

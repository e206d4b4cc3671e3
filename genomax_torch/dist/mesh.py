"""The device mesh of the port: ``torch.distributed`` with one process per
device, NCCL between cards and gloo between CPU processes (the counterpart
of ``genomax.dist.mesh``).

``initialize_distributed`` starts the process group; ``make_mesh`` returns
this process's place in it, its rank, the group's size and its one device.
There is no fallback from one device kind to another: a mesh of n devices
needs a group of n processes, and a mesh's device is the one asked for.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

# The collective backend of each device kind.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str = "nccl",
                           init_method: str | None = None,
                           timeout_s: float | None = None) -> None:
    """Start the process group of ``num_processes`` ranks, this process
    being rank ``process_id``, over ``coordinator`` (``host:port``, a TCP
    store) or ``init_method`` (a ``file://`` or ``env://`` URL). A no-op
    with one process and neither: single-process callers can always call
    it. Under ``torchrun`` (WORLD_SIZE above 1 in the environment) it
    takes the rendezvous from the environment. ``backend`` is "nccl" for
    cuda devices and "gloo" for the CPU."""
    if backend not in BACKENDS.values():
        raise ValueError(f"backend {backend!r}: want one of "
                         f"{sorted(BACKENDS.values())}")
    if init_method is None:
        if coordinator is not None:
            init_method = f"tcp://{coordinator}"
        elif num_processes is None and int(
                os.environ.get("WORLD_SIZE", "1")) > 1:
            init_method = "env://"
        elif num_processes in (None, 1):
            return
        else:
            raise ValueError(f"num_processes={num_processes} needs a "
                             "coordinator or an init_method")
    kw = {}
    if init_method != "env://":
        kw = dict(world_size=1 if num_processes is None else num_processes,
                  rank=0 if process_id is None else process_id)
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, **kw)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in a one-dimensional data mesh: ``group`` (None
    when no process group is up: a mesh of one), ``rank``, ``size`` and the
    rank's device."""

    group: object | None
    rank: int
    size: int
    device: torch.device

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (equal shapes on every rank), in rank
        order."""
        if self.group is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def global_rank(self, r: int) -> int:
        """The process group's rank of this mesh's rank r (the same unless
        the mesh is a sub-group): point-to-point calls name global
        ranks."""
        if self.group is None or self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks, in place."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t


def make_mesh(n_devices: int | None = None, *, device="cuda",
              group=None) -> Mesh:
    """This process's mesh: the process group's rank and size (rank 0 of 1
    when none is up) and one device of the kind ``device`` names,
    ``cuda:LOCAL_RANK`` (LOCAL_RANK from the environment, default 0) or the
    CPU. ``group``, a ``torch.distributed.new_group`` this process belongs
    to, makes the mesh that group's instead of the whole process group's,
    rank and size taken within it. ``n_devices``, when given, must equal
    the group's size: there is no fallback to other devices. The group's
    backend must be the one of the device kind (NCCL for cuda, gloo for the
    CPU)."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"device {device}: want cuda or cpu")
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        if rank < 0:
            raise ValueError("this process is not a rank of the group")
        backend = dist.get_backend(group)
        if backend != BACKENDS[kind]:
            raise ValueError(f"a {kind} mesh needs the {BACKENDS[kind]} "
                             f"backend; the process group runs {backend}")
    elif group is not None:
        raise ValueError("a sub-group mesh needs a process group; call "
                         "initialize_distributed first")
    else:
        rank, size = 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"need {n_devices} devices, the process group has {size} ranks "
            "(one device a process; start one process a device, e.g. with "
            "torchrun, and call initialize_distributed)")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: torch finds no CUDA device on "
                               "this host")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return Mesh(group=group, rank=rank, size=size, device=dev)

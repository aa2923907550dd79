"""Runs over several processes: ``torch.distributed`` start-up, the column
layout of one process, host-local reads, and the gathers of the single
writer (counterpart of ``mckpp_tpu/parallel/distributed.py``).

Columns never exchange state, so the design is:

* one process per card, each holding one contiguous slab of the padded
  column axis (``ColumnLayout``); the kernels iterate per warp and need
  no reduction across columns, so the step never communicates;
* each process reads only its own rows of the forcing and ancillary
  files (``io/ancillaries.py``), so nothing crosses processes on the
  read path;
* the single writer (``write_mode="single"``, XIOS one_file) gathers an
  emitted window and a restart to rank 0; with ``write_mode="shard"``
  every process writes its own rows and nothing is gathered (XIOS
  multiple_file; merge offline with ``mckpp_torch.tools.merge_shards``).

Every transfer is a host gather, so the process group is ``gloo`` on CPU
tensors; gloo also lets two processes share one card, which NCCL
refuses.  Collectives are issued from the loop thread only, in the same
order on every rank: a collective from a writer thread, or inside a CUDA
graph capture, would deadlock or break the capture.  One process with no
rendezvous variables is the plain single-process run.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from ..utils.logging import mckpp_print
from .sharding import map_leaves, mark_inactive, pad_rows

ROUTINE = "MCKPP_TORCH_DISTRIBUTED"
TIMEOUT = datetime.timedelta(minutes=30)
_device: Optional[torch.device] = None      # chosen by initialize()


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def _env_int(*names) -> Optional[int]:
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               device: str = "cuda") -> torch.device:
    """Join the process group and pick this process's device; returns it.

    The rendezvous comes from the arguments, else the JAX package's
    variables (``KPP_COORDINATOR`` host:port, ``KPP_NUM_PROCS``,
    ``KPP_PROC_ID``), else torchrun's (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  Without any, the run is
    single-process and no group is made.  On ``device="cuda"`` local
    rank r takes ``cuda:(r % device_count)``; on the CPU each rank takes
    an equal share of the intra-op threads.  Ends with a barrier
    (:func:`warmup_collectives`)."""
    global _device
    coordinator_address = coordinator_address or os.environ.get(
        "KPP_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = _env_int("KPP_NUM_PROCS", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("KPP_PROC_ID", "RANK")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    if num_processes is not None and not tdist.is_initialized():
        if coordinator_address is None or process_id is None:
            raise ValueError(
                f"{num_processes} processes and no coordinator address or "
                "process id: set KPP_COORDINATOR (host:port) and "
                "KPP_PROC_ID, or MASTER_ADDR, MASTER_PORT and RANK")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process id {process_id} outside "
                             f"[0, {num_processes})")
        tdist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    rank, world = process_index(), process_count()
    local_rank = rank if local_rank is None else local_rank
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda (the default) and no CUDA "
                               "device is available; pass --device cpu")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
        if world > 1:
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
    mckpp_print(ROUTINE, f"rank {rank} of {world} (local rank {local_rank})"
                f" on {dev}")
    _device = dev
    warmup_collectives()
    return dev


def default_device() -> torch.device:
    """This process's device: the one :func:`initialize` chose, else the
    card (as for ``KppModel``; raises when there is none)."""
    if _device is not None:
        return _device
    from ..models.column_model import resolve_device
    return resolve_device(None)


def warmup_collectives() -> None:
    """A barrier while every process is at the same point (right after
    start-up), so the group's connections are made before the ranks part
    ways into their set-up."""
    if process_count() > 1:
        tdist.barrier()


def shutdown() -> None:
    """Leave the process group (after a barrier, so no rank leaves while
    another still gathers from it)."""
    if tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()


def _to_wire(slab: torch.Tensor) -> torch.Tensor:
    """A CPU tensor gloo can move (bool travels as uint8)."""
    t = slab.detach().to("cpu").contiguous()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


@dataclasses.dataclass(frozen=True)
class ColumnLayout:
    """This process's share of the padded column axis.

    ``ncol`` is the padded global column count (a multiple of ``world``);
    rank r owns the contiguous rows ``[lo, hi)`` = ``[r*ncol/world,
    (r+1)*ncol/world)``, the slab of device r in the JAX package's mesh
    layout, and keeps them on ``device`` (by default
    :func:`default_device`: the card unless the caller asks for the
    CPU)."""
    ncol: int
    ncol_unpadded: int
    rank: int = 0
    world: int = 1
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.ncol % self.world or self.ncol < self.ncol_unpadded:
            raise ValueError(f"ncol {self.ncol} is not a padding of "
                             f"{self.ncol_unpadded} over {self.world} ranks")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside [0, {self.world})")
        object.__setattr__(self, "device", default_device()
                           if self.device is None
                           else torch.device(self.device))

    @property
    def lo(self) -> int:
        return self.rank * (self.ncol // self.world)

    @property
    def hi(self) -> int:
        return self.lo + self.ncol // self.world

    def global_array(self, arr,
                     local: Optional[bool] = None) -> torch.Tensor:
        """This rank's slab of ``arr`` as a tensor on ``device``.

        ``local=True``: ``arr`` is this rank's ``(hi-lo, ...)`` slab (a
        host-local read).  ``local=False``: ``arr`` is the whole domain,
        padded ``(ncol, ...)`` or unpadded ``(ncol_unpadded, ...)``
        (padding rows are zero).  ``local=None`` infers which from the
        shape and raises when it cannot tell; callers with several ranks
        should pass it."""
        n = arr.shape[0]
        want = self.hi - self.lo
        if local is None:
            full = n in (self.ncol, self.ncol_unpadded)
            if full and n == want and self.world > 1:
                raise ValueError(
                    f"global_array: leading dim {n} is both a valid local "
                    "slab and a valid full domain; pass local=True/False "
                    "explicitly")
            local = n == want and not full
        if local:
            if n != want:
                raise ValueError(f"global_array(local=True): got leading "
                                 f"dim {n}, expected {want}")
            loc = arr
        else:
            if n not in (self.ncol, self.ncol_unpadded):
                raise ValueError(
                    f"global_array: got leading dim {n}, expected "
                    f"{self.ncol} (padded), {self.ncol_unpadded} "
                    f"(unpadded) or {want} with local=True")
            loc = pad_rows(arr[self.lo:min(self.hi, n)], want)
        out = torch.as_tensor(loc, device=self.device)
        if isinstance(arr, torch.Tensor) and (
                out.untyped_storage().data_ptr()
                == arr.untyped_storage().data_ptr()):
            out = out.clone()     # so the whole-domain tensor can be freed
        return out.contiguous()

    def shard_tree(self, tree):
        """This rank's slab of a whole-domain tree (padding columns marked
        inactive), on ``device``."""
        slab = map_leaves(lambda a: self.global_array(a, local=False), tree)
        return mark_inactive(slab, self.ncol_unpadded, self.lo)

    def gather(self, arr, dst: Optional[int] = None) -> Optional[np.ndarray]:
        """The whole unpadded domain of a slab, on the host: on every rank
        (``dst=None``), or on rank ``dst`` only (None elsewhere).  A
        collective: every rank calls it, from the loop thread."""
        t = _to_wire(arr)
        if self.world == 1:
            full = t
        elif dst is None:
            parts = [torch.empty_like(t) for _ in range(self.world)]
            tdist.all_gather(parts, t)
            full = torch.cat(parts)
        else:
            parts = ([torch.empty_like(t) for _ in range(self.world)]
                     if self.rank == dst else None)
            tdist.gather(t, parts, dst=dst)
            if self.rank != dst:
                return None
            full = torch.cat(parts)
        if arr.dtype == torch.bool:
            full = full.to(torch.bool)
        return full[: self.ncol_unpadded].numpy()

    def local_shard(self, arr) -> np.ndarray:
        """This rank's rows ``[lo, min(hi, ncol_unpadded))`` of a slab, on
        the host: a device-to-host copy, no collective."""
        lo_u, hi_u = self.local_rows(self.ncol_unpadded)
        return arr[: hi_u - lo_u].detach().cpu().numpy()

    def gather_tree(self, tree, dst: Optional[int] = None):
        """:meth:`gather` over a tree; the leaves come back as CPU tensors
        (None on ranks other than ``dst``)."""
        def one(a):
            g = self.gather(a, dst)
            return a if g is None else torch.from_numpy(g)
        out = map_leaves(one, tree)
        return None if dst is not None and self.rank != dst else out

    def local_rows(self, npts: int) -> Tuple[int, int]:
        """This rank's slab clamped to the unpadded domain [0, npts): the
        rows a host-local read fetches."""
        return min(self.lo, npts), min(self.hi, npts)


def any_across_processes(flag: bool) -> bool:
    """Logical OR of a host boolean over all processes, for decisions the
    reference makes over the whole domain but a rank sees on its slab
    (the SST Kelvin autoconversion, mckpp_read_sst_mod.F90:84-88).  A
    collective, as :meth:`ColumnLayout.gather`."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return bool(t.item())


def make_layout(ncol_unpadded: int, world: Optional[int] = None,
                rank: Optional[int] = None, device=None) -> ColumnLayout:
    """Layout of ``ncol_unpadded`` columns over ``world`` processes (the
    process group's by default), padded to a multiple of ``world`` (the
    kernels take any column count), on ``device`` (by default
    :func:`default_device`)."""
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    ncol = ncol_unpadded + (-ncol_unpadded) % world
    return ColumnLayout(ncol=ncol, ncol_unpadded=ncol_unpadded, rank=rank,
                        world=world, device=device)

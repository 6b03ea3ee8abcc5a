"""Multi-process runtime initialisation (the port of uml_tpu/core/distributed.py).

The reference has no distributed runtime: scale-out is one Slurm array
task per hyperparameter combo, each process on one card.  Beside that
sweep contract (core.sweep), one *job* may span several processes, one
per card: every process calls :func:`maybe_initialize` before its first
collective, after which ``torch.distributed`` holds a process group over
every rank and ``core.meshes.create_mesh`` lays a (data, model) mesh over
it.

Process topology is discovered from (first match wins), as in uml_tpu:

1. Explicit env: ``UML_COORDINATOR`` (host:port), ``UML_NUM_PROCESSES``,
   ``UML_PROCESS_ID``.  ``core.meshes.launch_per_card`` sets these in the
   processes it starts itself, one per card.  A coordinator written as a
   URL (``file:///shared/store``) is passed to the process group as it is.
2. Slurm multi-task env: ``SLURM_NTASKS`` > 1 with ``SLURM_PROCID`` /
   ``SLURM_STEP_NODELIST``.
3. ``UML_AUTO_DISTRIBUTED=1``: the launcher has set torch's own
   variables (``torchrun``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK),
   read through ``init_method="env://"``.

The backend is NCCL on the card and gloo on the CPU
(``UML_TORCH_DEVICE=cpu``).  Each process takes one card: card 0 of its
``CUDA_VISIBLE_DEVICES`` where the CLI started it, else the card of its
local rank (``LOCAL_RANK`` under torchrun, ``SLURM_LOCALID`` under Slurm).
Single-process runs are a no-op: call it unconditionally from every CLI.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import torch
import torch.distributed as dist

from uml_tpu_torch.core.device import default_device


@dataclass(frozen=True)
class ProcessTopology:
    coordinator_address: str | None
    num_processes: int
    process_id: int


def _first_slurm_host(nodelist: str) -> str:
    """'host[3-17,21],other' -> 'host3' (minimal Slurm nodelist expansion:
    only the leading hostname is needed for the coordinator address)."""
    head = nodelist.split(",")[0]
    m = re.match(r"([^\[]+)\[([0-9]+)", head)
    if m:
        return m.group(1) + m.group(2)
    return head


def detect_topology(env: dict | None = None) -> ProcessTopology | None:
    """Inspect the environment for a multi-process topology.

    Returns None for single-process runs (the common case).
    """
    env = os.environ if env is None else env
    if "UML_COORDINATOR" in env:
        return ProcessTopology(
            coordinator_address=env["UML_COORDINATOR"],
            num_processes=int(env.get("UML_NUM_PROCESSES", "1")),
            process_id=int(env.get("UML_PROCESS_ID", "0")),
        )
    ntasks = int(env.get("SLURM_NTASKS", "1") or "1")
    if ntasks > 1 and "SLURM_PROCID" in env:
        nodelist = env.get("SLURM_STEP_NODELIST",
                           env.get("SLURM_NODELIST", ""))
        port = env.get("UML_COORDINATOR_PORT", "8476")
        coord = f"{_first_slurm_host(nodelist)}:{port}" if nodelist else None
        return ProcessTopology(
            coordinator_address=coord,
            num_processes=ntasks,
            process_id=int(env["SLURM_PROCID"]),
        )
    if env.get("UML_AUTO_DISTRIBUTED") == "1":
        # the launcher's own variables (torchrun) describe the job
        return ProcessTopology(coordinator_address=None,
                               num_processes=0, process_id=0)
    return None


def local_card(env: dict | None = None) -> int:
    """The card index this process takes among those it sees."""
    env = os.environ if env is None else env
    return int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", "0")) or "0")


def maybe_initialize(env: dict | None = None) -> bool:
    """Start the process group when the environment describes a
    multi-process job.  Idempotent; no-op (returns False) otherwise."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ if env is None else env
    topo = detect_topology(env)
    if topo is None:
        return False
    device = default_device()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(local_card(env) % torch.cuda.device_count())
    if topo.num_processes == 0:
        dist.init_process_group(backend, init_method="env://")
    else:
        addr = topo.coordinator_address
        dist.init_process_group(
            backend,
            init_method=addr if "://" in addr else f"tcp://{addr}",
            world_size=topo.num_processes, rank=topo.process_id)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes artifacts and logs (rank 0)."""
    return process_index() == 0

"""Joining the process group, and this rank's rows of the global batch.

Counterpart of ``danet_tpu/parallel/multihost.py``.  ``initialize()``
joins a ``torch.distributed`` process group from the launcher's
environment (``python -m torch.distributed.run`` sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; JAX's DANET_COORDINATOR,
``host:port``, stands in for the last two where given) and returns False
for a single process, so that one entry point serves both.  Each process
takes the card ``cuda:LOCAL_RANK`` unless the caller asks for the CPU; on a
card the group carries card tensors over NCCL and host tensors over gloo
(``cpu:gloo,cuda:nccl``), on the CPU everything over gloo.
``host_batch_slice`` is the rows of the global batch this rank loads.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def spans_hosts() -> bool:
    """Whether the group's ranks run on more than one host (the launcher's
    LOCAL_WORLD_SIZE below its WORLD_SIZE)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return local < world


def initialize(device="cuda", backend: Optional[str] = None,
               coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = 1800.0) -> bool:
    """Join the process group a multi-process launch describes.

    -> True when it joined (or had joined), False for a single process.
    ``device`` 'cuda' (this rank's card, ``cuda:LOCAL_RANK``, becomes the
    current device) or 'cpu'; ``backend`` the group's backend, by default
    ``cpu:gloo,cuda:nccl`` on a card and ``gloo`` on the CPU (``gloo`` on a
    card: two ranks sharing one card, whose card tensors
    ``parallel/collectives.py`` stages through the host)."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("DANET_COORDINATOR")
    world = num_processes if num_processes is not None else int(
        env.get("WORLD_SIZE", "0") or 0)
    if coordinator_address is None and "MASTER_ADDR" not in env \
            and world <= 1:
        return False
    rank = process_id if process_id is not None else int(
        env.get("RANK", "0"))
    if coordinator_address is not None:
        init = "tcp://%s" % coordinator_address
    else:
        init = "tcp://%s:%s" % (env["MASTER_ADDR"], env["MASTER_PORT"])
    on_card = torch.device(device).type == "cuda"
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if on_card else "gloo"
    if on_card:
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))))
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=max(world, 1),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def host_batch_slice(global_batch: int) -> slice:
    """Rows of the global batch this rank loads: its share of the rows
    over all the ranks of the group (the Trainer's split over its mesh is
    ``sharding.batch_rows``)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n_proc:
        raise ValueError("global batch %d must divide across %d processes"
                         % (global_batch, n_proc))
    per = global_batch // n_proc
    return slice(pid * per, (pid + 1) * per)

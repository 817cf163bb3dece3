"""Device lists and the cross-shard reduce and gather (counterpart of
raglite_tpu/parallel/mesh.py).

The JAX package is single-controller: one process drives every local
device through a 1-D ``Mesh`` and ``jax.distributed`` joins hosts.  The
port keeps that shape without a mesh object:

- a "mesh" is a list of ``torch.device``s, one per shard.  One process
  holds every shard of its list and enqueues every shard's work before it
  synchronizes any of them, so that separate cards run at once; results
  merge on the first device.  A device may appear more than once: shards
  then share it, as the JAX tests' eight virtual CPU devices share one CPU;
- across processes, ``torch.distributed`` joins the ranks, and only the
  ``[B, k]`` winners cross between them (:func:`gather_winners`), as only
  they cross the ICI in the JAX package.
"""

from __future__ import annotations

import logging
import os
from functools import lru_cache

import torch

from raglite_tpu_torch.config import checked_device

__all__ = [
    "distributed_init",
    "gather_winners",
    "index_devices",
    "reduce_sum",
    "split_rows",
    "tp_devices",
]

logger = logging.getLogger(__name__)


def distributed_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> None:
    """Join this process to a ``torch.distributed`` process group.

    ``coordinator_address`` is ``host:port`` of rank 0.  With no arguments
    the group comes from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); where none is set there is
    no cluster, and the call returns quietly (one process is a legitimate
    configuration).  A second call is a no-op.  A coordinator that was asked
    for explicitly and fails raises: going on alone would index and search a
    fraction of the corpus with no error.  ``backend`` defaults to NCCL
    where CUDA is available and gloo elsewhere (NCCL refuses two ranks on
    one card: pass "gloo" there)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    explicit = not (coordinator_address is None and num_processes is None and process_id is None)
    if not explicit:
        if not all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
            return  # auto-detection found no cluster
        dist.init_process_group(backend=backend, init_method="env://")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        msg = "distributed_init: give coordinator_address, num_processes and process_id together"
        raise ValueError(msg)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


@lru_cache(maxsize=16)
def _placement(count: int, device: torch.device) -> tuple[torch.device, ...]:
    """``count`` shard devices of ``device``'s type: the CPU ``count``
    times; cards cuda:0 .. cuda:{count-1}, round-robin over the cards there
    are when fewer exist (one WARNING, once per count)."""
    if count == 1:
        return (device,)
    if device.type == "cpu":
        return (device,) * count
    cards = torch.cuda.device_count()
    if count > cards:
        logger.warning(
            "%d shards on %d CUDA device(s): up to %d shards share each card", count, cards, -(-count // cards)
        )
    return tuple(torch.device("cuda", i % cards) for i in range(count))


def index_devices(num_devices: int = 0, device: torch.device | str = "cuda") -> list[torch.device]:
    """The shard devices of a row-sharded index (``index_mesh``'s
    counterpart): ``num_devices`` shards (0 = one per card, or one on the
    CPU) on ``device``'s type.  Never falls back from CUDA to the CPU."""
    device = checked_device(str(device))
    if num_devices < 0:
        msg = f"num_devices must be >= 0, got {num_devices}"
        raise ValueError(msg)
    count = num_devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
    return list(_placement(count, device))


def tp_devices(tp: int = 0, device: torch.device | str = "cuda") -> list[torch.device]:
    """The shard devices of a tensor-parallel decoder (``tp_mesh``'s
    counterpart): the rule of :func:`index_devices`."""
    return index_devices(tp, device)


def split_rows(x: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """Contiguous row shards of ``x``, shard s on ``devices[s]`` (the
    counterpart of placing an array with ``row_sharding``).  A shard on
    ``x``'s own device is a view, not a copy."""
    n = len(devices)
    if x.shape[0] % n:
        msg = f"split_rows: {x.shape[0]} rows do not split into {n} equal shards"
        raise ValueError(msg)
    c = x.shape[0] // n
    return [x[s * c : (s + 1) * c].to(dev) for s, dev in enumerate(devices)]


def reduce_sum(partials: list[torch.Tensor], *, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Sum the shards' partials in shard order, in f32, on the first
    shard's device, rounded once to ``dtype`` (default: the partials'): the
    reduce after a row-parallel matmul.  The sum stays on the first device,
    where the decoder's residual stream lives; each shard is sent the normed
    activations it projects next (parallel/tp_decoder.py)."""
    first = partials[0]
    total = first.to(torch.float32)
    for p in partials[1:]:
        total = total + p.to(first.device, torch.float32)
    return total.to(dtype or first.dtype)


def gather_winners(
    scores: list[torch.Tensor], ids: list[torch.Tensor], group=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every shard's ``[B, k]`` winners side by side on the first shard's
    device: (scores [B, S·k], ids [B, S·k]) in shard order, then, with a
    process ``group``, every rank's in rank order.  Across ranks the scores
    and ids travel as one f64 tensor (exact for both), through host memory
    when the group's backend is not NCCL."""
    first = scores[0].device
    s_cat = torch.cat([s.to(first) for s in scores], dim=1)
    i_cat = torch.cat([i.to(first, torch.int64) for i in ids], dim=1)
    if group is None:
        return s_cat, i_cat
    import torch.distributed as dist

    packed = torch.stack([s_cat.to(torch.float64), i_cat.to(torch.float64)])
    if dist.get_backend(group) != "nccl":
        packed = packed.cpu()
    parts = [torch.empty_like(packed) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, packed.contiguous(), group=group)
    both = torch.cat([p.to(first) for p in parts], dim=2)
    return both[0].to(scores[0].dtype), both[1].to(torch.int64)

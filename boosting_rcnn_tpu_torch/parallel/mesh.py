"""Data-parallel training over ``torch.distributed`` (PyTorch port of
``boosting_rcnn_tpu/parallel/mesh.py``).

The JAX step is global-view: one jit over a batch sharded on a ``data``
mesh, so every sum and mean in the loss is over the global batch.  The
port runs one process a card instead, each with its own slice of the
batch, and reproduces that step:

  * each batch-dependent normaliser is reduced by its mean over the
    ranks (``global_count``): a local sum over it gives ``N`` times the
    rank's share of the global loss, and the gradients are averaged over
    the ranks after the backward (``average_gradients``: one all-reduce
    over a flat buffer), which gives the global loss's gradient; a clamp
    moves with the sum (the global ``max(P, 1)`` becomes ``max(P / N, 1 /
    N)`` on each rank); means over a fixed number of slots need nothing;
  * SyncBN's batch mean and ``E[x^2]`` go through ``differentiable_mean``,
    an all-reduce mean whose backward all-reduces the cotangent;
  * the samplers draw the global batch's uniforms from the shared
    generator, and each rank keeps its images' (``rank_draws``).

``cluster_spec_from_env`` reads the launcher's variables as the JAX
function does; ``init_distributed`` joins the group (NCCL for a rank on a
card, gloo for one on the CPU).  With one process every function here is
the identity, and nothing is initialised.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["cluster_spec_from_env", "init_distributed", "world_size", "rank", "is_main",
           "barrier", "all_reduce_mean", "differentiable_mean", "global_count",
           "average_gradients", "reduce_metrics", "rank_draws", "local_device", "backend_for"]


def _first_hostname(nodelist: str) -> str:
    """The first host of a Slurm hostlist (``host``, ``a,b`` or
    ``prefix[001-003,007]``, its zero padding kept)."""
    head = nodelist.split(",")[0] if "[" not in nodelist.split(",")[0] else nodelist
    if "[" in head:
        prefix, rest = head.split("[", 1)
        first = rest.split("]", 1)[0].split(",")[0].split("-")[0]
        return prefix + first
    return head


def cluster_spec_from_env(env=None) -> Optional[Tuple[str, Optional[int], Optional[int]]]:
    """``(coordinator_address, num_processes, process_id)`` from the
    environment: ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
    ``PROCESS_ID`` when set, else Slurm's ``SLURM_NTASKS`` /
    ``SLURM_PROCID`` with the first host of ``SLURM_STEP_NODELIST`` (or
    ``SLURM_JOB_NODELIST``) and port ``COORDINATOR_PORT`` (default ``8476 +
    SLURM_JOB_ID % 1024``); None for a single process."""
    env = os.environ if env is None else env
    if env.get("COORDINATOR_ADDRESS"):
        return (env["COORDINATOR_ADDRESS"],
                int(env["NUM_PROCESSES"]) if env.get("NUM_PROCESSES") else None,
                int(env["PROCESS_ID"]) if env.get("PROCESS_ID") else None)
    nodelist = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_JOB_NODELIST")
    if not nodelist or not env.get("SLURM_NTASKS"):
        return None
    ntasks = int(env["SLURM_NTASKS"])
    if ntasks <= 1:
        return None
    port = int(env.get("COORDINATOR_PORT", 8476 + int(env.get("SLURM_JOB_ID", 0)) % 1024))
    return f"{_first_hostname(nodelist)}:{port}", ntasks, int(env.get("SLURM_PROCID", 0))


# The rendezvous waits ``JOIN_TIMEOUT`` for every rank to join.  The
# group's collectives (the gradient all-reduce, SyncBN, the barrier around
# rank 0's checkpoint) wait ``COLLECTIVE_TIMEOUT``: every rank evaluates, as
# every JAX process does, so no barrier spans one rank's evaluation.
JOIN_TIMEOUT = datetime.timedelta(minutes=10)
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)


def backend_for(device) -> str:
    """NCCL for a rank that trains on a card, gloo for one on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(env=None) -> torch.device:
    """This process's card on its host: ``cuda:LOCAL_RANK`` (or Slurm's
    ``SLURM_LOCALID``) where the launcher sets one, else the process id of
    ``cluster_spec_from_env`` modulo the host's cards (ranks laid out host
    by host); ``cuda:0`` for a single process."""
    env = os.environ if env is None else env
    local = env.get("LOCAL_RANK") or env.get("SLURM_LOCALID")
    if local is None:
        spec = cluster_spec_from_env(env)
        local = (spec[2] or 0) if spec is not None else 0
    return torch.device("cuda", int(local) % max(torch.cuda.device_count(), 1))


def init_distributed(device, env=None) -> bool:
    """Join the process group of ``cluster_spec_from_env(env)`` for a rank
    that trains on ``device`` (``backend_for``; a card is made the current
    one); False (and nothing done) for a single process or where the group
    is already up.  The rendezvous at the coordinator (a TCP store that
    process 0 serves) fails after ``JOIN_TIMEOUT``; the collectives wait
    ``COLLECTIVE_TIMEOUT``."""
    if dist.is_initialized():
        return False
    spec = cluster_spec_from_env(env)
    if spec is None:
        return False
    addr, nproc, pid = spec
    if nproc is None:
        raise ValueError("COORDINATOR_ADDRESS is set without NUM_PROCESSES")
    pid = pid or 0
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    host, port = addr.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), nproc, is_master=pid == 0, timeout=JOIN_TIMEOUT)
    dist.init_process_group(backend_for(device), store=store, world_size=nproc, rank=pid,
                            timeout=COLLECTIVE_TIMEOUT)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, without gradient (``x`` itself for
    one process)."""
    n = world_size()
    if n == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / n


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y / world_size()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g / world_size()


def differentiable_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, with the cotangent all-reduced
    (mean) in the backward; ``x`` for one process."""
    return x if world_size() == 1 else _AllReduceMean.apply(x)


def global_count(x: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """A loss normaliser that sums over the batch, clamped at ``floor``:
    ``max(x, floor)`` for one process, ``max(mean_r x, floor / N)`` over
    ``N`` ranks (the rank's share of the global normaliser)."""
    return torch.clamp(all_reduce_mean(x), min=floor / world_size())


def average_gradients(params: Sequence[torch.nn.Parameter]) -> None:
    """Average the gradients of ``params`` over the ranks with one
    all-reduce over a flat buffer (a missing gradient is a zero one, as the
    optimizer takes it)."""
    n = world_size()
    if n == 1:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    flat /= n
    offset = 0
    for p in params:
        k = p.numel()
        p.grad.copy_(flat[offset:offset + k].view_as(p.grad))
        offset += k


def reduce_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar metric's mean over the ranks (one all-reduce)."""
    if world_size() == 1:
        return metrics
    keys = list(metrics)  # the same names in the same order on every rank
    flat = all_reduce_mean(torch.stack([metrics[k].detach().float().reshape(()) for k in keys]))
    return {k: flat[i] for i, k in enumerate(keys)}


def rank_draws(generator: Optional[torch.Generator], shape: Sequence[int], local_count: int,
               device) -> torch.Tensor:
    """``(local_count, *shape)`` uniforms for this rank's images: the
    generator draws ``shape`` once for each image of the global batch
    (``N * local_count`` of them, in rank order, as one process on the
    whole batch draws them), and the rank keeps its own."""
    dev = generator.device if generator is not None else device
    draws = [torch.rand(tuple(shape), generator=generator, device=dev)
             for _ in range(world_size() * local_count)]
    r = rank()
    return torch.stack(draws[r * local_count:(r + 1) * local_count]).to(device)

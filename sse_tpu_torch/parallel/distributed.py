"""Several processes joined by ``torch.distributed`` (port of
``sse_tpu/parallel/distributed.py``, the counterpart of
``jax.distributed.initialize``).

``initialize`` joins the process group over TCP. Its backend follows a
rule: NCCL when every rank has a card of its own, gloo when ranks share a
card or run on the CPU. The group is made with gloo first (a card-free
rendezvous that exchanges each rank's card), and an NCCL group is added
for the device collectives when the rule allows it; the choice and the
NCCL version are logged. Under gloo, whose collectives take CPU tensors,
a tensor crosses between processes through host memory, explicitly
(``all_gather``).

The backend decides what a CUDA graph can hold (``captures``). An NCCL
collective runs on the card: ProcessGroupNCCL issues it on its own stream,
joined to the current stream by events, which a capture takes as a fork
and a join, so a captured program holds its collectives (PyTorch's CUDA
Graphs notes, NCCL >= 2.9.6; ``check_capturable`` raises on an older
one). NCCL makes a group's communicator on its first collective, which
no capture may hold, so ``initialize`` issues one eager ``all_reduce``
first. ProcessGroupNCCL's asynchronous error handling stays as PyTorch
sets it (``TORCH_NCCL_ASYNC_ERROR_HANDLING`` unset): PyTorch's CUDA Graphs
notes ask for it off under DDP, but PyTorch 2.11's ProcessGroupNCCL keeps
a collective issued under capture off its watchdog, and captures and
replays run with it on (NCCL 2.28.9, NVIDIA H100: ``chip_smoke.py
--processes``, ``tests/test_torch_gpu_processes.py``). Blocking wait
stays off too, as it would sync the host in every collective. A gloo
collective runs on the host, so a grid over gloo runs its programs
eagerly. Neither collective reads a value on the host.

The group is process-wide state, as JAX's distributed client is: this
module records the rank's card and the group its device collectives use.
``collectives`` counts the device collectives issued, by op (every rank
must issue the same collectives in the same order, or the ones that went
first wait for the others).

Collectives that carry gradients (training on a grid, the
context-parallel encode across processes):

* ``gather_rows(t, dim)``: every rank's ``t`` concatenated in rank order,
  for a computation that every rank then repeats on the same values (the
  train step's global loss). Its backward takes this rank's slice of the
  cotangent and needs no collective: every rank holds the whole,
  identical cotangent. (``torch.distributed.nn.functional.all_gather``
  sums the cotangents over the ranks instead, which on an identical loss
  makes every gradient ``world`` times too large.)
* ``gather_rows(t, dim, scatter=True)``: the same forward for a
  computation that differs by rank (context parallelism's keys and
  values, read by each rank's own queries): the backward sums the
  cotangents over the ranks and takes this rank's slice (a reduce-scatter,
  made of ``all_gather``, since gloo has no ``reduce_scatter``).
* ``sum_over_ranks(t)``: the sum of every rank's ``t`` in rank order, the
  same on every rank (no gradient: the train step sums its gradients
  over 'data' with it).
* ``sum_grads_over_ranks(t)``: ``t`` itself, with a backward that sums
  the cotangent over the ranks (the gradient of a parameter replicated
  over ranks that each use it on their own shard of the work).

A sum over 'model' never crosses processes: a rank holds whole grid rows
in training (``train.grid``), so the [B]-sized partials of its table
blocks meet on its own devices.
"""

from __future__ import annotations

import collections
import sys
from typing import Any, List, Optional

import torch
import torch.distributed as dist

# this process's card and the group of its device collectives, set by
# initialize (the default gloo group when the ranks share a card)
_state: dict = {"device": None, "group": None, "backend": None}

# the oldest NCCL whose collectives a CUDA graph can hold (PyTorch's CUDA
# Graphs notes)
CAPTURE_NCCL = (2, 9, 6)

# device collectives issued so far, by op (``ops.GraphLaunches`` takes a
# capture's out and adds them back each replay)
collectives: collections.Counter = collections.Counter()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


def _default_device(process_id: int) -> torch.device:
    """Rank r takes card r mod the visible cards, or the CPU if none."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def _card_id(device: torch.device) -> Optional[str]:
    """A card's identity across processes (its UUID), None for the CPU."""
    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device).uuid)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join ``num_processes`` processes at ``coordinator_address``
    (host:port of rank 0). No-op for one process or fewer. This rank's
    card is card ``process_id`` mod the visible cards (the CPU where
    there is none).

    Afterwards ``make_mesh()`` spans every rank's card, and the sharded
    index and query path exchange their small per-shard results with the
    other ranks."""
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs coordinator_address, num_processes and process_id "
            "(torch.distributed detects none of them)"
        )
    device = _default_device(process_id)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    cards = all_gather_object(_card_id(device))
    own = all(c is not None for c in cards) and len(set(cards)) == len(cards)
    version = ""
    if own:
        torch.cuda.set_device(device)
        _state["group"] = dist.new_group(backend="nccl")
        # the communicator is made on a group's first collective, which no
        # capture may hold: make it now, eagerly
        warm = torch.zeros(1, device=device)
        dist.all_reduce(warm, group=_state["group"])
        torch.cuda.synchronize(device)
        version = f", NCCL {nccl_version()}"
        why = "every rank has a card of its own"
    else:
        _state["group"] = None  # the default gloo group
        why = "ranks share a card" if all(c is not None for c in cards) else "ranks run on the CPU"
    _state["device"], _state["backend"] = device, "nccl" if own else "gloo"
    print(f"[sse] distributed: rank {process_id} of {num_processes} on {device}, "
          f"device collectives over {_state['backend']}{version} ({why}); captured programs "
          f"{'hold them' if own else 'none: eager'}", file=sys.stderr, flush=True)


def local_device() -> torch.device:
    """This rank's card, as ``initialize`` chose it."""
    if _state["device"] is None:
        raise RuntimeError("parallel.distributed.initialize has not run in this process")
    return _state["device"]


def backend() -> Optional[str]:
    """"nccl" or "gloo" after ``initialize``, None in one process."""
    return _state["backend"] if world_size() > 1 else None


def captures() -> bool:
    """Whether a program across processes can be captured as CUDA graphs
    with its collectives inside: the device collectives run over NCCL and
    this rank's device is a card. ``initialize`` fixes the answer, the same
    on every rank (its rule reads every rank's card). False in one
    process."""
    dev = _state["device"]
    return backend() == "nccl" and dev is not None and dev.type == "cuda"


def nccl_version() -> str:
    """The NCCL that PyTorch was built with, as "major.minor.patch"."""
    v = torch.cuda.nccl.version()
    return ".".join(str(x) for x in v) if isinstance(v, tuple) else str(v)


def check_capturable() -> None:
    """Raise where a capture cannot hold this group's collectives: NCCL
    older than ``CAPTURE_NCCL``."""
    v = torch.cuda.nccl.version()
    if isinstance(v, tuple) and v < CAPTURE_NCCL:
        raise RuntimeError(f"NCCL {nccl_version()} cannot be captured in a CUDA graph (needs "
                           f"{'.'.join(map(str, CAPTURE_NCCL))} or newer)")


def _issued(op: str, t: torch.Tensor) -> None:
    """Count a device collective on ``t`` (its input)."""
    collectives[op] += 1


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (over the gloo group)."""
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """[world, *t.shape]: every rank's ``t`` (same shape and type on every
    rank), on ``t``'s device. Under gloo the tensors cross through host
    memory; under NCCL they stay on the cards, gathered into one output
    (``all_gather_into_tensor``)."""
    _issued("all_gather", t)
    if _state["backend"] != "nccl":
        src = t.cpu()
        out = [torch.empty_like(src) for _ in range(world_size())]
        dist.all_gather(out, src.contiguous(), group=_state["group"])
        return torch.stack(out).to(t.device)
    src = t.to(local_device()).contiguous()
    out = torch.empty((world_size(), *src.shape), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=_state["group"])
    return out.to(t.device)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t`` (same shape and type on every rank) on
    ``t``'s device, by one ``all_reduce``: bit for bit the same on every
    rank (each part of the sum is reduced once and then shared), in the
    collective's order of summation. Each rank holds one copy of ``t``,
    not one a rank; under gloo it crosses through host memory. ``t`` is
    left as it was."""
    _issued("all_reduce", t)
    on_host = _state["backend"] != "nccl"
    out = t.detach().to("cpu" if on_host else local_device(), copy=True).contiguous()
    dist.all_reduce(out, group=_state["group"])
    return out.to(t.device)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, scatter):
        ctx.dim, ctx.scatter, ctx.n = dim, scatter, t.shape[dim]
        return torch.cat(list(all_gather(t).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            g = sum_over_ranks(g.contiguous())
        return g.narrow(ctx.dim, rank() * ctx.n, ctx.n), None, None


def gather_rows(t: torch.Tensor, dim: int = 0, scatter: bool = False) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order, on
    ``t``'s device, differentiable: the backward takes this rank's slice of
    the cotangent, summed over the ranks first with ``scatter`` (see the
    module docstring for which to use)."""
    return _GatherRows.apply(t, dim, scatter)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return sum_over_ranks(g.contiguous())


def sum_grads_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose gradient is summed over the ranks in the backward."""
    return _SumGrads.apply(t)


def barrier() -> None:
    dist.barrier()


def process_info() -> dict:
    """The JAX package's keys: this process's rank and the count of
    processes, its cards and those of every process (one card a rank in a
    group of several)."""
    if world_size() > 1:
        return {"process_index": rank(), "process_count": world_size(),
                "local_devices": 1, "global_devices": world_size()}
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"process_index": 0, "process_count": 1, "local_devices": cards,
            "global_devices": cards}


__all__ = ["all_gather", "all_gather_object", "backend", "barrier", "captures",
           "check_capturable", "collectives", "gather_rows", "initialize", "local_device",
           "nccl_version", "process_info", "rank", "sum_grads_over_ranks", "sum_over_ranks",
           "world_size"]

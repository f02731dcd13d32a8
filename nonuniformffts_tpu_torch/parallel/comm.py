"""The collectives of the two multi-device modes, over a
``torch.distributed`` process group (``group=None``: the default group).

Counterpart of what XLA placed on ICI for the JAX package's ``shard_map``
bodies: ``all_to_all`` (``all_to_all_single``), ``all_reduce`` (psum),
``all_gather``, and the dim-0 halo exchange between neighbouring ranks (the
``ppermute`` of ``ops/pallas/common.py:540-557``), which is point-to-point:
each rank talks to its two neighbours only.

NCCL takes CUDA tensors for every one of them.  Gloo takes CUDA tensors
for the collectives in ``GLOO_CUDA_OPS`` and CPU tensors only for the rest:
there a CUDA tensor is copied to the host and the result back.  The choice
is made from the group's backend name before the call, never by catching
an error; ``HOST_STAGED`` counts the calls staged through the host, by
collective.  Complex tensors travel as their real views.
"""

from __future__ import annotations

import collections
import contextlib
import socket
import time
import weakref
import zlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

#: Collectives that gloo runs on CUDA tensors itself.  Two gloo ranks on one
#: NVIDIA H100 (torch 2.11.0+cu128) ran all_to_all_single, all_reduce and
#: all_gather (and broadcast, all_gather_into_tensor, reduce_scatter_tensor)
#: right on CUDA tensors; send / recv and batch_isend_irecv failed in gloo's
#: TCP transport ("writev ... Bad address"): the neighbour exchange goes
#: through the host (PERF.md).
GLOO_CUDA_OPS = frozenset({"all_to_all", "all_reduce", "all_gather"})

#: Calls whose CUDA tensors went through host memory, by collective.
HOST_STAGED = collections.Counter()

#: None, or a dict to which every collective adds its seconds under its
#: name, the device synchronised before and after it (the collectives'
#: share of a call in chip_smoke.py; the synchronisations cost time).
TIMER = None


@contextlib.contextmanager
def _timed(op: str, x: torch.Tensor):
    if TIMER is None:
        yield
        return
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    yield
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    TIMER[op] = TIMER.get(op, 0.0) + time.perf_counter() - t0


def backend(group=None) -> str:
    return str(dist.get_backend(group)).lower()


OPS = ("all_to_all", "all_reduce", "all_gather", "neighbour_exchange")


def staged_ops(group=None) -> Tuple[str, ...]:
    """The collectives this module runs through host memory for CUDA tensors
    on ``group``'s backend: none on NCCL, those outside ``GLOO_CUDA_OPS`` on
    gloo, all on any other backend."""
    name = backend(group)
    if name == "nccl":
        return ()
    return tuple(op for op in OPS if not (name == "gloo" and op in GLOO_CUDA_OPS))


def _via_host(op: str, x: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``x`` must go through host memory on this group."""
    return x.device.type == "cuda" and op in staged_ops(group)


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` (n, ...), slice ``s`` for rank ``s``; returns (n, ...) whose
    slice ``s`` came from rank ``s``."""
    x = x.contiguous()
    staged = _via_host("all_to_all", x, group)
    with _timed("all_to_all", x):
        src = x.cpu() if staged else x
        out = torch.empty_like(src)
        dist.all_to_all_single(_real(out), _real(src), group=group)
        if staged:
            HOST_STAGED["all_to_all"] += 1
            out = out.to(x.device)
    return out


def all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place reduction (``op``, by default the sum) of ``x`` over the
    group; returns ``x``."""
    if not x.is_contiguous():
        raise ValueError("all_reduce needs a contiguous tensor")
    with _timed("all_reduce", x):
        if _via_host("all_reduce", x, group):
            HOST_STAGED["all_reduce"] += 1
            h = x.cpu()
            dist.all_reduce(_real(h), op=op, group=group)
            x.copy_(h)
        else:
            dist.all_reduce(_real(x), op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Returns (n,) + x.shape, slice ``s`` from rank ``s``."""
    x = x.contiguous()
    staged = _via_host("all_gather", x, group)
    with _timed("all_gather", x):
        src = x.cpu() if staged else x
        out = src.new_empty((dist.get_world_size(group),) + tuple(src.shape))
        dist.all_gather([_real(o) for o in out.unbind(0)], _real(src), group=group)
        if staged:
            HOST_STAGED["all_gather"] += 1
            out = out.to(x.device)
    return out


def neighbour_exchange(to_prev: torch.Tensor, to_next: torch.Tensor,
                       group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_prev`` to rank ``r - 1`` and ``to_next`` to rank ``r + 1``
    (periodic over the group); returns ``(from_next, from_prev)``: what rank
    ``r + 1`` sent to its previous rank and what rank ``r - 1`` sent to its
    next.  One rank exchanges with itself without communication; with two
    ranks both messages go to the same peer and are told apart by tag (gloo)
    or by issue order (NCCL)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return to_prev, to_next
    prev, nxt = (me - 1) % n, (me + 1) % n
    if group is not None:
        prev = dist.get_global_rank(group, prev)
        nxt = dist.get_global_rank(group, nxt)
    staged = _via_host("neighbour_exchange", to_prev, group)
    dev = to_prev.device
    with _timed("neighbour_exchange", to_prev):
        send_p, send_n = (t.contiguous().cpu() if staged else t.contiguous()
                          for t in (to_prev, to_next))
        from_next = torch.empty_like(send_p)
        from_prev = torch.empty_like(send_n)
        ops = [
            dist.P2POp(dist.isend, _real(send_p), prev, group, tag=0),
            dist.P2POp(dist.isend, _real(send_n), nxt, group, tag=1),
            dist.P2POp(dist.irecv, _real(from_next), nxt, group, tag=0),
            dist.P2POp(dist.irecv, _real(from_prev), prev, group, tag=1),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            HOST_STAGED["neighbour_exchange"] += 1
            from_next, from_prev = from_next.to(dev), from_prev.to(dev)
    return from_next, from_prev


def device_key(device: torch.device) -> torch.Tensor:
    """(host, card) of ``device`` in this process as two int64s on it: the
    host name's CRC-32 and that of the card's UUID (-1 for the CPU).  The
    UUID names the physical card, whatever index ``CUDA_VISIBLE_DEVICES``
    gives it: ranks that each see their own card as ``cuda:0`` do not
    count as sharing one."""
    card = -1
    if device.type == "cuda":
        card = zlib.crc32(str(torch.cuda.get_device_properties(device).uuid).encode())
    host = zlib.crc32(socket.gethostname().encode())
    return torch.tensor([host, card], dtype=torch.int64, device=device)


def ranks_sharing(keys: torch.Tensor, mine: torch.Tensor) -> int:
    """How many rows of ``keys`` (one :func:`device_key` a rank) name the
    device ``mine`` names: the ranks whose memory is one card's."""
    return int((keys.view(-1, 2) == mine.view(1, 2)).all(dim=1).sum())


#: :func:`ranks_on_device`'s counts, by group and device.
_SHARING = weakref.WeakKeyDictionary()


def ranks_on_device(device: torch.device, group=None) -> int:
    """How many ranks of ``group`` run on this rank's device (the same host
    and card; every rank of a host on the CPU): each plans with that share
    of the card's memory (``plan.py:device_share_bytes``).  Counted once a
    group and device, by one all_gather of :func:`device_key` on the first
    call, which every rank of the group makes; later calls communicate
    nothing."""
    counts = _SHARING.setdefault(group if group is not None else dist.group.WORLD, {})
    if str(device) not in counts:
        mine = device_key(device)
        counts[str(device)] = ranks_sharing(all_gather(mine, group), mine)
    return counts[str(device)]


def agreed_chunk(chunk: Optional[int], ntransforms: int, device: torch.device,
                 group=None) -> Optional[int]:
    """The smallest ``transform_chunk`` of the group's ranks (None, all
    ``ntransforms`` in one pass, counts as ``ntransforms``), from one
    all_reduce: ranks whose points or share of a card differ choose
    different sizes, and each group of transforms runs collectives, which
    pair up only when every rank runs the same groups."""
    x = torch.tensor([ntransforms if chunk is None else chunk], dtype=torch.int64,
                     device=device)
    smallest = int(all_reduce(x, group, op=dist.ReduceOp.MIN))
    return None if smallest >= ntransforms else smallest

"""Named-axis collectives over the mesh's process groups.

Port of ``distributed_tensorflow_tpu/parallel/collectives.py``.  The
reference's collectives are ``jax.lax`` ops on a named axis inside a
``shard_map``; here each acts on the process group of one mesh axis (or a
tuple of axes, ``Mesh.group``) and on this rank's tensor.  An axis of size
1 is the identity: nothing is sent.

- ``psum``, ``pmean``, ``pmax``, ``pmin``: all-reduce (a new tensor).
- ``all_gather`` (tiled: concatenated along ``gather_axis``, the
  reference's default) and ``all_gather_list`` (one tensor a rank).
- ``reduce_scatter``: the sum, then this rank's block of ``scatter_axis``.
- ``ppermute`` (pairs (src, dst) of axis coordinates), ``ring_shift`` and
  ``send_recv`` (point-to-point), ``all_to_all``, ``broadcast`` and
  ``axis_index``.
- ``psum_sparse``: rows scattered into a dense zero tensor, then ``psum``.

Transport: NCCL keeps CUDA tensors on the stream.  Gloo takes host
tensors only, so a CUDA tensor goes through host memory (the stream is
synchronised, the copy reduced or sent, the result copied back): that is
how ranks that share one card communicate.  Gloo has no reduce-scatter;
it is an all-reduce and a slice there.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def _staged(x: torch.Tensor, group) -> bool:
    """True where ``x`` must go through host memory (gloo with a CUDA
    tensor)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
        return x.to("cpu")
    return x


def _reduce(x: torch.Tensor, mesh, axis, op) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    if _staged(x, group):
        host = _host(x).contiguous()
        dist.all_reduce(host, op=op, group=group)
        return host.to(x.device, non_blocking=True)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """All-reduce sum over ``axis``."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """All-reduce mean over ``axis``."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM) / mesh.axis_size(axis)


def pmax(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MIN)


def psum_(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``psum`` in place into ``x`` (a contiguous tensor); returns ``x``."""
    group = mesh.group(axis)
    if group is None:
        return x
    if _staged(x, group):
        host = _host(x)
        dist.all_reduce(host, group=group)
        x.copy_(host, non_blocking=True)
    else:
        dist.all_reduce(x, group=group)
    return x


def all_gather_list(x: torch.Tensor, mesh, axis) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axis``, in axis order (shapes equal)."""
    group = mesh.group(axis)
    if group is None:
        return [x]
    n = mesh.axis_size(axis)
    src = _host(x).contiguous() if _staged(x, group) else x.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.to(x.device, non_blocking=True) for o in out]


def all_gather(x: torch.Tensor, mesh, axis, *, gather_axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """All-gather over ``axis``: concatenated along ``gather_axis``
    (``tiled``) or stacked in a new leading dim."""
    parts = all_gather_list(x, mesh, axis)
    return torch.cat(parts, gather_axis) if tiled else torch.stack(parts)


def reduce_scatter(x: torch.Tensor, mesh, axis, *, scatter_axis: int = 0) -> torch.Tensor:
    """The sum over ``axis``, then this rank's block of ``scatter_axis``
    (its size must divide by the axis size)."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_axis} of {tuple(x.shape)} does not "
                         f"divide by {n}")
    if dist.get_backend(group) == "gloo":
        return psum(x, mesh, axis).chunk(n, scatter_axis)[i].contiguous()
    y = x.movedim(scatter_axis, 0).contiguous()
    out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    dist.reduce_scatter_tensor(out, y, group=group)
    return out.movedim(0, scatter_axis)


def send_recv(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]], group=None):
    """Post point-to-point transfers: each (tensor, global rank) of
    ``sends`` is sent, each of ``recvs`` received into.  Returns a
    ``wait()`` callable that completes them (and, over gloo, copies the
    host buffers of CUDA tensors back to the card)."""
    staged = any(_staged(t, group) for t, _ in [*sends, *recvs])
    ops, back = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, (_host(t) if staged else t).contiguous(), peer, group))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype) if staged else t
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        if staged:
            back.append((t, buf))
    reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait():
        for r in reqs:  # the ops' tensors live until here
            r.wait()
        ops.clear()
        for t, buf in back:
            t.copy_(buf, non_blocking=True)

    return wait


def ppermute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Point-to-point permutation over ``axis``: the rank at coordinate
    ``src`` sends its ``x`` to ``dst`` for each (src, dst); a rank that
    receives nothing gets zeros."""
    if mesh.group(axis) is None:
        return x.clone()
    me = mesh.axis_index(axis)
    out = torch.zeros_like(x)
    sends = [(x, mesh.rank_at(axis, d)) for s, d in perm if s == me]
    recvs = [(out, mesh.rank_at(axis, s)) for s, d in perm if d == me]
    send_recv(sends, recvs, mesh.group(axis))()
    return out


def ring_shift(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Rotate values around the axis ring by ``shift`` positions."""
    n = mesh.axis_size(axis)
    return ppermute(x, mesh, axis, [(i, (i + shift) % n) for i in range(n)])


def all_to_all(x: torch.Tensor, mesh, axis, *, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """All-to-all: block j of ``split_axis`` goes to coordinate j, and the
    blocks received are concatenated along ``concat_axis`` in axis order."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n = mesh.axis_size(axis)
    staged = _staged(x, group)
    src = _host(x) if staged else x
    ins = [c.contiguous() for c in src.chunk(n, split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=group)
    return torch.cat(outs, concat_axis).to(x.device)


def broadcast(x: torch.Tensor, mesh, axis, root: int = 0) -> torch.Tensor:
    """``x`` of the rank at coordinate ``root`` along ``axis``, on every
    rank (the reference's select-and-psum)."""
    keep = mesh.axis_index(axis) == root
    return psum(x if keep else torch.zeros_like(x), mesh, axis)


def axis_index(mesh, axis) -> int:
    return mesh.axis_index(axis)


def psum_sparse(values: torch.Tensor, indices: torch.Tensor, mesh, axis, *,
                dense_size: int) -> torch.Tensor:
    """All-reduce of a sparse (indices, values) gradient into dense form:
    rows scattered (summed) into zeros of ``dense_size`` rows, then a sum
    over ``axis``."""
    dense = torch.zeros((dense_size,) + tuple(values.shape[1:]), dtype=values.dtype,
                        device=values.device)
    dense.index_add_(0, indices.long(), values)
    return psum(dense, mesh, axis)


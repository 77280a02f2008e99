"""Pipeline parallelism over the mesh's ``pipe`` axis: GPipe and 1F1B.

Port of ``distributed_tensorflow_tpu/parallel/pipeline.py``
(``pipeline_apply``, ``pipeline_value_and_grad``, ``PipelineVJP``).  The
reference is one SPMD program: every stage computes every tick, on masked
garbage in the bubbles, and the tail (the loss) runs on all S stages,
because GSPMD collectives may not sit in control flow that differs
between devices.  Here each rank runs its own stage's schedule, and the
stage's own collectives (tensor parallelism inside it) are issued alike
by the ranks of that stage, which run the same schedule:

- ``gpipe``: every microbatch's forward in order, then every backward in
  reverse order; each stage keeps M microbatches' autograd graphs.
- ``1f1b`` (non-interleaved, as Megatron's): stage s runs S-1-s warm-up
  forwards, then one forward and one backward in turn, then the
  cool-down backwards; a stage keeps at most S-s graphs in flight (the
  reference keeps a ring of 2S-1 stage inputs and rematerialises the
  stage forward instead).  ``run_schedule`` checks the bound.

The tail (``tail_fn``, e.g. the final LayerNorm, the tied head and the
cross-entropy) runs once, on the last stage; its loss is the mean over
the microbatches and is broadcast over ``pipe``.  Each microbatch's
backward takes the gradients of the leaves the caller names (the
stage's parameters), summed in float32 over the microbatches as the
reference's ``gacc``; a leaf the stage does not read gets zeros.  The
caller reduces them over the mesh (``training/step.py``).

Activations go to the next stage and their gradients to the previous one
point to point (``collectives.send_recv``, gloo through host memory).  A
send and a receive between the same two stages at the same point of both
schedules are posted together (``send_forward_recv_backward`` /
``send_backward_recv_forward``), so neither neighbour waits on the
other's send: NCCL matches point-to-point operations in order on each
pair's communicator, and posting them alone in crossed order would
deadlock.

With M microbatches over S stages the bubble is (S-1)/(M+S-1) of a
stage's time under either schedule; 1F1B bounds the memory, not the
bubble.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from distributed_tensorflow_tpu_torch.parallel import collectives

# stage_fn(m, x) -> y: stage s's forward of microbatch m (x is None on
# stage 0, which reads its own input); tail_fn(m, y) -> this microbatch's
# loss on the last stage.
StageFn = Callable[[int, Optional[torch.Tensor]], torch.Tensor]
TailFn = Callable[[int, torch.Tensor], torch.Tensor]

@dataclasses.dataclass
class PipelineVJP:
    """The result of ``run_schedule``: the mean loss over the microbatches
    (the same on every stage), the float32 gradients of the given leaves
    (empty without training) and the most microbatch graphs the stage
    held at once (1F1B's bound is S - s)."""

    loss: torch.Tensor
    grads: List[torch.Tensor]
    peak_in_flight: int = 0


class _Link:
    """This rank's point-to-point links to the previous and next stage
    along ``pipe`` (the ranks with its other coordinates)."""

    def __init__(self, mesh, act_shape, act_dtype, device):
        self.mesh = mesh
        self.S, self.s = mesh.axis_size("pipe"), mesh.axis_index("pipe")
        self.group = mesh.group("pipe")
        self.prev = mesh.rank_at("pipe", self.s - 1) if self.s > 0 else None
        self.next = mesh.rank_at("pipe", self.s + 1) if self.s < self.S - 1 else None
        self.shape, self.dtype, self.device = act_shape, act_dtype, device
        self._pending: List = []  # the waits of posted sends

    def _buf(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device=self.device)

    def _post(self, sends, recvs) -> None:
        wait = collectives.send_recv(sends, recvs, self.group)
        if recvs:
            wait()  # the received tensors are needed now; the sends complete with them
            self.flush()
        else:
            self._pending.append(wait)

    def flush(self) -> None:
        for wait in self._pending:
            wait()
        self._pending.clear()

    def recv_forward(self) -> Optional[torch.Tensor]:
        if self.prev is None:
            return None
        x = self._buf()
        self._post([], [(x, self.prev)])
        return x

    def send_forward(self, y: torch.Tensor) -> None:
        if self.next is not None:
            self._post([(y.detach(), self.next)], [])

    def recv_backward(self) -> Optional[torch.Tensor]:
        if self.next is None:
            return None
        g = self._buf()
        self._post([], [(g, self.next)])
        return g

    def send_backward(self, dx: Optional[torch.Tensor]) -> None:
        if self.prev is not None:
            self._post([(dx, self.prev)], [])

    def send_forward_recv_backward(self, y: torch.Tensor) -> Optional[torch.Tensor]:
        if self.next is None:
            return None
        g = self._buf()
        self._post([(y.detach(), self.next)], [(g, self.next)])
        return g

    def send_backward_recv_forward(self, dx: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if self.prev is None:
            return None
        x = self._buf()
        self._post([(dx, self.prev)], [(x, self.prev)])
        return x


_WARMED: set = set()


def _warm_up(mesh, device) -> None:
    """One all-reduce over ``pipe`` before the group's first point-to-point
    operation: NCCL's first operation on a group must involve all of its
    ranks."""
    group = mesh.group("pipe")
    if group is not None and id(group) not in _WARMED:
        collectives.psum(torch.zeros((), device=device), mesh, "pipe")
        _WARMED.add(id(group))


def run_schedule(stage_fn: StageFn, tail_fn: TailFn, num_microbatches: int, *, mesh,
                 act_shape: Tuple[int, ...], act_dtype: torch.dtype, device,
                 params: Sequence[torch.Tensor] = (), schedule: str = "gpipe",
                 train: bool = True) -> PipelineVJP:
    """Run this rank's stage of the pipeline over ``num_microbatches``.

    With ``train``, every microbatch's forward and backward, and the
    gradients of the mean loss (the tail's loss over M) with respect to
    ``params``.  Without, the forwards alone (GPipe order), for
    evaluation.  Returns the mean loss on every stage (a float32 scalar),
    the gradients and the most graphs the stage held."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule: {schedule!r}")
    M = num_microbatches
    link = _Link(mesh, act_shape, act_dtype, device)
    S, s = link.S, link.s
    last = s == S - 1
    _warm_up(mesh, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    params = list(params)
    grads: List[Optional[torch.Tensor]] = [None] * len(params)
    live: Dict[int, Tuple[Optional[torch.Tensor], torch.Tensor]] = {}
    peak = 0

    def forward(m: int, x: Optional[torch.Tensor]) -> torch.Tensor:
        nonlocal total, peak
        if x is not None and train:
            x.requires_grad_()
        y = stage_fn(m, x)
        if last:
            y = tail_fn(m, y) / M
            total = total + y.detach().float()
        if train:
            live[m] = (x, y)
            peak = max(peak, len(live))
        return y

    def backward(m: int, g: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        x, y = live.pop(m)
        inputs = params + ([] if x is None else [x])
        got = torch.autograd.grad(y, inputs, None if last else g, allow_unused=True)
        for i, d in enumerate(got[:len(params)]):
            if d is not None:
                grads[i] = d.float() if grads[i] is None else grads[i].add_(d)
        return None if x is None else got[-1]

    if not train or schedule == "gpipe":
        for m in range(M):
            link.send_forward(forward(m, link.recv_forward()))
        if train:
            for m in reversed(range(M)):
                link.send_backward(backward(m, link.recv_backward()))
    else:
        warmup = min(S - 1 - s, M)
        for m in range(warmup):
            link.send_forward(forward(m, link.recv_forward()))
        x = link.recv_forward() if warmup < M else None
        for i in range(M - warmup):
            m_f, m_b = warmup + i, i
            g = link.send_forward_recv_backward(forward(m_f, x))
            dx = backward(m_b, g)
            if i == M - warmup - 1:
                link.send_backward(dx)
            else:
                x = link.send_backward_recv_forward(dx)
        for m in range(M - warmup, M):
            link.send_backward(backward(m, link.recv_backward()))
        if peak > S - s:
            raise AssertionError(f"1F1B held {peak} microbatch graphs on stage {s} of {S}; "
                                 f"its bound is {S - s}")
    link.flush()
    # The loss lives on the last stage: broadcast it over the axis.
    loss = collectives.psum(total if last else torch.zeros_like(total), mesh, "pipe")
    if not train:
        return PipelineVJP(loss, [], peak)
    return PipelineVJP(loss, [torch.zeros_like(p, dtype=torch.float32) if d is None else d
                              for p, d in zip(params, grads)], peak)


def auto_microbatches(batch: int, n_stages: int) -> int:
    """The largest of {4S, 2S, S} dividing the batch (bubble at most
    (S-1)/(5S-1)), as the reference's ``_auto_microbatches``."""
    for m in (4 * n_stages, 2 * n_stages, n_stages):
        if batch >= m and batch % m == 0:
            return m
    raise ValueError(f"global batch {batch} is not divisible by any of "
                     f"{{4,2,1}}x pipe={n_stages} microbatch counts")

"""ResNet-50 (v1.5) training path of the PyTorch port.

Port of ``distributed_tensorflow_tpu/models/resnet.py``.  The images
arrive NHWC, as in the reference, and are viewed as NCHW tensors in
``channels_last`` memory (the conv weights are kept ``channels_last``
too), so cuDNN runs its NHWC kernels.  Numerics follow flax:

- Convolutions in ``dtype`` (bf16), no bias.  'SAME' padding is computed
  from the input size as XLA does: at stride 2 a 3x3 kernel pads (0, 1) on
  an even size and (1, 1) on an odd one, so ``conv2`` of each first block
  is padded explicitly where the pads are asymmetric.  ``conv_init``'s
  (3, 3) and the max-pool's (1, 1) pads are symmetric.
- ``BatchNorm`` is flax's: in training the statistics of the microbatch
  over (N, H, W) in float32 (one ``native_batch_norm`` kernel normalizes
  and hands them to the running averages), the running averages updated as
  ``0.9 * ra + 0.1 * stat`` with the biased variance and kept in float32;
  the normalization computed in float32 and returned in ``norm_dtype``;
  eps 1e-5; ``bn3``'s scale starts at zero.  The running statistics are
  the module's buffers (``<layer>.mean``/``<layer>.var``, the reference's
  ``batch_stats``); a training forward returns their new values in the
  ``updates`` dict rather than writing them, so the train step threads
  them through its microbatches.
- The head: float32 mean-pool and float32 logits; label smoothing 0.1.
- Synchronised BatchNorm on a mesh whose batch axes (data x fsdp) span
  more than one rank (``make_workload(mesh=...)``): the training forward
  normalises by the global batch's mean and biased variance (flax's
  E[x^2] - E[x]^2, from one all-reduce of the per-channel sums), the
  backward all-reduces the sums of dy and dy * x_hat, and the running
  averages take the global statistics, as the reference's jit over the
  global batch computes them.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_image_classification
from distributed_tensorflow_tpu_torch.models import Workload
from distributed_tensorflow_tpu_torch.models.layers import lecun_normal_
from distributed_tensorflow_tpu_torch.parallel import collectives
from distributed_tensorflow_tpu_torch.parallel.sharding import ShardingRules
from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.training.train_state import sgd_nesterov

# uint8 staging quantization of images: u8 = clip(rint(x * 32 + 128)).
IMG_SCALE = 32.0
IMG_OFFSET = 128.0
_AUGMENT_SITE = 0x0A76  # the reference folds this into the step rng


def quantize_images(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Host-side staging transform (Workload.to_record)."""
    out = dict(batch)
    img = np.asarray(batch["image"])
    out["image"] = np.clip(np.rint(img * IMG_SCALE + IMG_OFFSET), 0, 255).astype(np.uint8)
    return out


def dequantize_images(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device-side inverse (Workload.from_record); a no-op for batches that
    never went through uint8 staging."""
    img = batch["image"]
    if img.dtype != torch.uint8:
        return batch
    out = dict(batch)
    out["image"] = (img.float() - IMG_OFFSET) * (1.0 / IMG_SCALE)
    return out


def augment_gather(img: torch.Tensor, flips: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The reference's crop and flip with its draws given: ``flips`` (B,)
    bool, ``offsets`` (B, 2) int row and column shifts.  The flip reverses
    the column index and the edge-padded crop clamps the shifted index, so
    the whole augmentation is one gather of (B, H, W, C) images."""
    B, H, W, _ = img.shape
    dev = img.device
    rows = (offsets[:, 0:1] + torch.arange(H, device=dev)[None, :]).clamp(0, H - 1)
    cols = torch.arange(W, device=dev)[None, :].expand(B, W)
    cols = torch.where(flips[:, None], W - 1 - cols, cols)
    cols = (offsets[:, 1:2] + cols).clamp(0, W - 1)
    batch_idx = torch.arange(B, device=dev)[:, None, None]
    return img[batch_idx, rows[:, :, None], cols[:, None, :]]


def augment_images(batch: Dict[str, torch.Tensor], seed: int, *, pad: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """Per-step train augmentation (Workload.augment_fn): a random
    horizontal flip and a random edge-padded crop of +-``pad`` pixels (4 at
    224), on the device, drawn from a generator seeded with the microbatch
    seed.  The draws differ from ``jax.random``'s; ``augment_gather`` is
    the same function of them."""
    img = batch["image"]
    B, H = img.shape[0], img.shape[1]
    if pad is None:
        pad = max(1, round(H / 56))
    gen = torch.Generator(device=img.device)
    gen.manual_seed(fold_in(seed, _AUGMENT_SITE))
    flips = torch.rand(B, generator=gen, device=img.device) < 0.5
    offsets = torch.randint(-pad, pad + 1, (B, 2), generator=gen, device=img.device)
    out = dict(batch)
    out["image"] = augment_gather(img, flips, offsets)
    return out


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding (low, high) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """flax ``nn.Conv(padding='SAME')`` without bias on an NCHW tensor."""
    k = weight.shape[-1]
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, stride),
                                    same_pads(x.shape[3], k, stride))
    if top == bottom and left == right:
        return F.conv2d(x, weight, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, stride=stride)


def _conv(cin: int, cout: int, k: int, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False, device=device)


_BATCH_AXES = ("data", "fsdp")


class _SyncBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the global batch of the mesh's batch shards
    (float32 statistics and arithmetic).  Returns (y in x's dtype, mean,
    biased var); the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        xf = x.float()
        dims = (0, 2, 3)
        local = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           torch.full((1,), xf.numel() / xf.shape[1], device=x.device)])
        total = collectives.psum(local, mesh, _BATCH_AXES)
        C = x.shape[1]
        count = total[-1]
        mean = total[:C] / count
        var = torch.clamp(total[C:2 * C] / count - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        y = xhat * weight.float()[:, None, None] + bias.float()[:, None, None]
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh, ctx.count = mesh, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        C = x.shape[1]
        dims = (0, 2, 3)
        gy = gy.float()
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        sum_dy, sum_dy_xhat = gy.sum(dims), (gy * xhat).sum(dims)
        total = collectives.psum(torch.cat([sum_dy, sum_dy_xhat]), ctx.mesh, _BATCH_AXES)
        mean_dy = (total[:C] / ctx.count)[:, None, None]
        mean_dy_xhat = (total[C:] / ctx.count)[:, None, None]
        gx = (gy - mean_dy - xhat * mean_dy_xhat) * (weight.float() * invstd)[:, None, None]
        # The parameters' gradients are this rank's; the train step sums them.
        return (gx.to(x.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype), None,
                None)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=norm_dtype)``
    over the channels of an NCHW tensor (see the module docstring)."""

    def __init__(self, channels: int, *, zero_scale: bool = False, device=None):
        super().__init__()
        self.eps, self.momentum = 1e-5, 0.9
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))
        self.state_name = ""  # its buffers' prefix in the model, set by the model
        self.mesh = None  # synchronised over the mesh's batch axes, set by the model

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                updates: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """Training (``updates`` given): batch statistics, and the new running
        averages into ``updates``.  Inference: the running averages."""
        if updates is None:  # flax's _normalize, in float32
            mul = torch.rsqrt(self.var + self.eps) * self.weight.float()
            y = (x.float() - self.mean[:, None, None]) * mul[:, None, None]
            return (y + self.bias.float()[:, None, None]).to(dtype)
        if self.mesh is not None and self.mesh.axis_size(_BATCH_AXES) > 1:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps, self.mesh)
            with torch.no_grad():
                m = self.momentum
                updates[f"{self.state_name}mean"] = m * self.mean + (1.0 - m) * mean
                updates[f"{self.state_name}var"] = m * self.var + (1.0 - m) * var
            return y.to(dtype)
        # Autograd differentiates through the batch statistics the kernel
        # computes, and the running averages take the same statistics (its
        # saved mean and 1/sqrt(var + eps), float32).  Float32 scale and
        # bias (flax promotes them so) keep the statistics and arithmetic in
        # float32 for a bf16 input (on the CPU bf16 ones round the mean).
        y, mean, invstd = torch.native_batch_norm(x, self.weight.float(), self.bias.float(),
                                                  None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.float().pow(-2) - self.eps  # the biased variance
            m = self.momentum
            updates[f"{self.state_name}mean"] = m * self.mean + (1.0 - m) * mean.float()
            updates[f"{self.state_name}var"] = m * self.var + (1.0 - m) * var
        return y.to(dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride here: v1.5) -> 1x1, projection shortcut where the
    shape changes."""

    def __init__(self, cin: int, filters: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, filters, 1, device)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = _conv(filters, filters, 3, device)
        self.bn2 = BatchNorm(filters, device=device)
        self.conv3 = _conv(filters, 4 * filters, 1, device)
        self.bn3 = BatchNorm(4 * filters, zero_scale=True, device=device)
        self.has_proj = cin != 4 * filters or stride != 1
        if self.has_proj:
            self.proj_conv = _conv(cin, 4 * filters, 1, device)
            self.proj_bn = BatchNorm(4 * filters, device=device)

    def forward(self, x, dt, ndt, updates):
        y = F.relu(self.bn1(conv_same(x, self.conv1.weight.to(dt), 1), ndt, updates))
        y = F.relu(self.bn2(conv_same(y, self.conv2.weight.to(dt), self.stride), ndt, updates))
        y = self.bn3(conv_same(y, self.conv3.weight.to(dt), 1), ndt, updates)
        residual = x
        if self.has_proj:
            residual = self.proj_bn(conv_same(x, self.proj_conv.weight.to(dt), self.stride),
                                    ndt, updates)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet-v1.5 with bottleneck blocks (50/101/152 by stage sizes)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.bfloat16, *, device=None, seed: int = 0,
                 mesh=None):
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.conv_init = _conv(3, num_filters, 7, device)
        self.bn_init = BatchNorm(num_filters, device=device)
        self.block_names = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, BottleneckBlock(cin, filters, 2 if i > 0 and j == 0 else 1,
                                                      device))
                self.block_names.append(name)
                cin = 4 * filters
        self.logits = nn.Linear(cin, num_classes, device=device)
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m.state_name = f"{name}."
                m.mesh = mesh
        self.to(memory_format=torch.channels_last)  # the conv weights
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """flax's initializers: lecun_normal kernels (fan_in), zero biases,
        BatchNorm scale 1 (``bn3``: 0) and bias 0, running mean 0 and var 1."""
        gen = torch.Generator(device=self.logits.weight.device)
        gen.manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, math.prod(m.weight.shape[1:]), gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, image: torch.Tensor, train: bool = False,
                updates: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """(B, H, W, 3) NHWC images -> (B, num_classes) float32 logits.  With
        ``train`` the BatchNorms use batch statistics and write their new
        running averages into ``updates``."""
        if train and updates is None:
            raise ValueError("a training forward needs an updates dict for the running stats")
        upd = updates if train else None
        dt, ndt = self.dtype, self.norm_dtype
        x = image.to(dt).permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        x = F.conv2d(x, self.conv_init.weight.to(dt), stride=2, padding=3)
        x = F.relu(self.bn_init(x, ndt, upd))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, dt, ndt, upd)
        x = x.float().mean(dim=(2, 3))
        return F.linear(x, self.logits.weight.float(), self.logits.bias.float())


def _loss_fn(module: ResNet, label_smoothing: float, params, model_state, batch, seed):
    """(loss, {"accuracy"}, new model state): a training forward."""
    updates: Dict[str, torch.Tensor] = {}
    logits = torch.func.functional_call(module, {**params, **model_state}, (batch["image"],),
                                        {"train": True, "updates": updates})
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels, label_smoothing=label_smoothing)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}, updates


def _eval_loss_fn(module: ResNet, params, model_state, batch, seed):
    """Inference mode: BatchNorm uses the running averages; no smoothing."""
    logits = torch.func.functional_call(module, {**params, **model_state}, (batch["image"],))
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}, model_state


def make_workload(*, batch_size: int = 1024, num_classes: int = 1000, image_size: int = 224,
                  stage_sizes: Sequence[int] = (3, 4, 6, 3), learning_rate: float = 0.1,
                  augment: bool = True, device="cuda", mesh=None,
                  **_unused) -> Workload:
    """``learning_rate`` is scaled by batch/256 (the classic recipe);
    ``augment`` turns the per-step crop and flip on (the recipe)."""
    module = ResNet(stage_sizes=tuple(stage_sizes), num_classes=num_classes, device=device,
                    mesh=mesh)
    shape = (image_size, image_size, 3)
    return Workload(
        name="resnet50",
        module=module,
        loss_fn=functools.partial(_loss_fn, module, 0.1),
        init_batch={"image": np.zeros((2, *shape), np.float32),
                    "label": np.zeros((2,), np.int32)},
        data_fn=lambda per_host_bs: synthetic_image_classification(
            batch_size=per_host_bs, image_size=shape, num_classes=num_classes),
        eval_data_fn=lambda per_host_bs: synthetic_image_classification(
            batch_size=per_host_bs, image_size=shape, num_classes=num_classes, holdout=True),
        batch_size=batch_size,
        learning_rate=learning_rate * batch_size / 256,
        warmup_steps=500,
        clip_grad_norm=None,
        example_key="image",
        stateful=True,
        eval_loss_fn=functools.partial(_eval_loss_fn, module),
        make_optimizer=sgd_nesterov,
        to_record=quantize_images,
        from_record=dequantize_images,
        augment_fn=augment_images if augment else None,
        rules=ShardingRules(),  # every parameter replicated, as the reference's
        mesh=mesh,
    )

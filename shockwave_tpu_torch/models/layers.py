"""Flax's layers, in PyTorch, for the convolutional and recurrent families.

The JAX package's ResNet, A3C and CycleGAN are written with
``flax.linen`` (NHWC, ``'SAME'`` padding, flax's BatchNorm and
``ConvTranspose``). The port runs NCHW and reproduces what those layers
compute:

- ``'SAME'`` padding is XLA's rule: the output is ``ceil(n / stride)``
  and the padding it needs is split with the odd element at the end, so
  a stride-2 3x3 conv on an even input pads (0, 1), not torch's (1, 1)
  (``same_pads``, ``SameConv2d``).
- ``ConvTranspose(..., padding='SAME')`` is ``lax.conv_transpose``: the
  input dilated by the stride, padded by lax's ``'SAME'`` rule, and
  correlated with the kernel as stored (no flip). ``SameConvTranspose2d``
  keeps flax's kernel unflipped and runs ``conv_transpose2d`` on its
  flip, then crops what torch's symmetric padding adds.
- BatchNorm takes the batch's biased variance ``E[x^2] - E[x]^2`` (clipped
  at 0) for both the normalisation and the running variance, with
  momentum 0.99 on the old value (torch keeps the unbiased variance and
  weights the new batch by its momentum).
- Initialisers follow flax's distributions, drawn from an explicit
  ``torch.Generator``: LeCun normal (truncated at two deviations) for
  conv and dense kernels, zero biases, normal(1 / sqrt(features)) for
  embeddings, orthogonal for the LSTM's hidden kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_LECUN_TRUNC = 0.87962566103423978  # stddev of a unit normal cut at +-2
BN_MOMENTUM = 0.99  # flax.linen.BatchNorm's defaults
BN_EPS = 1e-5


def same_pads(n: int, kernel: int, stride: int) -> tuple:
    """XLA's ``'SAME'`` padding (lo, hi) of one spatial dimension."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``flax.linen.Conv(features, (k, k), (s, s))``, NCHW: the weight is
    [out, in, k, k] (flax's HWIO kernel transposed)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride, 0,
                         bias=bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        (ht, hb), (wl, wr) = (same_pads(x.shape[-2], k, s),
                              same_pads(x.shape[-1], k, s))
        if ht == hb and wl == wr:
            return F.conv2d(x, self.weight, self.bias, s, (ht, wl))
        return F.conv2d(F.pad(x, (wl, wr, ht, hb)), self.weight, self.bias, s)


def _transpose_pads(kernel: int, stride: int) -> tuple:
    """``lax.conv_transpose``'s ``'SAME'`` padding of the dilated input."""
    pad_len = kernel + stride - 2
    lo = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return lo, pad_len - lo


class SameConvTranspose2d(nn.Module):
    """``flax.linen.ConvTranspose(features, (k, k), (s, s))`` (padding
    ``'SAME'``, ``transpose_kernel=False``), NCHW. ``weight`` is flax's
    kernel [k, k, in, out] as [in, out, k, k], unflipped; the output is
    ``n * s`` on an input of ``n``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x):
        k, s = self.kernel, self.stride
        lo, hi = _transpose_pads(k, s)
        # conv_transpose2d(w) correlates the dilated input, padded k-1-p on
        # both sides (output_padding more at the end), with w flipped; lo
        # is at most k-1 under lax's rule.
        out_h, out_w = ((n - 1) * s + 1 + lo + hi - k + 1 for n in x.shape[-2:])
        y = F.conv_transpose2d(x, self.weight.flip(2, 3), self.bias, s,
                               padding=k - 1 - lo,
                               output_padding=max(hi - lo, 0))
        return y[..., :out_h, :out_w]


class _RankMean(torch.autograd.Function):
    """A tensor's mean over the default process group's ranks; the
    gradient flows back to every rank's input as the ranks' mean."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y)
        return y / dist.get_world_size()

    @staticmethod
    def backward(ctx, grad):
        return _RankMean.apply(grad)


class FlaxBatchNorm2d(nn.Module):
    """``flax.linen.BatchNorm`` over NCHW channels: scale ``weight``, shift
    ``bias``, and the running ``running_mean`` / ``running_var`` that
    flax keeps in ``batch_stats``. In training mode it normalises with
    the batch's mean and biased variance and moves the running statistics
    by ``momentum`` (the old value's weight). With ``global_batch`` set
    (a gang's ranks, each holding an equal shard of the batch) the mean
    and the mean square are averaged over the default process group, with
    their gradients, as XLA reduces them over a global batch."""

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.global_batch = False

    def forward(self, x):
        if self.training:
            moments = torch.stack([x.mean(dim=(0, 2, 3)),
                                   (x * x).mean(dim=(0, 2, 3))])
            if self.global_batch:
                moments = _RankMean.apply(moments)
            mean, mean_sq = moments
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal of variance 1 / fan_in cut at two
    deviations (rescaled so the cut keeps that variance)."""
    std = math.sqrt(1.0 / fan_in) / _LECUN_TRUNC
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


@torch.no_grad()
def reset_flax_parameters(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Draw every parameter of ``model`` from flax's default initialisers,
    module by module in registration order."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            lecun_normal_(module.weight, fan_in, generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, SameConvTranspose2d):
            fan_in = module.weight.shape[0] * module.kernel ** 2
            lecun_normal_(module.weight, fan_in, generator)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Embedding):
            nn.init.normal_(module.weight,
                            std=math.sqrt(1.0 / module.embedding_dim),
                            generator=generator)
        elif isinstance(module, nn.LSTM):
            # flax's OptimizedLSTMCell: LeCun input kernels (no bias), an
            # orthogonal hidden kernel a gate, one zero bias a gate.
            hidden = module.hidden_size
            for gate in range(4):
                rows = slice(gate * hidden, (gate + 1) * hidden)
                lecun_normal_(module.weight_ih_l0[rows], module.input_size,
                              generator)
                nn.init.orthogonal_(module.weight_hh_l0[rows],
                                    generator=generator)
            nn.init.zeros_(module.bias_ih_l0)
            nn.init.zeros_(module.bias_hh_l0)

"""Building blocks of both families (counterpart of awm_tpu/models/layers.py).

Modules work in PyTorch's (B, C, T) layout, except the LSTM, which takes
(B, T, D) like the kernel it launches.  Parameter names follow torch
(``weight``, ``bias``, ``running_mean``, ``running_var``); the LSTM keeps
the JAX package's ``w_ih``, ``w_hh`` and one summed ``b``.  Initialisers
match torch's defaults, as the JAX modules' do; serving loads trained
weights through awm_tpu_torch/checkpoint.py.

Mixed precision, as the flax modules' ``dtype``: a conv or BatchNorm whose
``compute_dtype`` is set (models.set_compute_dtype) casts its input and a
view of its weights to that dtype at the op, while the parameters, the BN
statistics and the LSTM's state stay fp32.  With ``compute_dtype`` None
(the default, and what serving uses) a module computes in the dtype of its
parameters, so casting the whole module casts the computation.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from awm_tpu_torch.ops import conv1d, conv_transpose1d, lstm_fused_forward
from awm_tpu_torch.parallel.collectives import all_reduce_, replicated_sum, sum_over_ranks


def _uniform_(t: torch.Tensor, fan_in: int) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(t, -bound, bound)


def _at(dtype, *tensors):
    """The tensors cast to the compute dtype (None keeps them)."""
    if dtype is None:
        return tensors
    return tuple(None if t is None else t.to(dtype) for t in tensors)


class Conv1d(nn.Module):
    """torch.nn.Conv1d over (B, C, T); weight (out, in, k)."""

    compute_dtype = None

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        fan_in = in_ch * kernel_size
        _uniform_(self.weight, fan_in)
        if self.bias is not None:
            _uniform_(self.bias, fan_in)

    def forward(self, x):
        x, w, b = _at(self.compute_dtype, x, self.weight, self.bias)
        return conv1d(x, w, b, stride=self.stride, padding=self.padding, dilation=self.dilation)


class ConvTranspose1d(nn.Module):
    """torch.nn.ConvTranspose1d over (B, C, T); weight (in, out, k)."""

    compute_dtype = None

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, output_padding: int = 0):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))
        fan_in = out_ch * kernel_size  # torch's fan_in for a (in, out, k) weight
        _uniform_(self.weight, fan_in)
        _uniform_(self.bias, fan_in)

    def forward(self, x):
        x, w, b = _at(self.compute_dtype, x, self.weight, self.bias)
        return conv_transpose1d(x, w, b, stride=self.stride, padding=self.padding,
                                output_padding=self.output_padding)


# Values of one fp32 temporary of BatchNorm's backward: it runs over slabs of
# channels of this many values each (xhat, dy, dx), so that its memory does not
# grow with the batch (at the base preset's bf16 B=256 a whole fp32 copy of
# one detector activation is 1 GiB).
BN_SLAB_ELEMS = 2**25


def _train_stats(xf: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, E[x^2], count) of fp32 xf (B, C, T) over (B, T), the group's
    rows where group is set (each rank's sums, summed differentiably)."""
    if group is None:
        return xf.mean(dim=(0, 2)), xf.square().mean(dim=(0, 2)), xf.new_full((), xf.numel() / xf.shape[1])
    c = xf.shape[1]
    sums = sum_over_ranks(torch.cat([xf.sum(dim=(0, 2)), xf.square().sum(dim=(0, 2)),
                                     xf.new_full((1,), xf.numel() / c)]), group)
    return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1], sums[-1]


def _affine(xf: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(xf - mean) mul + bias over the channel axis of fp32 (B, C, T)."""
    return (xf - mean[:, None]) * mul[:, None] + bias.to(torch.float32)[:, None]


def batch_norm_train_plain(x, weight, bias, running_mean, running_var, eps, group, out_dtype):
    """Train-mode BatchNorm as one composite of torch ops (the plain version
    of _BatchNormTrain, which the tests compare against): autograd saves its
    fp32 copy of x and its fp32 output beside x."""
    xf = x.to(torch.float32)
    mean, sq, _ = _train_stats(xf, group)
    var = torch.clamp(sq - mean.square(), min=0.0)
    with torch.no_grad():
        running_mean.copy_(0.9 * running_mean + 0.1 * mean)
        running_var.copy_(0.9 * running_var + 0.1 * var)
    return _affine(xf, mean, torch.rsqrt(var + eps) * weight.to(torch.float32), bias).to(out_dtype)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm with its own backward.  The forward is
    batch_norm_train_plain's arithmetic; it saves x in its own dtype and, per
    channel, the fp32 mean, rsqrt(var + eps) and whether the variance was
    clamped at 0.  The backward recomputes xhat = (x - mean) rsqrt(var + eps)
    in fp32 a slab of channels at a time and takes, with N the rows the
    statistics ran over (the group's), dbias = sum dy, dweight = sum dy xhat
    and dx = w rsqrt(var + eps) (dy - sum(dy) / N - xhat sum(dy xhat) / N), the
    xhat term dropped where the variance was clamped (its gradient is 0
    there, as torch.clamp's).  Under a group the two sums in dx are the
    group's (one all-reduce, as the composite's backward through
    sum_over_ranks), dweight and dbias this rank's own."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, group, out_dtype):
        xf = x.to(torch.float32)
        mean, sq, count = _train_stats(xf, group)
        raw = sq - mean.square()
        var = torch.clamp(raw, min=0.0)
        running_mean.copy_(0.9 * running_mean + 0.1 * mean)
        running_var.copy_(0.9 * running_var + 0.1 * var)
        inv = torch.rsqrt(var + eps)
        ctx.group = group
        ctx.save_for_backward(x, weight, mean, inv, count, raw >= 0)
        return _affine(xf, mean, inv * weight.to(torch.float32), bias).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, inv, count, kept = ctx.saved_tensors
        c = x.shape[1]
        step = max(1, BN_SLAB_ELEMS // max(1, x.numel() // c))
        slabs = [slice(c0, min(c, c0 + step)) for c0 in range(0, c, step)]
        mul, f32 = inv * weight.to(torch.float32), torch.float32
        sums = torch.empty(2, c, dtype=f32, device=x.device)  # sum dy, sum dy xhat (this rank's)
        dx = torch.empty_like(x)

        def operands(s):
            xh = (x[:, s].to(f32) - mean[s, None]) * inv[s, None]
            return xh, dy[:, s].to(f32)

        def dx_of(s, xh, dyf, tot):
            dx[:, s] = (mul[s, None] * (dyf - tot[0, s, None] / count
                                        - xh * (tot[1, s, None] / count * kept[s, None]))).to(x.dtype)

        for s in slabs:
            xh, dyf = operands(s)
            sums[0, s], sums[1, s] = dyf.sum(dim=(0, 2)), (dyf * xh).sum(dim=(0, 2))
            if ctx.group is None:
                dx_of(s, xh, dyf, sums)
        if ctx.group is not None:
            tot = all_reduce_(sums.clone(), ctx.group)
            for s in slabs:
                dx_of(s, *operands(s), tot)
        return dx, sums[1].to(weight.dtype), sums[0].to(weight.dtype), None, None, None, None, None


class BatchNorm(nn.Module):
    """BatchNorm1d over the channel axis of (B, C, T), the flax way
    (awm_tpu/models/layers.py:99-148, flax.linen.BatchNorm).

    Train mode normalises with the batch statistics over (B, T), computed in
    fp32 whatever the input dtype, with flax's fast biased variance
    max(0, E[x^2] - E[x]^2), and updates the running statistics as
    ra = 0.9 * ra + 0.1 * batch, with that biased variance (torch's own
    BatchNorm uses the unbiased one there).  It runs as _BatchNormTrain,
    which saves x and per-channel statistics only (no fp32 copy of x or of
    the output, as XLA saves none for the reference's).  Eval mode
    normalises with the running statistics.

    Under a mesh (parallel.shard_state sets ``group`` to the data group) the
    train-mode statistics are those of the group's union of rows: each rank's
    (sum x, sum x^2, count) summed over the group, differentiably, as a
    BatchNorm in a jitted step on sharded inputs normalises by the global
    batch.  torch.nn.SyncBatchNorm would keep the unbiased variance."""

    compute_dtype = None
    group = None

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if self.training:
            return _BatchNormTrain.apply(x, self.weight, self.bias, self.running_mean, self.running_var, self.eps,
                                         self.group, self.compute_dtype or x.dtype)
        if self.compute_dtype is None:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight.to(torch.float32)
        return _affine(x.to(torch.float32), self.running_mean, mul, self.bias).to(self.compute_dtype)


class ResBlock(nn.Module):
    """Conv-BN-ReLU-Conv-BN + skip, ReLU (ref: py/main14.py:74-87)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = Conv1d(ch, ch, 3, padding=1)
        self.bn1 = BatchNorm(ch)
        self.conv2 = Conv1d(ch, ch, 3, padding=1)
        self.bn2 = BatchNorm(ch)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(x.to(y.dtype) + y)


class StridedResBlock(nn.Module):
    """main14b_2 residual block: strided conv + ELU + conv, a 1x1 strided
    skip conv when the shape changes, ELU of the sum; no BatchNorm
    (ref: py/main14b_2.py:86-103)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv1d(in_ch, features, 3, stride=stride, padding=1)
        self.conv2 = Conv1d(features, features, 3, padding=1)
        downsample = stride != 1 or in_ch != features
        self.skip = Conv1d(in_ch, features, 1, stride=stride) if downsample else None

    def forward(self, x):
        y = self.conv2(F.elu(self.conv1(x)))
        res = x if self.skip is None else self.skip(x)
        return F.elu(y + res.to(y.dtype))


class LSTM(nn.Module):
    """Single-layer torch-layout LSTM over (B, T, D) -> (B, T, H).

    Routes through ops/lstm_kernel.py::lstm_fused_forward: under grad the
    autograd Function with the training forward and backward kernels, else
    the inference kernel; the plain versions on the CPU.  It computes in its
    input's dtype (bf16 x: bf16 operands, fp32 state), so it has no
    compute_dtype of its own.
    """

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(4 * hidden, input_size))
        self.w_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))
        _uniform_(self.w_ih, hidden)
        _uniform_(self.w_hh, hidden)
        # one stored bias = b_ih + b_hh: the sum of two U(+-1/sqrt(H)) draws
        with torch.no_grad():
            bound = 1.0 / math.sqrt(hidden)
            self.b.copy_(torch.empty(4 * hidden).uniform_(-bound, bound)
                         + torch.empty(4 * hidden).uniform_(-bound, bound))

    def forward(self, x):
        return lstm_fused_forward(x.contiguous(), self.w_ih, self.w_hh, self.b)


class Embedding(nn.Module):
    """torch.nn.Embedding(num, dim) with N(0, 1) init, indexed by the
    integer message (ref: py/main14.py:103,118-121).

    Vocab-parallel under a mesh whose model axis cuts the table
    (parallel.shard_state): ``weight`` holds the rows from ``vocab_start``
    on, a message outside them looks up zeros, and the lookup is summed over
    ``group`` (the model group), whose ranks all compute the same loss from
    it, so the backward leaves the gradient as it is."""

    group = None
    vocab_start = 0

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(num, dim))

    def forward(self, idx):
        if self.group is None:
            return F.embedding(idx, self.weight)
        local = idx - self.vocab_start
        mine = (local >= 0) & (local < self.weight.shape[0])
        part = F.embedding(torch.where(mine, local, torch.zeros_like(local)), self.weight)
        return replicated_sum(part * mine[..., None].to(part.dtype), self.group)

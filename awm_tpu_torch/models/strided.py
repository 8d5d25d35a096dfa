"""The main14b_2 strided family (counterpart of awm_tpu/models/strided.py).

Generator (ref: py/main14b_2.py:105-178): Conv(1->32, k7) -> 4 strided
residual blocks doubling the channels 32 -> 512 with strides (2, 4, 5, 8)
(T 16000 -> 50) -> Linear proj to hidden 32 -> + the message embedding
(added BEFORE the LSTMs, unlike main14) -> 2 stacked LSTM(32) -> Conv(32 ->
128, k7) -> 4 x [ConvTranspose(k=2s, stride s, pad s//2) + residual block]
halving the channels -> Conv(-> 1, k7), padded or trimmed to the input
length.

Detector (ref: py/main14b_2.py:180-224): the same strided encoder, the
mirrored ConvTranspose upsampler and Conv(32 -> 1 + bits, k7); it returns
(B, T, 1 + bits) logits like the base Detector.

The modules work in (B, C, T) and carry the flax modules' names
(``init_conv``, ``enc{i}``, ``proj``, ``embedding``, ``lstm{i}``,
``final_conv_enc``, ``dec_up{i}``, ``dec_res{i}``, ``final_conv_dec``;
``up{i}``, ``up_res{i}``, ``final_conv``), so checkpoint.variables_from_flax
maps a JAX tree onto them.  The family has no BatchNorm.  This
configuration collapsed in the reference's run (BASELINE.md); it is kept as
the reference's architecture exploration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from awm_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    Embedding,
    LSTM,
    StridedResBlock,
    _at,
    _uniform_,
)


def _pad_or_trim(x: torch.Tensor, t: int) -> torch.Tensor:
    """The last axis cut or zero-padded to t, as the reference trims and pads
    its output (ref: py/main14b_2.py:171-177, 217-222)."""
    cur = x.shape[-1]
    if cur > t:
        return x[..., :t]
    if cur < t:
        return F.pad(x, (0, t - cur))
    return x


class Linear(nn.Module):
    """torch.nn.Linear over the last axis with the flax Linear's compute
    dtype: x, weight and bias cast to compute_dtype (when set), the result in
    that dtype.  Weight (out, in); flax keeps its transpose (in, out)."""

    compute_dtype = None

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        _uniform_(self.weight, in_features)
        _uniform_(self.bias, in_features)

    def forward(self, x):
        return F.linear(*_at(self.compute_dtype, x, self.weight, self.bias))


def _encoder(net: nn.Module, base_channels: int, strides: Tuple[int, ...]) -> int:
    """init_conv and the strided blocks enc0.. on net; returns their width."""
    net.init_conv = Conv1d(1, base_channels, 7, padding=3)
    ch = base_channels
    for i, st in enumerate(strides):
        setattr(net, f"enc{i}", StridedResBlock(ch, 2 * ch, stride=st))
        ch *= 2
    return ch


def _upsampler(net: nn.Module, in_ch: int, strides: Tuple[int, ...], up: str, res: str) -> int:
    """ConvTranspose + residual block pairs up{i} / res{i}, halving the
    channels, the strides reversed; returns their output width."""
    for i, st in enumerate(reversed(strides)):
        setattr(net, f"{up}{i}", ConvTranspose1d(in_ch, in_ch // 2, 2 * st, stride=st, padding=st // 2))
        setattr(net, f"{res}{i}", StridedResBlock(in_ch // 2, in_ch // 2))
        in_ch //= 2
    return in_ch


class StridedGenerator(nn.Module):
    """(B, T) waveform + (B,) integer message -> (B, T) delta, in the dtype
    of the module's parameters (or its compute dtype).  The LSTMs compute in
    their input's dtype: proj's, bf16 under bf16 compute."""

    def __init__(self, message_bits: int = 16, base_channels: int = 32, hidden_dim: int = 32,
                 output_channels: int = 128, strides: Tuple[int, ...] = (2, 4, 5, 8),
                 lstm_layers: int = 2):
        super().__init__()
        self.message_bits, self.strides, self.lstm_layers = message_bits, tuple(strides), lstm_layers
        ch = _encoder(self, base_channels, self.strides)
        self.proj = Linear(ch, hidden_dim)
        if message_bits > 0:
            self.embedding = Embedding(2**message_bits, hidden_dim)
        for i in range(lstm_layers):
            setattr(self, f"lstm{i}", LSTM(hidden_dim, hidden_dim))
        self.final_conv_enc = Conv1d(hidden_dim, output_channels, 7, padding=3)
        ch = _upsampler(self, output_channels, self.strides, "dec_up", "dec_res")
        self.final_conv_dec = Conv1d(ch, 1, 7, padding=3)

    def forward(self, s: torch.Tensor, message: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = s.shape[-1]
        x = self.init_conv(s[:, None, :])
        for i in range(len(self.strides)):
            x = getattr(self, f"enc{i}")(x)
        x = self.proj(x.transpose(1, 2))  # (B, T', hidden)
        if self.message_bits > 0 and message is not None:
            x = x + self.embedding(message)[:, None, :].to(x.dtype)
        for i in range(self.lstm_layers):
            x = getattr(self, f"lstm{i}")(x)
        x = self.final_conv_enc(x.transpose(1, 2))
        for i in range(len(self.strides)):
            x = getattr(self, f"dec_res{i}")(getattr(self, f"dec_up{i}")(x))
        return _pad_or_trim(self.final_conv_dec(x), t)[:, 0, :]


class StridedDetector(nn.Module):
    """(B, T) waveform -> (B, T, 1 + message_bits) logits (a transposed view
    of the (B, C, T) result)."""

    def __init__(self, message_bits: int = 16, base_channels: int = 32,
                 strides: Tuple[int, ...] = (2, 4, 5, 8)):
        super().__init__()
        self.strides = tuple(strides)
        ch = _encoder(self, base_channels, self.strides)
        ch = _upsampler(self, ch, self.strides, "up", "up_res")
        self.final_conv = Conv1d(ch, 1 + message_bits, 7, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[-1]
        h = self.init_conv(x[:, None, :])
        for i in range(len(self.strides)):
            h = getattr(self, f"enc{i}")(h)
        for i in range(len(self.strides)):
            h = getattr(self, f"up_res{i}")(getattr(self, f"up{i}")(h))
        return _pad_or_trim(self.final_conv(h), t).transpose(1, 2)

"""The watermarking loss stack (counterpart of awm_tpu/losses.py:35-185).

Terms, each as the JAX package defines it:
- loc: BCE-with-logits of the per-sample detection logits of the
  [watermarked; clean] 2B batch against [ones; zeros];
- dec: BCE of the watermarked half's bit logits against the message bits,
  per sample ("per_sample") or on the time-mean logit ("mean", optionally
  re-weighted per bit position by ``bit_balance``);
- l1: mean |delta|;
- mel: L1 between log-mel of clean and watermarked, one term per
  (n_fft, hop) scale, averaged;
- loud: masked squared STFT-magnitude difference (window 2048, hop 512);
- hf: mean |STFT(delta)| above a cutoff (only when its weight is > 0).
Every reduction is fp32, whatever the models' compute dtype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from awm_tpu_torch.config import LossConfig
from awm_tpu_torch.dsp.stft import log_mel, spectrogram, stft
from awm_tpu_torch.models.messages import message_to_bits
from awm_tpu_torch.parallel.collectives import mean_over_ranks


def bce_with_logits_per(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Element-wise, numerically stable BCE with logits (no reduction)."""
    z = logits.to(torch.float32)
    y = targets.to(torch.float32)
    return torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return bce_with_logits_per(logits, targets).mean()


def loc_loss(detection_logits: torch.Tensor) -> torch.Tensor:
    """Detection BCE over (2B, T): first half target 1, second half 0."""
    b = detection_logits.shape[0] // 2
    targets = torch.zeros_like(detection_logits, dtype=torch.float32)
    targets[:b] = 1.0
    return bce_with_logits(detection_logits, targets)


def dec_loss(
    decode_logits: torch.Tensor,
    message: torch.Tensor,
    bits: int = 16,
    mode: str = "per_sample",
    bit_balance: float = 0.0,
    group=None,
) -> torch.Tensor:
    """Bit-decode BCE on the watermarked half, decode_logits (B, T, bits).

    "mean" takes the BCE of the time-mean logit (the statistic detection
    thresholds); bit_balance > 0 weights each bit position by (its batch BCE
    / the mean over positions) ** bit_balance, the weights detached and
    normalised to mean 1.  "per_sample" expands the target over all T.
    group: the data group of a mesh, whose ranks hold equal shares of the
    batch; the per-bit BCE that sets the weights is then the group's mean,
    the global batch's."""
    target = message_to_bits(message, bits)  # (B, bits)
    if mode == "mean":
        per = bce_with_logits_per(decode_logits.to(torch.float32).mean(dim=1), target)
        if bit_balance > 0.0:
            per_bit = mean_over_ranks(per.mean(dim=0), group)
            w = (per_bit / (per_bit.mean() + 1e-8)) ** bit_balance
            w = (w / (w.mean() + 1e-8)).detach()
            return (per * w).mean()
        return per.mean()
    if mode != "per_sample":
        raise ValueError(f"dec_loss mode must be 'per_sample' or 'mean', got {mode!r}")
    return bce_with_logits(decode_logits, target[:, None, :].expand(decode_logits.shape))


def l1_delta_loss(delta: torch.Tensor) -> torch.Tensor:
    return delta.abs().mean()


def mel_l1_loss(clean: torch.Tensor, watermarked: torch.Tensor, *, scales=((1024, 256),)) -> torch.Tensor:
    """Mean over scales of the L1 of the log-mel difference."""
    total = 0.0
    for n_fft, hop in scales:
        total = total + (log_mel(clean, n_fft=n_fft, hop=hop)
                         - log_mel(watermarked, n_fft=n_fft, hop=hop)).abs().mean()
    return total / len(scales)


def tf_loudness_loss(clean: torch.Tensor, watermarked: torch.Tensor) -> torch.Tensor:
    """Masked TF loudness loss, window 2048 hop 512."""
    sc = stft(clean.to(torch.float32), 2048, 512).abs()
    sw = stft(watermarked.to(torch.float32), 2048, 512).abs()
    mask = (sc > 0.01).to(torch.float32)
    return ((sw - sc).square() * mask).mean()


def high_freq_penalty(
    delta: torch.Tensor, cutoff_hz: float = 3500.0, n_fft: int = 512, sample_rate: int = 16000
) -> torch.Tensor:
    """Mean |STFT(delta)| above the cutoff."""
    spec = torch.sqrt(spectrogram(delta, n_fft, n_fft // 4) + 1e-12)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    mask = torch.from_numpy((freqs > cutoff_hz).astype(np.float32)).to(spec.device)
    return (spec * mask).mean()


def total_loss(
    cfg: LossConfig,
    *,
    s: torch.Tensor,
    s_w: torch.Tensor,
    delta: torch.Tensor,
    logits: torch.Tensor,
    message: torch.Tensor,
    message_bits: int = 16,
    group=None,
) -> Dict[str, torch.Tensor]:
    """Weighted sum and per-term dict.  logits: (2B, T, 1+bits) of the
    detector over cat([s_w, s]).  Under a mesh each term is this rank's
    mean over its rows, and group (the data group) only reaches dec_loss's
    bit weights; the caller averages the terms over the group."""
    b = s.shape[0]
    terms = {
        "loc": loc_loss(logits[:, :, 0]),
        "dec": dec_loss(logits[:b, :, 1:], message, message_bits,
                        mode=cfg.dec_loss_mode, bit_balance=cfg.dec_bit_balance, group=group),
        "l1": l1_delta_loss(delta),
        "mel": mel_l1_loss(s, s_w, scales=cfg.mel_scales),
        "loud": tf_loudness_loss(s, s_w),
    }
    total = (
        cfg.lambda_l1 * terms["l1"]
        + cfg.lambda_msspec * terms["mel"]
        + cfg.lambda_loud * terms["loud"]
        + cfg.lambda_loc * terms["loc"]
        + cfg.lambda_dec * terms["dec"]
    )
    if cfg.hf_penalty_w > 0.0:
        terms["hf"] = high_freq_penalty(delta, cfg.hf_cutoff_hz, cfg.hf_n_fft)
        total = total + cfg.hf_penalty_w * terms["hf"]
    terms["total"] = total
    return terms


def term_keys(cfg: LossConfig) -> tuple:
    """The keys total_loss returns under this config."""
    keys = ("loc", "dec", "l1", "mel", "loud")
    if cfg.hf_penalty_w > 0.0:
        keys = keys + ("hf",)
    return keys + ("total",)

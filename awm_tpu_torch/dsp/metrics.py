"""Signal metrics: SI-SNR, RMS, power ratio, int16 quantisation (counterpart
of awm_tpu/dsp/metrics.py:14-48; the definitions are the reference's, so the
quality numbers compare directly)."""

from __future__ import annotations

import torch


def si_snr(s: torch.Tensor, s_hat: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB over the last axis, mean over the leading
    axes: mean-centre, project s_hat onto s, ratio of target to residual
    energy (ref: py/main14.py:650-659)."""
    s = s - s.mean(dim=-1, keepdim=True)
    s_hat = s_hat - s_hat.mean(dim=-1, keepdim=True)
    dot = (s * s_hat).sum(dim=-1, keepdim=True)
    norm_s = (s * s).sum(dim=-1, keepdim=True)
    s_target = dot / (norm_s + eps) * s
    e_noise = s_hat - s_target
    ratio = (s_target * s_target).sum(dim=-1) / ((e_noise * e_noise).sum(dim=-1) + eps)
    return (10.0 * torch.log10(ratio)).mean()


def rms(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Root-mean-square; axis=None reduces everything (file-level RMS)."""
    sq = x.square()
    return torch.sqrt(sq.mean() if axis is None else sq.mean(dim=axis))


def power_ratio_db(signal: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """10 log10(P_signal / P_delta) (ref: py/main14.py:789-791)."""
    return 10.0 * torch.log10(signal.square().mean() / delta.square().mean())


def quantize_int16(x: torch.Tensor) -> torch.Tensor:
    """int16 round trip round(x * 32767) / 32767, ties to even.  The
    gradient of round() is zero, as in the reference's fine-tune graph
    (ref: main15c.ipynb cell 4): training relies on the surrounding terms.
    The divisor is a tensor: by a Python scalar the card multiplies by the
    reciprocal, which is an ulp off the true quotient on some samples."""
    scale = x.new_full((), 32767.0)
    return torch.round(x * scale) / scale

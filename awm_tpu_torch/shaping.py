"""Delta-shaping chain of main16 and the channel step (counterpart of
awm_tpu/shaping.py:16-53)."""

from __future__ import annotations

import torch

from awm_tpu_torch.config import ShapingConfig
from awm_tpu_torch.dsp import fir_lowpass, lowpass_biquad, quantize_int16


def clamp_peak(delta: torch.Tensor, thr: float = 0.02) -> torch.Tensor:
    """delta.clamp(-thr, thr) (ref: py/main16.py:66-67)."""
    return delta.clamp(-thr, thr)


def limit_rms(delta: torch.Tensor, max_rms: float = 0.005, eps: float = 1e-8) -> torch.Tensor:
    """Per-example RMS cap: gain = min(max_rms / rms, 1) over all but the
    batch axis (ref: py/main16.py:69-72)."""
    axes = tuple(range(1, delta.dim()))
    cur = torch.sqrt(delta.square().mean(dim=axes, keepdim=True) + eps)
    return delta * torch.clamp(max_rms / cur, max=1.0)


def shape_delta(delta: torch.Tensor, cfg: ShapingConfig, sample_rate: int = 16000) -> torch.Tensor:
    """fir_lowpass -> clamp_peak -> limit_rms (ref: py/main16.py:244-247)."""
    if not cfg.enabled:
        return delta
    d = fir_lowpass(delta, cfg.fir_cutoff_hz, cfg.fir_taps, sample_rate)
    d = clamp_peak(d, cfg.clamp_thr)
    return limit_rms(d, cfg.max_rms)


def perceptual_postprocess(s_w: torch.Tensor, cutoff_hz: float = 7000.0,
                           sample_rate: int = 16000) -> torch.Tensor:
    """Channel simulation of main15c: 7 kHz biquad lowpass, then the int16
    round trip, on the watermarked signal inside the training graph
    (ref: main15c.ipynb cell 4)."""
    return quantize_int16(lowpass_biquad(s_w, sample_rate, cutoff_hz))


def apply_channel(s_w: torch.Tensor, cfg: ShapingConfig, sample_rate: int = 16000) -> torch.Tensor:
    """The channel between embedding and detection in training: identity
    unless cfg.postprocess."""
    if not cfg.postprocess:
        return s_w
    return perceptual_postprocess(s_w, cfg.postprocess_cutoff_hz, sample_rate)

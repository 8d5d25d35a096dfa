"""Channel attacks for robust training and evaluation: noise, volume,
resample round trip, lowpass, int16 quantisation, G.711 mu-law (counterpart
of awm_tpu/augment.py:22-172).

Every transform is a tensor op on the caller's device, differentiable where
that means something, with static shapes, so the chain runs inside the train
step.  Drawing is kept apart from applying: ``draw_augment`` takes everything
random that one batch needs (per-attack masks, SNRs, the noise, gains, rate
and cutoff choices) from an explicit torch.Generator on the batch's device,
and ``apply_augment`` is a pure function of the batch and those draws.  The
two frameworks' random streams cannot be matched, so the parity tests hand
the JAX package's draws to ``apply_augment``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from awm_tpu_torch.dsp import (
    fir_lowpass,
    lowpass_biquad,
    mulaw_roundtrip,
    quantize_int16,
    resample_rational,
)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Which channel attacks to simulate during training, with ranges.

    attack_prob applies each configured attack independently per example
    with that probability (both branches are computed; torch.where selects).
    Keeping a fraction of examples un-attacked is essential: an always-on
    aggressive curriculum collapses the detector's clean/watermarked
    separation (the reference measured a clean false-positive rate of 1.0
    when every example was resampled and volume-scaled)."""

    noise_snr_db: Optional[Tuple[float, float]] = None  # e.g. (20., 40.)
    volume_range: Optional[Tuple[float, float]] = None  # e.g. (0.3, 1.2)
    # One cutoff, or a tuple sampled per example (a lowpass curriculum, e.g.
    # (3500., 5000., 7000.)): training across a range of cutoffs forces the
    # bit energy below the harshest one.  Discrete choices, since each cutoff
    # is its own filter kernel.
    lowpass_hz: Optional[Tuple[float, ...]] = None  # float also accepted
    # "biquad": the soft -12 dB/oct rolloff; "fir": the steep 101-tap
    # windowed sinc, which leaves no out-of-band carrier for a resample
    # channel to erase.
    lowpass_filter: str = "biquad"  # "biquad" | "fir"
    quantize: bool = False
    # 8-bit G.711 mu-law round trip (dsp/codec.py); zero gradient, like quantize
    mulaw: bool = False
    # One target rate, or a tuple sampled per example (e.g. (8000, 11025,
    # 22050)); any rational ratio, through the polyphase resampler.
    resample_hz: Optional[int] = None  # int or tuple of ints
    attack_prob: float = 1.0  # per example and attack
    sample_rate: int = 16000
    # Apply the curriculum in validation too, with draws that do not depend
    # on the epoch (trainer.fit).  Without it val loc/dec measure clean
    # detection, which has converged when a robustness fine-tune starts, so
    # the best-epoch selection would freeze at epoch 0.
    val_attacks: bool = True


def _choices(value) -> tuple:
    return tuple(value) if isinstance(value, (tuple, list)) else (value,)


def mix_noise(x: torch.Tensor, snr_db: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x plus `noise` scaled to the per-example SNR snr_db (B, 1).  The 1e-12
    under the square roots keeps a silent clip's gradient finite."""
    sig_rms = torch.sqrt(x.square().mean(dim=-1, keepdim=True) + 1e-12)
    noise_rms = torch.sqrt(noise.square().mean(dim=-1, keepdim=True) + 1e-12)
    gain = sig_rms / noise_rms * 10.0 ** (-snr_db / 20.0)
    return x + noise * gain


def _uniform(shape, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=generator.device)


def add_noise(x: torch.Tensor, generator: torch.Generator,
              snr_db_range: Tuple[float, float]) -> torch.Tensor:
    """Additive white noise at a per-example random SNR, drawn from
    `generator` (on x's device)."""
    snr_db = _uniform((x.shape[0], 1), *snr_db_range, generator)
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return mix_noise(x, snr_db, noise)


def random_volume(x: torch.Tensor, generator: torch.Generator,
                  vol_range: Tuple[float, float]) -> torch.Tensor:
    """Per-example random gain."""
    return x * _uniform((x.shape[0], 1), *vol_range, generator)


def resample_roundtrip(x: torch.Tensor, target_hz: int, sample_rate: int = 16000) -> torch.Tensor:
    """Channel-style resample to target_hz and back, any rational ratio
    (Kaiser-windowed polyphase both ways, dsp.resample).  The intermediate
    length is ceil(T * up / down), so the way back can land a sample off T:
    the tail is cut or zero-padded back to T."""
    t = x.shape[-1]
    z = resample_rational(resample_rational(x, sample_rate, target_hz), target_hz, sample_rate)
    if z.shape[-1] > t:
        z = z[..., :t]
    elif z.shape[-1] < t:
        z = F.pad(z, (0, t - z.shape[-1]))
    return z


def draw_augment(cfg: AugmentConfig, batch: int, length: int,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Everything random apply_augment needs for one (batch, length) batch,
    on the generator's device: for each configured attack a (batch, 1) bool
    "<attack>_mask" when attack_prob < 1, plus "noise_snr_db" and "noise"
    (batch, length), "volume_gain", and "resample_choice" /
    "lowpass_choice" (batch, 1) where several rates / cutoffs are given."""
    dev = generator.device
    draws: Dict[str, torch.Tensor] = {}

    def mask(name):
        if cfg.attack_prob < 1.0:
            draws[f"{name}_mask"] = torch.rand((batch, 1), generator=generator, device=dev) < cfg.attack_prob

    def choice(name, options):
        if len(options) > 1:
            draws[f"{name}_choice"] = torch.randint(0, len(options), (batch, 1), generator=generator,
                                                    device=dev)

    if cfg.noise_snr_db is not None:
        mask("noise")
        draws["noise_snr_db"] = _uniform((batch, 1), *cfg.noise_snr_db, generator)
        draws["noise"] = torch.randn((batch, length), generator=generator, device=dev)
    if cfg.volume_range is not None:
        mask("volume")
        draws["volume_gain"] = _uniform((batch, 1), *cfg.volume_range, generator)
    if cfg.resample_hz is not None:
        mask("resample")
        choice("resample", _choices(cfg.resample_hz))
    if cfg.lowpass_hz is not None:
        mask("lowpass")
        choice("lowpass", _choices(cfg.lowpass_hz))
    if cfg.quantize:
        mask("quantize")
    if cfg.mulaw:
        mask("mulaw")
    return draws


def apply_augment(x: torch.Tensor, draws: Dict[str, torch.Tensor],
                  cfg: AugmentConfig) -> torch.Tensor:
    """The configured attack chain on (B, T) audio, in the order noise ->
    volume -> resample -> lowpass -> quantize -> mu-law, each attack applied
    to the examples its mask in `draws` (draw_augment) selects; without a
    mask (attack_prob >= 1) to all."""

    def maybe(name, attacked, clean):
        mask = draws.get(f"{name}_mask")
        return attacked if mask is None else torch.where(mask, attacked, clean)

    def among(name, options, fn, x):
        """fn(x, option) for the option each example drew."""
        if len(options) == 1:
            return fn(x, options[0])
        pick = draws[f"{name}_choice"]
        out = torch.zeros_like(x)
        for i, option in enumerate(options):
            out = torch.where(pick == i, fn(x, option), out)
        return out

    if cfg.noise_snr_db is not None:
        noisy = mix_noise(x, draws["noise_snr_db"], draws["noise"].to(x.dtype))
        x = maybe("noise", noisy, x)
    if cfg.volume_range is not None:
        x = maybe("volume", x * draws["volume_gain"], x)
    if cfg.resample_hz is not None:
        roundtrip = lambda x, rate: resample_roundtrip(x, rate, cfg.sample_rate)
        x = maybe("resample", among("resample", _choices(cfg.resample_hz), roundtrip, x), x)
    if cfg.lowpass_hz is not None:
        if cfg.lowpass_filter == "fir":
            lpf = lambda x, c: fir_lowpass(x, c, taps=101, sample_rate=cfg.sample_rate)
        else:
            lpf = lambda x, c: lowpass_biquad(x, cfg.sample_rate, c)
        x = maybe("lowpass", among("lowpass", _choices(cfg.lowpass_hz), lpf, x), x)
    if cfg.quantize:
        x = maybe("quantize", quantize_int16(x), x)
    if cfg.mulaw:
        x = maybe("mulaw", mulaw_roundtrip(x), x)
    return x

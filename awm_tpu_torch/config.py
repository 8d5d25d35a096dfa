"""Configuration dataclasses and named presets (counterpart of
awm_tpu/config.py).

Own copies of the constants, of the ModelConfig fields both families
read, and of ShapingConfig, LossConfig, ScheduleConfig, TrainConfig and
Config.  The presets are base, light, onecycle20, quality, ft_robust and
strided (the main14b_2 family).  The JAX ModelConfig's lstm_impl is not a
field here: the port routes the LSTM by device, and checkpoint.py writes the
key as "auto" for the JAX package's sidecar reader.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:  # augment imports torch; this module stays import-light
    from awm_tpu_torch.augment import AugmentConfig

SAMPLE_RATE = 16000
AUDIO_LEN = 16000


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture: family "base" (main14 generator + residual detector,
    width ``channels``) or "strided" (main14b_2, ref: py/main14b_2.py:43-48:
    ``base_channels`` doubled by each of ``strides``, ``lstm_layers``
    LSTMs of ``hidden_dim`` over the strided time axis, ``output_channels``
    into the upsampler).

    message_encoding: "table" = Embedding(2^16, C) lookup, "bits" = 16
    learned directions sign-flipped per bit.  decode_head: "shared" = one
    1x1 conv for all 17 channels, "dilated" = dilated-conv bit head.
    delta_band_hz: fixed 101-tap sinc FIR on the delta as the generator's
    last op (None = off).  The three are base-family variants only.
    """

    family: str = "base"
    message_bits: int = 16
    channels: int = 64
    message_encoding: str = "table"
    decode_head: str = "shared"
    delta_band_hz: Optional[float] = None
    base_channels: int = 32
    hidden_dim: int = 32
    output_channels: int = 128
    strides: Tuple[int, ...] = (2, 4, 5, 8)
    lstm_layers: int = 2


@dataclasses.dataclass(frozen=True)
class ShapingConfig:
    """main16 delta-shaping chain (fir_lowpass -> clamp_peak -> limit_rms)
    and the main15c channel postprocess of s_w inside the training graph
    (7 kHz biquad + int16 quantisation, shaping.perceptual_postprocess)."""

    enabled: bool = False
    fir_cutoff_hz: float = 4000.0
    fir_taps: int = 101
    clamp_thr: float = 0.02
    max_rms: float = 0.005
    postprocess: bool = False
    postprocess_cutoff_hz: float = 7000.0
    clamp_watermarked: bool = False  # clip s_w to [-1, 1] (main14b_2)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and variants (losses.py).  dec_loss_mode "per_sample" is
    the reference objective; "mean" is BCE on the time-mean logit.
    dec_bit_balance > 0 re-weights bit positions (mode "mean" only)."""

    lambda_l1: float = 0.1
    lambda_msspec: float = 2.0
    lambda_loud: float = 10.0
    lambda_loc: float = 10.0
    lambda_dec: float = 1.0
    dec_loss_mode: str = "per_sample"
    dec_bit_balance: float = 0.0
    hf_penalty_w: float = 0.0
    hf_cutoff_hz: float = 3500.0
    hf_n_fft: int = 512
    mel_scales: Tuple[Tuple[int, int], ...] = ((1024, 256),)


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Constant Adam lr, or OneCycle cosine (optax's
    cosine_onecycle_schedule formula, train.make_schedule)."""

    kind: str = "constant"  # "constant" | "onecycle"
    lr: float = 1e-3
    max_lr: float = 3e-4
    pct_start: float = 0.1
    div_factor: float = 25.0
    final_div_factor: float = 1e4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """compute_dtype is the conv/BN compute dtype of the training step:
    "bfloat16" casts activations and weight views to bf16 at each conv and
    BN, while parameters, BN statistics, the LSTM's state and every loss
    reduction stay fp32; "float32" is the strict path.  freeze = "gen" or
    "det" trains only the other network and keeps the frozen one's running
    statistics."""

    batch_size: int = 16
    epochs: int = 10
    seed: int = 42
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    early_stop_patience: int = 3
    early_stop_min_delta: float = 0.001
    quick_val_every: Optional[int] = None
    compute_dtype: str = "bfloat16"
    freeze: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "base"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    shaping: ShapingConfig = dataclasses.field(default_factory=ShapingConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    # channel-attack curriculum on both halves of the detector batch during
    # training (awm_tpu_torch.augment.AugmentConfig); None = off
    augment: Optional["AugmentConfig"] = None
    sample_rate: int = SAMPLE_RATE
    audio_len: int = AUDIO_LEN
    message_bits: int = 16


def _base() -> Config:
    """main14: the baseline."""
    return Config(name="base")


def _light() -> Config:
    """main15: main14's model and losses."""
    return Config(name="light")


def _onecycle20() -> Config:
    """main14d: 20 epochs of OneCycle cosine, quick-val every 2000 steps."""
    return Config(
        name="onecycle20",
        train=TrainConfig(epochs=20, schedule=ScheduleConfig(kind="onecycle"),
                          quick_val_every=2000),
    )


def _quality() -> Config:
    """main16: tighter imperceptibility weights, the shaping chain and the
    high-frequency penalty."""
    return Config(
        name="quality",
        loss=LossConfig(lambda_l1=1.0, lambda_msspec=4.0, lambda_loud=20.0,
                        lambda_loc=10.0, lambda_dec=1.0, hf_penalty_w=5.0),
        shaping=ShapingConfig(enabled=True),
    )


def _ft_robust() -> Config:
    """main15c: robustness fine-tune with the 7 kHz lowpass + int16
    quantisation of s_w inside the training graph, lr 1e-5, 3 epochs
    (ref: main15c.ipynb cells 0, 4, 6, 14-15)."""
    return Config(
        name="ft_robust",
        shaping=ShapingConfig(postprocess=True),
        train=TrainConfig(epochs=3, schedule=ScheduleConfig(kind="constant", lr=1e-5)),
    )


def _strided() -> Config:
    """main14b_2: the strided residual encoder/decoder family with s_w
    clipped to [-1, 1] (ref: py/main14b_2.py:43-48).  It collapses in the
    reference's run (BASELINE.md), a result the port reproduces."""
    return Config(name="strided", model=ModelConfig(family="strided"),
                  shaping=ShapingConfig(clamp_watermarked=True))


PRESETS = {"base": _base, "light": _light, "onecycle20": _onecycle20, "quality": _quality,
           "ft_robust": _ft_robust, "strided": _strided}


def get_config(name: str = "base") -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
    return PRESETS[name]()

from awm_tpu_torch.models.detector import Detector
from awm_tpu_torch.models.generator import Generator
from awm_tpu_torch.models.strided import StridedDetector, StridedGenerator
from awm_tpu_torch.models.messages import (
    bits_to_message,
    decode_bits_majority,
    decode_bits_mean_logit,
    message_to_bits,
)


def set_compute_dtype(net, dtype) -> None:
    """Set the compute dtype of every conv, Linear and BatchNorm of net
    (None = the parameters' dtype).  The flax modules' ``dtype`` attribute."""
    for m in net.modules():
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = dtype


def build_models(model_cfg, compute_dtype=None):
    """The (generator, detector) pair of a ModelConfig, fp32 parameters on
    the CPU; compute_dtype as set_compute_dtype's.  The strided family
    refuses the base family's message-encoding, decode-head and band-limit
    variants, which it would otherwise ignore (awm_tpu/models/__init__.py:31-45)."""
    if model_cfg.family == "base":
        gen, det = (
            Generator(
                message_bits=model_cfg.message_bits,
                channels=model_cfg.channels,
                message_encoding=model_cfg.message_encoding,
                delta_band_hz=model_cfg.delta_band_hz,
            ),
            Detector(
                message_bits=model_cfg.message_bits,
                channels=model_cfg.channels,
                decode_head=model_cfg.decode_head,
            ),
        )
    elif model_cfg.family == "strided":
        if (model_cfg.message_encoding != "table" or model_cfg.decode_head != "shared"
                or model_cfg.delta_band_hz is not None):
            raise ValueError(
                "message_encoding/decode_head/delta_band_hz variants are not implemented for "
                f"the strided family (got message_encoding={model_cfg.message_encoding!r}, "
                f"decode_head={model_cfg.decode_head!r}, delta_band_hz="
                f"{model_cfg.delta_band_hz!r}); use --preset base")
        gen, det = (
            StridedGenerator(
                message_bits=model_cfg.message_bits,
                base_channels=model_cfg.base_channels,
                hidden_dim=model_cfg.hidden_dim,
                output_channels=model_cfg.output_channels,
                strides=tuple(model_cfg.strides),
                lstm_layers=model_cfg.lstm_layers,
            ),
            StridedDetector(
                message_bits=model_cfg.message_bits,
                base_channels=model_cfg.base_channels,
                strides=tuple(model_cfg.strides),
            ),
        )
    else:
        raise ValueError(f"unknown model family {model_cfg.family!r}")
    for net in (gen, det):
        set_compute_dtype(net, compute_dtype)
    return gen, det


__all__ = [
    "Generator",
    "Detector",
    "StridedGenerator",
    "StridedDetector",
    "build_models",
    "set_compute_dtype",
    "message_to_bits",
    "bits_to_message",
    "decode_bits_mean_logit",
    "decode_bits_majority",
]

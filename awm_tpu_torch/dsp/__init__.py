from awm_tpu_torch.dsp.codec import (
    alaw_decode,
    alaw_encode,
    alaw_roundtrip,
    mulaw_decode,
    mulaw_encode,
    mulaw_roundtrip,
)
from awm_tpu_torch.dsp.filters import (
    fir_lowpass,
    lowpass_biquad,
    lowpass_biquad_coeffs,
    sinc_lowpass_kernel,
)
from awm_tpu_torch.dsp.metrics import power_ratio_db, quantize_int16, rms, si_snr
from awm_tpu_torch.dsp.quality import nsim_quality
from awm_tpu_torch.dsp.resample import resample_poly, resample_rational
# After the submodules above: the function stft shadows the submodule of
# that name as the package's attribute, as in the JAX package (import the
# module with importlib.import_module("awm_tpu_torch.dsp.stft")).
from awm_tpu_torch.dsp.stft import (
    frame,
    hann_window,
    hz_to_mel,
    log_mel,
    mel_filterbank,
    mel_spectrogram,
    mel_to_hz,
    spectrogram,
    stft,
)

__all__ = [
    "hann_window",
    "frame",
    "stft",
    "spectrogram",
    "mel_filterbank",
    "mel_spectrogram",
    "log_mel",
    "hz_to_mel",
    "mel_to_hz",
    "fir_lowpass",
    "sinc_lowpass_kernel",
    "lowpass_biquad",
    "lowpass_biquad_coeffs",
    "si_snr",
    "rms",
    "power_ratio_db",
    "quantize_int16",
    "mulaw_encode",
    "mulaw_decode",
    "mulaw_roundtrip",
    "alaw_encode",
    "alaw_decode",
    "alaw_roundtrip",
    "nsim_quality",
    "resample_poly",
    "resample_rational",
]

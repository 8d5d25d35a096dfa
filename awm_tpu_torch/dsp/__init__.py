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
from awm_tpu_torch.dsp.resample import resample_poly, resample_rational

__all__ = [
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
    "resample_poly",
    "resample_rational",
]

"""The port's DSP (awm_tpu_torch.dsp) vs the JAX package and scipy on the CPU:
biquad (FIR form and scan fallback), polyphase resampling, the G.711 codecs,
the signal metrics, STOI and NSIM.  Inputs are seeded numpy arrays handed to
both packages; each test states its tolerance."""

import os

import numpy as np
import pytest
import scipy.signal
import torch

import jax
import jax.numpy as jnp

from awm_tpu import dsp as jdsp
from awm_tpu.dsp import filters as jfilters
from awm_tpu.dsp import resample as jresample
from awm_tpu_torch import dsp as tdsp
from awm_tpu_torch.augment import resample_roundtrip
from awm_tpu_torch.dsp import filters as tfilters
from awm_tpu_torch.dsp import resample as tresample

HIGH_Q = dict(cutoff_hz=1000.0, sample_rate=16000, q=200.0)  # poles at |p| = 0.999


def audio(shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- biquad ---------------------------------------------------------------------


@pytest.mark.parametrize("cutoff", [7000.0, 4000.0])
def test_lowpass_biquad_matches_jax_and_lfilter(cutoff):
    """FIR form of the biquad, (2, 3, 800): vs the JAX function 1e-6 (both
    convolve the same truncated impulse response in fp32; measured 6e-8), vs
    scipy.signal.lfilter in float64 1e-5 (the truncation at |h| < 1e-7 and
    fp32 sums; measured 7e-8)."""
    x = audio((2, 3, 800))
    got = tdsp.lowpass_biquad(torch.from_numpy(x), 16000, cutoff)
    assert got.shape == x.shape and got.dtype == torch.float32
    ref = np.asarray(jdsp.lowpass_biquad(jnp.asarray(x), 16000, cutoff))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    b0, b1, b2, a1, a2 = tdsp.lowpass_biquad_coeffs(cutoff, 16000)
    assert (b0, b1, b2, a1, a2) == jdsp.lowpass_biquad_coeffs(cutoff, 16000)
    want = scipy.signal.lfilter([b0, b1, b2], [1.0, a1, a2], x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_biquad_impulse_response_matches_jax():
    for cutoff in (7000.0, 4000.0, 3500.0):
        c = tdsp.lowpass_biquad_coeffs(cutoff, 16000)
        np.testing.assert_array_equal(tfilters._biquad_impulse_response(c),
                                      jfilters._biquad_impulse_response(c))
    assert len(tfilters._biquad_impulse_response(tdsp.lowpass_biquad_coeffs(**HIGH_Q))) == 8192


@pytest.mark.parametrize("t", [800, 1000, 1])
def test_biquad_scan_fallback(t):
    """The doubling scan on a high-Q coefficient set (impulse response longer
    than 8192 taps, so biquad() takes the fallback), lengths a non power of
    two included: vs lfilter in float64 and vs the JAX package's
    associative scan, 2e-4 of the output's max (fp32 coefficients and fp32
    products of matrix powers with entries of order 30; measured 3.7e-5
    against lfilter, 6.5e-6 against the JAX scan)."""
    coeffs = tdsp.lowpass_biquad_coeffs(**HIGH_Q)
    x = audio((3, t), seed=1)
    got = tfilters._biquad_associative(torch.from_numpy(x), coeffs).numpy()
    via_biquad = tfilters.biquad(torch.from_numpy(x), coeffs).numpy()
    np.testing.assert_array_equal(got, via_biquad)
    b0, b1, b2, a1, a2 = coeffs
    want = scipy.signal.lfilter([b0, b1, b2], [1.0, a1, a2], x.astype(np.float64), axis=-1)
    ref = np.asarray(jfilters._biquad_associative(jnp.asarray(x), coeffs))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-4 * scale
    assert np.abs(got - ref).max() <= 2e-4 * scale


def test_biquad_scan_matches_fir_form_on_a_damped_filter():
    """Both evaluations of the same 4 kHz biquad agree to 1e-5."""
    x = audio((2, 500), seed=2)
    coeffs = tdsp.lowpass_biquad_coeffs(4000.0, 16000)
    a = tfilters.biquad(torch.from_numpy(x), coeffs)
    b = tfilters._biquad_associative(torch.from_numpy(x), coeffs)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("form", ["fir", "scan"])
def test_biquad_gradient_matches_jax(form):
    """d sum(sin(biquad(x))) / dx vs jax.grad, both forms: 1e-5."""
    x = audio((2, 300), seed=3)
    coeffs = tdsp.lowpass_biquad_coeffs(4000.0, 16000)
    tf = tfilters.biquad if form == "fir" else tfilters._biquad_associative
    jf = jfilters.biquad if form == "fir" else jfilters._biquad_associative
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(tf(xt, coeffs)).sum().backward()
    ref = jax.grad(lambda v: jnp.sin(jf(v, coeffs)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=1e-5)


# -- resampling -----------------------------------------------------------------

RATIOS = [(1, 2), (441, 320), (441, 640), (2, 1), (320, 441), (640, 441)]


@pytest.mark.parametrize("up,down", RATIOS, ids=[f"{u}_{d}" for u, d in RATIOS])
def test_resample_poly_matches_jax_and_scipy(up, down):
    """One strided conv1d per ratio, (2, 800): vs the JAX function and vs
    scipy.signal.resample_poly (float64), 1e-5 (measured 2e-7); lengths
    ceil(T up / down)."""
    x = audio((2, 800), seed=4)
    got = tdsp.resample_poly(torch.from_numpy(x), up, down)
    ref = np.asarray(jdsp.resample_poly(jnp.asarray(x), up, down))
    want = scipy.signal.resample_poly(x.astype(np.float64), up, down, axis=-1)
    assert got.shape == ref.shape == want.shape == (2, -(-800 * up // down))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_polyphase_weights_match_jax():
    for up, down in RATIOS + [(3, 3), (882, 640)]:
        w, q_min, u, d = tresample._polyphase_weights(up, down)
        jw, jq, ju, jd = jresample._polyphase_weights(up, down)
        assert (q_min, u, d) == (jq, ju, jd)
        np.testing.assert_array_equal(w, jw)
    x = torch.arange(5.0)
    assert tdsp.resample_poly(x, 3, 3) is x
    with pytest.raises(ValueError):
        tdsp.resample_poly(x, 0, 1)


@pytest.mark.parametrize("t", [16000, 15999, 777])
@pytest.mark.parametrize("rate", [8000, 11025, 22050])
def test_resample_roundtrip_lengths_and_jax(rate, t):
    """Down-up round trip at T = 16000 and odd lengths: the output is T long
    again (tail cut or zero-padded) and equals the JAX package's to 1e-5."""
    from awm_tpu.augment import resample_roundtrip as jroundtrip

    x = audio((2, t), seed=5)
    got = resample_roundtrip(torch.from_numpy(x), rate, 16000)
    ref = np.asarray(jroundtrip(jnp.asarray(x), rate, 16000))
    assert got.shape == (2, t) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_resample_gradient_matches_jax():
    """d sum(sin(resample(x))) / dx vs jax.grad at 441/320: 1e-5."""
    x = audio((2, 400), seed=6)
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(tdsp.resample_poly(xt, 441, 320)).sum().backward()
    ref = jax.grad(lambda v: jnp.sin(jdsp.resample_poly(v, 441, 320)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=1e-5)


# -- G.711 ----------------------------------------------------------------------

LAWS = {"mulaw": ("mulaw_encode", "mulaw_decode", "mulaw_roundtrip", "mu"),
        "alaw": ("alaw_encode", "alaw_decode", "alaw_roundtrip", "a")}


@pytest.mark.parametrize("law", sorted(LAWS))
def test_g711_exact_vs_jax_over_int16(law):
    """Encode over the whole int16 range and decode over all 256 codes:
    byte-exact against the JAX functions."""
    enc, dec, _, _ = LAWS[law]
    pcm = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    codes = getattr(tdsp, enc)(torch.from_numpy(pcm))
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(getattr(jdsp, enc)(jnp.asarray(pcm))))
    all_codes = np.arange(256, dtype=np.uint8)
    out = getattr(tdsp, dec)(torch.from_numpy(all_codes))
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), np.asarray(getattr(jdsp, dec)(jnp.asarray(all_codes))))


@pytest.mark.parametrize("law", sorted(LAWS))
def test_g711_exact_vs_audioop_goldens(law):
    """The frozen audioop vectors of tests/golden/g711_audioop.npz."""
    enc, dec, _, key = LAWS[law]
    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "g711_audioop.npz"))
    np.testing.assert_array_equal(getattr(tdsp, enc)(torch.from_numpy(g["pcm"])).numpy(), g[f"{key}_enc"])
    codes = torch.from_numpy(np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(getattr(tdsp, dec)(codes).numpy(), g[f"{key}_dec"])


@pytest.mark.parametrize("law", sorted(LAWS))
def test_g711_roundtrip_exact_vs_jax(law):
    """Float audio through the codec, values beyond +-1 included: the same
    bits as the JAX round trip; shape and dtype kept."""
    rt = LAWS[law][2]
    x = audio((3, 500), seed=7, scale=0.5)
    x[0, :4] = [1.5, -1.5, 1.0, -1.0]
    got = getattr(tdsp, rt)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jdsp, rt)(jnp.asarray(x))))


# -- metrics --------------------------------------------------------------------


def test_metrics_match_jax():
    """si_snr, rms (all axes and one), power_ratio_db: 1e-5 relative;
    quantize_int16: exact, ties to even included, and zero gradient."""
    s, d = audio((3, 600), seed=8), audio((3, 600), seed=9, scale=0.01)
    ts, td = torch.from_numpy(s), torch.from_numpy(d)
    np.testing.assert_allclose(float(tdsp.si_snr(ts, ts + td)),
                               float(jdsp.si_snr(jnp.asarray(s), jnp.asarray(s + d))), rtol=1e-5)
    np.testing.assert_allclose(float(tdsp.rms(ts)), float(jdsp.rms(jnp.asarray(s))), rtol=1e-5)
    np.testing.assert_allclose(tdsp.rms(ts, axis=-1).numpy(),
                               np.asarray(jdsp.rms(jnp.asarray(s), axis=-1)), rtol=1e-5)
    np.testing.assert_allclose(float(tdsp.power_ratio_db(ts, td)),
                               float(jdsp.power_ratio_db(jnp.asarray(s), jnp.asarray(d))), rtol=1e-5)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32) / np.float32(32767.0)
    q = np.concatenate([s.reshape(-1), ties])
    np.testing.assert_array_equal(tdsp.quantize_int16(torch.from_numpy(q)).numpy(),
                                  np.asarray(jdsp.quantize_int16(jnp.asarray(q))))
    xt = ts.clone().requires_grad_()
    tdsp.quantize_int16(xt).sum().backward()
    assert float(xt.grad.abs().max()) == 0.0


def test_stoi_and_nsim_equal_the_jax_packages():
    """Host numpy copies: the same floats to 1e-9, at 16 kHz and at a rate
    that resamples first; the degenerate inputs give NaN alike."""
    from awm_tpu.dsp.quality import nsim_quality as jnsim
    from awm_tpu.dsp.stoi import pesq_score as jpesq, stoi as jstoi
    from awm_tpu_torch.dsp.quality import nsim_quality
    from awm_tpu_torch.dsp.stoi import pesq_score, stoi

    rng = np.random.default_rng(10)
    t = np.arange(2 * 16000) / 16000.0
    x = (np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
         + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    y = x + 0.05 * rng.standard_normal(t.size).astype(np.float32)
    for fs in (16000, 8000):
        assert abs(stoi(x, y, fs) - jstoi(x, y, fs)) <= 1e-9
        assert abs(nsim_quality(x, y, fs) - jnsim(x, y, fs)) <= 1e-9
    assert 0.0 < stoi(x, y) < stoi(x, x) <= 1.0 + 1e-9
    assert np.isnan(stoi(x[:600], y[:600])) and np.isnan(nsim_quality(x[:600], y[:600]))
    assert pesq_score(x, y) == jpesq(x, y)

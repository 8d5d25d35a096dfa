"""Port losses and STFT/mel stack vs the JAX package (awm_tpu/losses.py,
awm_tpu/dsp/stft.py).

Seeded numpy inputs go through both packages, fp32 on the CPU; tolerances
are stated per test."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from awm_tpu import losses as jl
from awm_tpu.config import LossConfig as JLossConfig

from awm_tpu_torch import losses as tl
from awm_tpu_torch.config import LossConfig

js = importlib.import_module("awm_tpu.dsp.stft")  # the package exports a function of that name
ts = importlib.import_module("awm_tpu_torch.dsp.stft")  # so does the port's


def _audio(rng, b=2, t=800, scale=0.3):
    return (rng.standard_normal((b, t)) * scale).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256), (2048, 512)])
def test_stft_matches_jax(rng, n_fft, hop):
    """Complex STFT at T=800, where the 2048-point frame's reflect pad is
    wider than the clip (numpy's periodic reflection): 1e-4 absolute on
    values of order 10 (two FFT implementations)."""
    x = _audio(rng)
    ref = np.asarray(js.stft(jnp.asarray(x), n_fft, hop))
    out = ts.stft(torch.from_numpy(x), n_fft, hop).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_reflect_pad_matches_numpy(rng):
    """Exact, for pads below and above the signal length."""
    x = rng.standard_normal((3, 17)).astype(np.float32)
    for pad in (1, 8, 16, 40):
        np.testing.assert_array_equal(
            ts.reflect_pad(torch.from_numpy(x), pad).numpy(),
            np.pad(x, ((0, 0), (pad, pad)), mode="reflect"),
        )


def test_mel_stack_matches_jax(rng):
    """HTK filterbank built the same way in float64: exact; hann window
    1e-7; log-mel 1e-4 (log of power sums from two FFTs)."""
    np.testing.assert_array_equal(ts.mel_filterbank(513, 64, 16000),
                                  js.mel_filterbank(513, 64, 16000))
    np.testing.assert_allclose(ts.hann_window(1024).numpy(), np.asarray(js.hann_window(1024)),
                               atol=1e-7)
    x = _audio(rng)
    for kw in ({}, {"n_fft": 512, "hop": 128}):
        ref = np.asarray(js.log_mel(jnp.asarray(x), **kw))
        np.testing.assert_allclose(ts.log_mel(torch.from_numpy(x), **kw).numpy(), ref, atol=1e-4)
    ref = np.asarray(js.spectrogram(jnp.asarray(x), 512, 128, power=1.0))
    np.testing.assert_allclose(ts.spectrogram(torch.from_numpy(x), 512, 128, power=1.0).numpy(),
                               ref, atol=1e-4)


def _loss_inputs(rng, b=2, t=800, bits=16):
    s = _audio(rng, b, t)
    delta = _audio(rng, b, t, scale=0.01)
    logits = (rng.standard_normal((2 * b, t, 1 + bits)) * 2.0).astype(np.float32)
    message = rng.integers(0, 2**bits, size=b).astype(np.int32)
    return s, s + delta, delta, logits, message


@pytest.mark.parametrize("mode,balance", [("per_sample", 0.0), ("mean", 0.0), ("mean", 1.5)])
def test_dec_loss_matches_jax(rng, mode, balance):
    """dec in all three forms, value and gradient w.r.t. the logits (the
    bit_balance weights are detached on both sides): 1e-6 relative."""
    _, _, _, logits, message = _loss_inputs(rng)
    dl = logits[:2, :, 1:]
    ref_v, ref_g = jax.value_and_grad(
        lambda z: jl.dec_loss(z, jnp.asarray(message), 16, mode=mode, bit_balance=balance)
    )(jnp.asarray(dl))
    z = torch.from_numpy(dl).requires_grad_()
    v = tl.dec_loss(z, torch.from_numpy(message).long(), 16, mode=mode, bit_balance=balance)
    v.backward()
    v = v.detach()
    np.testing.assert_allclose(v.item(), float(ref_v), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-10)
    with pytest.raises(ValueError, match="mode"):
        tl.dec_loss(z, torch.from_numpy(message).long(), mode="median")


def test_loss_terms_match_jax(rng):
    """Every term of total_loss under a config with all six terms (hf on,
    two mel scales), and the total: 1e-5 relative (fp32 FFT sums)."""
    s, s_w, delta, logits, message = _loss_inputs(rng)
    kw = dict(lambda_l1=1.0, lambda_msspec=4.0, lambda_loud=20.0, hf_penalty_w=5.0,
              dec_loss_mode="mean", dec_bit_balance=1.0, mel_scales=((1024, 256), (512, 128)))
    ref = jl.total_loss(JLossConfig(**kw), s=jnp.asarray(s), s_w=jnp.asarray(s_w),
                        delta=jnp.asarray(delta), logits=jnp.asarray(logits),
                        message=jnp.asarray(message))
    out = tl.total_loss(LossConfig(**kw), s=torch.from_numpy(s), s_w=torch.from_numpy(s_w),
                        delta=torch.from_numpy(delta), logits=torch.from_numpy(logits),
                        message=torch.from_numpy(message).long())
    assert sorted(out) == sorted(ref) == sorted(tl.term_keys(LossConfig(**kw)))
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    assert tl.term_keys(LossConfig()) == jl.term_keys(JLossConfig())


def test_total_loss_gradients_match_jax(rng):
    """Gradient of the weighted total w.r.t. s_w, delta and the logits under
    the base weights with dec "mean": 1e-4 of each gradient's max (the
    STFT-magnitude terms' gradients go through two FFTs)."""
    s, s_w, delta, logits, message = _loss_inputs(rng)
    cfg_kw = dict(dec_loss_mode="mean")

    def jtotal(sw, d, z):
        return jl.total_loss(JLossConfig(**cfg_kw), s=jnp.asarray(s), s_w=sw, delta=d, logits=z,
                             message=jnp.asarray(message))["total"]

    ref = jax.grad(jtotal, argnums=(0, 1, 2))(jnp.asarray(s_w), jnp.asarray(delta),
                                              jnp.asarray(logits))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (s_w, delta, logits)]
    tl.total_loss(LossConfig(**cfg_kw), s=torch.from_numpy(s), s_w=leaves[0], delta=leaves[1],
                  logits=leaves[2], message=torch.from_numpy(message).long())["total"].backward()
    for name, leaf, r in zip(("s_w", "delta", "logits"), leaves, ref):
        r = np.asarray(r)
        err = np.abs(leaf.grad.numpy() - r).max() / np.abs(r).max()
        assert err < 1e-4, (name, err)

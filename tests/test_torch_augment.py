"""The port's channel attacks (awm_tpu_torch.augment) vs the JAX package's.

The two frameworks' random streams cannot be matched, so the JAX draws are
re-derived from its key splits (torch_assets.jax_augment_draws) and handed to
the port's apply_augment; the first test holds that re-derivation against
awm_tpu.augment itself.  T <= 800; tolerances per test."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_assets as ta

from awm_tpu import augment as jaug
from awm_tpu_torch import augment as taug

B, T = 6, 800
CHAIN = dict(noise_snr_db=(10.0, 40.0), volume_range=(0.3, 1.2), lowpass_hz=(3500.0, 5000.0, 7000.0),
             quantize=True, resample_hz=(8000, 11025, 22050), mulaw=True)
CASES = {
    "noise": dict(noise_snr_db=(15.0, 40.0)),
    "volume": dict(volume_range=(0.3, 1.2)),
    "resample_one": dict(resample_hz=8000),
    "resample_tuple": dict(resample_hz=(8000, 11025, 22050)),
    "lowpass_one": dict(lowpass_hz=7000.0),
    "lowpass_tuple": dict(lowpass_hz=(3500.0, 5000.0, 7000.0)),
    "lowpass_fir": dict(lowpass_hz=(3500.0, 5000.0), lowpass_filter="fir"),
    "quantize": dict(quantize=True),
    "mulaw": dict(mulaw=True),
    "chain": CHAIN,
    "chain_fir": dict(CHAIN, lowpass_filter="fir"),
}


def audio(seed=0, b=B, t=T):
    return (np.random.default_rng(seed).standard_normal((b, t)) * 0.2).astype(np.float32)


def both_configs(fields, attack_prob):
    return (jaug.AugmentConfig(attack_prob=attack_prob, **fields),
            taug.AugmentConfig(attack_prob=attack_prob, **fields))


def as_tensors(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def test_config_fields_and_defaults_match_jax():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(taug.AugmentConfig) == fields(jaug.AugmentConfig)


@pytest.mark.parametrize("attack_prob", [1.0, 0.45])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_augment_matches_jax_under_its_draws(case, attack_prob):
    """Each attack alone and the full chain, attack_prob 1.0 and 0.45, single
    and tuple rates / cutoffs, biquad and FIR lowpass: the port's
    apply_augment on the JAX draws vs awm_tpu.augment.apply_augment under the
    key they were read from.  2e-5 absolute: past a quantiser (int16 or
    mu-law) an fp32 difference of 1e-7 upstream can move a sample by one
    step, so there at most 1% of the samples may differ, each by at most one
    mu-law step at that level (2^-4 of the sample, plus an int16 step)."""
    jcfg, tcfg = both_configs(CASES[case], attack_prob)
    key = jax.random.key(11)
    x = audio(1)
    ref = np.asarray(jaug.apply_augment(jnp.asarray(x), key, jcfg))
    draws = ta.jax_augment_draws(key, jcfg, B, T)
    masks = [k for k in draws if k.endswith("_mask")]
    assert bool(masks) == (attack_prob < 1.0)
    got = taug.apply_augment(torch.from_numpy(x), as_tensors(draws), tcfg).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    diff = np.abs(got - ref)
    if tcfg.quantize or tcfg.mulaw:
        off = diff > 2e-5
        assert off.mean() <= 0.01, off.mean()
        assert (diff[off] <= np.abs(ref[off]) / 16 + 2 / 32767).all()
    else:
        assert diff.max() <= 2e-5, diff.max()
    if attack_prob < 1.0 and case != "chain" and case != "chain_fir":
        untouched = ~draws[masks[0]][:, 0]
        np.testing.assert_array_equal(got[untouched], x[untouched])


def test_draw_augment_shapes_ranges_and_repeatability():
    """draw_augment makes what apply_augment reads, within the configured
    ranges, the same under the same generator seed and different under
    another; attack_prob 1.0 draws no masks."""
    cfg = taug.AugmentConfig(attack_prob=0.45, **CHAIN)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    d = taug.draw_augment(cfg, 64, T, gen(0))
    ref = ta.jax_augment_draws(jax.random.key(0), jaug.AugmentConfig(attack_prob=0.45, **CHAIN), 64, T)
    assert sorted(d) == sorted(ref)
    for k, v in d.items():
        assert tuple(v.shape) == ref[k].shape and v.numpy().dtype == ref[k].dtype, k
    assert 10.0 <= float(d["noise_snr_db"].min()) and float(d["noise_snr_db"].max()) <= 40.0
    assert 0.3 <= float(d["volume_gain"].min()) and float(d["volume_gain"].max()) <= 1.2
    assert set(d["resample_choice"].unique().tolist()) <= {0, 1, 2}
    assert 0.2 < float(d["noise_mask"].float().mean()) < 0.7
    again, other = taug.draw_augment(cfg, 64, T, gen(0)), taug.draw_augment(cfg, 64, T, gen(1))
    assert all(torch.equal(d[k], again[k]) for k in d)
    assert not torch.equal(d["noise"], other["noise"])
    always = taug.draw_augment(dataclasses.replace(cfg, attack_prob=1.0), 4, T, gen(0))
    assert not [k for k in always if k.endswith("_mask")]
    x = torch.from_numpy(audio(2, 64))
    out = taug.apply_augment(x, d, cfg)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_add_noise_hits_the_snr_and_volume_scales():
    x = torch.from_numpy(audio(3))
    noisy = taug.add_noise(x, torch.Generator().manual_seed(0), (20.0, 20.0))
    snr = 10 * torch.log10(x.square().mean(dim=1) / (noisy - x).square().mean(dim=1))
    np.testing.assert_allclose(snr.numpy(), 20.0, atol=1e-3)
    louder = taug.random_volume(x, torch.Generator().manual_seed(0), (2.0, 2.0))
    np.testing.assert_allclose(louder.numpy(), 2.0 * x.numpy(), rtol=1e-6)


@pytest.mark.parametrize("case", ["noise", "volume", "resample_tuple", "lowpass_tuple", "lowpass_fir",
                                  "chain"])
def test_attack_gradients_match_jax(case):
    """d sum(sin(3 apply_augment(x))) / dx vs jax.grad under the same draws,
    attack_prob 0.45: 1e-4 of the gradient's max.  In the chain the int16 and
    mu-law steps have zero gradient, so an example they attacked passes none;
    a silent clip (row 0 zeroed) keeps a finite gradient through the noise
    attack's 1e-12."""
    jcfg, tcfg = both_configs(CASES[case], 0.45)
    key = jax.random.key(5)
    x = audio(4)
    x[0] = 0.0
    draws = ta.jax_augment_draws(key, jcfg, B, T)
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(3.0 * taug.apply_augment(xt, as_tensors(draws), tcfg)).sum().backward()
    ref = np.asarray(jax.grad(lambda v: jnp.sin(3.0 * jaug.apply_augment(v, key, jcfg)).sum())(jnp.asarray(x)))
    assert np.isfinite(xt.grad.numpy()).all()
    assert np.abs(xt.grad.numpy() - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1e-6)
    if case == "chain":
        dead = draws["quantize_mask"][:, 0] | draws["mulaw_mask"][:, 0]
        assert dead.any() and float(xt.grad[torch.from_numpy(dead)].abs().max()) == 0.0

"""Port models vs the flax modules on the same variables (fp32, eval mode).

The flax variables are initialised from a seed, converted with
awm_tpu_torch.checkpoint.variables_from_flax and loaded strictly, so a
missing, extra or mis-shaped parameter fails the load itself."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from awm_tpu.models import Detector as JDetector, Generator as JGenerator

from awm_tpu_torch.checkpoint import variables_from_flax
from awm_tpu_torch.models import Detector, Generator
from awm_tpu_torch.models.messages import (
    bits_to_message,
    decode_bits_majority,
    decode_bits_mean_logit,
    message_to_bits,
)

T = 256


def _numpy_tree(variables):
    return jax.tree.map(np.asarray, dict(variables))


def _perturb_stats(tree, rng):
    """Fresh flax BN stats are (0, 1), which would hide a mean/var mix-up."""
    stats = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a).astype(np.float32),
        tree.get("batch_stats", {}),
    )
    return {**tree, "batch_stats": stats}


def _inputs(rng, b=2):
    s = (rng.standard_normal((b, T)) * 0.3).astype(np.float32)
    msg = rng.integers(0, 2**16, size=b).astype(np.int32)
    return s, msg


# (encoding, band, channels): the base family's 64 channels (ids as before),
# and the widths the LSTM kernels take masked (48), on the cluster path (128)
# and on the wide path (320) with the table encoding.
GEN_CASES = [pytest.param(e, b, 64, id=f"{b}-{e}") for b in (None, 3000.0) for e in ("table", "bits")] + [
    pytest.param("table", None, c, id=f"None-table-c{c}") for c in (48, 128, 320)]


@pytest.mark.parametrize("encoding,band,channels", GEN_CASES)
def test_generator_matches_flax(rng, encoding, band, channels):
    """Whole generator, random flax init: convs, BN, LSTM, message path and
    band FIR in fp32, at 64, 48, 128 and 320 channels (LSTM(C, C)).  Tolerance
    1e-5 (summation order only; the random init keeps the LSTM
    contractive)."""
    s, msg = _inputs(rng)
    jgen = JGenerator(message_encoding=encoding, delta_band_hz=band, channels=channels)
    variables = _perturb_stats(
        _numpy_tree(jgen.init(jax.random.key(0), jnp.asarray(s), jnp.asarray(msg))), rng
    )
    ref = np.asarray(jgen.apply(variables, jnp.asarray(s), jnp.asarray(msg)))

    gen = Generator(message_encoding=encoding, delta_band_hz=band, channels=channels)
    gen.load_state_dict(variables_from_flax(variables), strict=True)
    assert tuple(gen.lstm.w_hh.shape) == (4 * channels, channels)
    gen.eval()
    with torch.no_grad():
        out = gen(torch.from_numpy(s), torch.from_numpy(msg.astype(np.int64)))
    assert out.shape == (2, T) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("head,channels", [pytest.param("shared", 64, id="shared"),
                                            pytest.param("dilated", 64, id="dilated"),
                                            pytest.param("shared", 48, id="shared-c48"),
                                            pytest.param("shared", 128, id="shared-c128"),
                                            pytest.param("shared", 320, id="shared-c320")])
def test_detector_matches_flax(rng, head, channels):
    """Detector logits (B, T, 1+bits) at 1e-5, at 64, 48, 128 and 320 channels;
    the dilated head's receptive field (dilations 16/128/1024) exceeds T, so
    its zero padding is exercised too."""
    s, _ = _inputs(rng, b=3)
    jdet = JDetector(decode_head=head, channels=channels)
    variables = _perturb_stats(_numpy_tree(jdet.init(jax.random.key(1), jnp.asarray(s))), rng)
    ref = np.asarray(jdet.apply(variables, jnp.asarray(s)))

    det = Detector(decode_head=head, channels=channels)
    det.load_state_dict(variables_from_flax(variables), strict=True)
    det.eval()
    with torch.no_grad():
        out = det(torch.from_numpy(s))
    assert out.shape == (3, T, 17)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_messages_match_jax(rng):
    from awm_tpu.models import messages as jm

    msg = rng.integers(0, 2**16, size=5).astype(np.int32)
    bits = message_to_bits(torch.from_numpy(msg.astype(np.int64)))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jm.message_to_bits(jnp.asarray(msg))))
    np.testing.assert_array_equal(bits_to_message(bits).numpy(), msg)
    logits = rng.standard_normal((5, 40, 16)).astype(np.float32)
    for ours, theirs in ((decode_bits_mean_logit, jm.decode_bits_mean_logit),
                         (decode_bits_majority, jm.decode_bits_majority)):
        np.testing.assert_array_equal(
            ours(torch.from_numpy(logits)).numpy(), np.asarray(theirs(jnp.asarray(logits)))
        )


def test_variables_from_flax_layouts():
    """The inverse of awm_tpu/checkpoint.py's importers: conv (k,in,out) ->
    (out,in,k), transposed conv -> (in,out,k) with no flip, Dense kernel ->
    Linear weight, BN scale/mean/var -> weight/running_mean/running_var."""
    w = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    tree = {
        "params": {
            "enc_conv": {"w": w, "b": np.zeros(4, np.float32)},
            "dec_deconv": {"w": w, "b": np.zeros(4, np.float32)},
            "bit_proj": {"kernel": np.ones((16, 4), np.float32)},
            "res": {"bn1": {"scale": np.full(4, 2.0, np.float32), "bias": np.zeros(4, np.float32)}},
        },
        "batch_stats": {"res": {"bn1": {"mean": np.ones(4, np.float32), "var": np.ones(4, np.float32)}}},
    }
    sd = variables_from_flax(tree)
    np.testing.assert_array_equal(sd["enc_conv.weight"].numpy(), w.transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["dec_deconv.weight"].numpy(), w.transpose(1, 2, 0))
    assert tuple(sd["bit_proj.weight"].shape) == (4, 16)
    assert set(sd) >= {"res.bn1.weight", "res.bn1.bias", "res.bn1.running_mean", "res.bn1.running_var"}
    with pytest.raises(ValueError, match="unrecognised"):
        variables_from_flax({"params": {"odd": {"gamma": np.ones(2, np.float32)}}})

"""The port's packaged assets stay true to the JAX package.

- assets/shapecap.npz equals the orbax restore of
  evidence/r5/shapecap/ckpt_best, and assets/awm_arch.json its sidecar;
- assets/t_flagship.npz and assets/t_flagship_arch.json equal
  evidence/r5/T_flagship/ckpt_best the same way;
- assets/shapecap_golden.npz, train_golden.npz, robust_golden.npz and
  robust_train_golden.npz are what the JAX package computes now;
- the port loads the .npz and reproduces the goldens on the CPU (the robust
  table's check is in tests/test_torch_eval.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_assets as ta

from awm_tpu_torch.api import InferenceSession
from awm_tpu_torch.checkpoint import (
    SHAPECAP_ARCH,
    SHAPECAP_NPZ,
    T_FLAGSHIP_ARCH,
    T_FLAGSHIP_NPZ,
    configs_from_arch,
    load_models,
    read_arch,
)
from awm_tpu_torch.config import ModelConfig, ShapingConfig


@pytest.fixture(scope="module")
def restored():
    return ta.restore_shapecap()


def test_weights_npz_equals_orbax_restore(restored):
    _, state, _, _ = restored
    want = ta.weights_arrays(state)
    with np.load(SHAPECAP_NPZ) as have:
        assert sorted(have.files) == sorted(want)
        assert sum(have[k].size for k in have.files) == 229_154
        for key, arr in want.items():
            assert have[key].dtype == arr.dtype, key
            np.testing.assert_array_equal(have[key], arr, err_msg=key)
    with open(os.path.join(ta.CKPT, "awm_arch.json")) as f, open(SHAPECAP_ARCH) as g:
        assert json.load(f) == json.load(g)


def test_golden_reproduces_from_jax(restored):
    """Same seed, same weights, same JAX fp32 session -> the committed
    golden (inputs exactly; outputs to 1e-6, allowing for threaded CPU
    reductions)."""
    want = ta.golden_arrays(*restored)
    with np.load(ta.GOLDEN_NPZ) as have:
        assert sorted(have.files) == sorted(want)
        np.testing.assert_array_equal(have["chunks"], want["chunks"])
        np.testing.assert_array_equal(have["messages"], want["messages"])
        for key in set(want) - {"chunks", "messages"}:
            np.testing.assert_allclose(have[key], want[key], atol=1e-6, err_msg=key)


def test_arch_sidecar_configs():
    model, shaping = configs_from_arch(read_arch(SHAPECAP_ARCH))
    assert model == ModelConfig(message_encoding="bits", decode_head="dilated", delta_band_hz=3000.0)
    assert shaping == ShapingConfig(enabled=True, max_rms=0.01)
    assert read_arch(os.path.dirname(SHAPECAP_ARCH)) == read_arch(SHAPECAP_ARCH)
    assert read_arch(os.path.dirname(os.path.dirname(SHAPECAP_ARCH))) is None
    assert configs_from_arch(None) == (ModelConfig(), None)


def test_port_reproduces_golden_on_cpu():
    """The port's fp32 session on 2 of the golden chunks, full 16000-sample
    length.  The trained LSTM amplifies fp32 rounding over 16000 steps (its
    output differs by up to ~1e-3 between two correct fp32 recurrences), which
    reaches the shaped delta as ~3e-5: delta atol 2e-4.  Summaries: probs
    1e-5, time-mean bit logits and vote fractions 1e-3, delta RMS 1e-7."""
    gen, det, _, shaping = load_models()
    assert shaping is not None and shaping.max_rms == 0.01
    sess = InferenceSession(gen, det, compute_dtype=torch.float32, shaping=shaping, device="cpu")
    with np.load(ta.GOLDEN_NPZ) as g:
        golden = {k: g[k][:2] for k in g.files}
    delta = sess.embed_chunks(golden["chunks"], golden["messages"])
    np.testing.assert_allclose(delta, golden["embed_delta"], atol=2e-4)
    assert np.sqrt((delta**2).mean(axis=1)).max() <= 0.01
    out = sess.embed_detect(golden["chunks"], golden["messages"])
    for key, tol in (("wm_prob", 1e-5), ("clean_prob", 1e-5), ("msg_logit_mean", 1e-3),
                     ("msg_vote_frac", 1e-3), ("delta_rms", 1e-7)):
        np.testing.assert_allclose(out[key], golden[key], atol=tol, err_msg=key)


def test_train_golden_reproduces_from_jax():
    """Same seed, weights and message, the JAX package's fp32 train-step loss
    function -> the committed train golden (inputs exactly; terms, gradient
    norms and BN statistics to 1e-6 relative)."""
    want = ta.train_golden_arrays()
    with np.load(ta.TRAIN_GOLDEN_NPZ) as have:
        assert sorted(have.files) == sorted(want)
        np.testing.assert_array_equal(have["chunks"], want["chunks"])
        np.testing.assert_array_equal(have["messages"], want["messages"])
        for key in set(want) - {"chunks", "messages"}:
            np.testing.assert_allclose(have[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)


def test_port_reproduces_train_golden_on_cpu():
    """The port's fp32 train step from the packaged weights on the golden's 4
    chunks at T=16000 (the LSTM through LSTMFunction's plain B and C).
    Terms 1e-5 relative (measured 6e-7).  BN statistics 1e-4 + 1e-3 relative
    (measured 2.4e-5 absolute).  Gradient norms 5e-2 relative: the trained
    LSTM amplifies fp32 rounding over 16000 steps, and a 1e-7 relative
    change of the input moves the JAX package's own LSTM gradient norms by
    1.4% (measured on the CPU); port vs JAX measured 2.1%.  The conv biases
    fed to a train-mode BatchNorm (zero gradient analytically) are left out."""
    import dataclasses
    import re

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.checkpoint import load_into
    from awm_tpu_torch.config import get_config

    model, shaping = configs_from_arch(read_arch(SHAPECAP_ARCH))
    cfg = get_config("base")
    cfg = dataclasses.replace(cfg, model=model, shaping=shaping,
                              loss=dataclasses.replace(cfg.loss, dec_loss_mode="mean"),
                              train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    state = tr.init_state(cfg, device="cpu")
    load_into(state.gen, state.det, SHAPECAP_NPZ)
    with np.load(ta.TRAIN_GOLDEN_NPZ) as g:
        golden = {k: g[k] for k in g.files}
    terms = tr.train_step(cfg, state, torch.from_numpy(golden["chunks"]),
                          message=torch.from_numpy(golden["messages"]).long())
    for k, v in terms.items():
        np.testing.assert_allclose(float(v), golden[f"term/{k}"], rtol=1e-5, err_msg=k)
    for net in ("gen", "det"):
        module = getattr(state, net)
        for k, p in module.named_parameters():
            if re.search(r"res\w*\.conv[12]\.bias$", k):
                continue
            ref = float(golden[f"grad_norm/{net}.{k}"])
            assert abs(float(p.grad.norm()) - ref) <= 5e-2 * ref, (net, k)
        for k, b in module.named_buffers():
            np.testing.assert_allclose(b.numpy(), golden[f"batch_stats/{net}.{k}"],
                                       rtol=1e-3, atol=1e-4, err_msg=f"{net}.{k}")


def test_flagship_npz_equals_orbax_restore():
    """The second set of trained weights: T_flagship, the same architecture
    without a shaping chain; it loads strictly and separates watermarked
    from clean on 512-sample chunks."""
    _, state, _, _ = ta.restore_shapecap(ta.FLAGSHIP_CKPT)
    want = ta.weights_arrays(state)
    with np.load(T_FLAGSHIP_NPZ) as have, np.load(SHAPECAP_NPZ) as other:
        assert sorted(have.files) == sorted(want) == sorted(other.files)
        for key, arr in want.items():
            np.testing.assert_array_equal(have[key], arr, err_msg=key)
        assert any(not np.array_equal(have[k], other[k]) for k in have.files)
    with open(os.path.join(ta.FLAGSHIP_CKPT, "awm_arch.json")) as f, open(T_FLAGSHIP_ARCH) as g:
        assert json.load(f) == json.load(g)
    model, shaping = configs_from_arch(read_arch(T_FLAGSHIP_ARCH))
    assert shaping is None
    assert model == ModelConfig(message_encoding="bits", decode_head="dilated", delta_band_hz=3000.0)
    sess = InferenceSession.from_npz(T_FLAGSHIP_NPZ, T_FLAGSHIP_ARCH, compute_dtype=torch.float32,
                                     device="cpu", chunk_len=512)
    chunks, messages = ta.golden_inputs(n=4)
    out = sess.embed_detect(chunks[:, :512], messages)
    assert (out["wm_prob"] > 0.5).all() and (out["clean_prob"] < 0.5).all()


def test_robust_golden_reproduces_from_jax(restored):
    """The JAX package's fp32 evaluate_robustness on the golden chunks -> the
    committed robust golden: probabilities and logit means to 1e-6, the
    table's columns to 1e-6."""
    want = ta.robust_golden_arrays(*restored)
    with np.load(ta.ROBUST_GOLDEN_NPZ) as have:
        assert sorted(have.files) == sorted(want)
        assert len([k for k in have.files if k.startswith("p_wm/")]) == 10
        for key, arr in want.items():
            np.testing.assert_allclose(have[key], arr, atol=1e-6, err_msg=key)


def test_robust_train_golden_reproduces_from_jax():
    """Same seed, weights and rng -> the committed robust train golden: the
    message and every attack draw exactly, terms, gradient norms and BN
    statistics to 1e-6 relative."""
    want = ta.robust_train_golden_arrays()
    with np.load(ta.ROBUST_TRAIN_GOLDEN_NPZ) as have:
        assert sorted(have.files) == sorted(want)
        for key, arr in want.items():
            if key in ("chunks", "messages") or key.startswith("draw/"):
                np.testing.assert_array_equal(have[key], arr, err_msg=key)
            else:
                np.testing.assert_allclose(have[key], arr, rtol=1e-6, atol=1e-7, err_msg=key)
        masks = [have[k] for k in have.files if k.endswith("_mask")]
        assert len(masks) == 5 and all(m.any() and not m.all() for m in masks)


def test_port_reproduces_robust_train_golden_on_cpu():
    """The port's fp32 train step under the C_robust curriculum on the
    golden's 4 chunks at T=16000 with the golden's draws: the tolerances of
    test_port_reproduces_train_golden_on_cpu (terms 1e-5 relative, BN
    statistics 1e-4 + 1e-3 relative, gradient norms 5e-2 relative)."""
    import dataclasses
    import re

    from awm_tpu_torch import train as tr
    from awm_tpu_torch.augment import AugmentConfig
    from awm_tpu_torch.checkpoint import load_into
    from awm_tpu_torch.config import get_config

    model, shaping = configs_from_arch(read_arch(SHAPECAP_ARCH))
    cfg = get_config("base")
    cfg = dataclasses.replace(cfg, model=model, shaping=shaping,
                              augment=AugmentConfig(**ta.ROBUST_AUGMENT),
                              loss=dataclasses.replace(cfg.loss, dec_loss_mode="mean"),
                              train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    state = tr.init_state(cfg, device="cpu")
    load_into(state.gen, state.det, SHAPECAP_NPZ)
    with np.load(ta.ROBUST_TRAIN_GOLDEN_NPZ) as g:
        golden = {k: g[k] for k in g.files}
    draws = {k[5:]: torch.from_numpy(v) for k, v in golden.items() if k.startswith("draw/")}
    terms = tr.train_step(cfg, state, torch.from_numpy(golden["chunks"]),
                          message=torch.from_numpy(golden["messages"]).long(), attack_draws=draws)
    for k, v in terms.items():
        np.testing.assert_allclose(float(v), golden[f"term/{k}"], rtol=1e-5, err_msg=k)
    for net in ("gen", "det"):
        module = getattr(state, net)
        for k, p in module.named_parameters():
            if re.search(r"res\w*\.conv[12]\.bias$", k):
                continue
            ref = float(golden[f"grad_norm/{net}.{k}"])
            assert abs(float(p.grad.norm()) - ref) <= 5e-2 * ref, (net, k)
        for k, b in module.named_buffers():
            np.testing.assert_allclose(b.numpy(), golden[f"batch_stats/{net}.{k}"],
                                       rtol=1e-3, atol=1e-4, err_msg=f"{net}.{k}")

"""The port's train slice vs the JAX package: BatchNorm in train mode, the
schedules, one fp32 train step from the shapecap weights (clean, under the
attack curriculum and with the ft_robust channel), freezing, the bf16 step,
validation under attacks, fit() with its checkpoints and resume, the train
CLI and the curriculum.

Inputs are seeded numpy arrays handed to both packages; the message the JAX
step draws, and its attack draws, are handed to the port's step (random
streams are never compared).  Tolerances are stated per test."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_assets as ta

from awm_tpu_torch import train as tr
from awm_tpu_torch.checkpoint import SHAPECAP_ARCH, SHAPECAP_NPZ, configs_from_arch, load_into, read_arch
from awm_tpu_torch.config import Config, ScheduleConfig, TrainConfig, get_config

T_TEST = 800
# conv biases directly followed by a train-mode BatchNorm: their gradient is
# zero analytically (BN subtracts the batch mean), so both frameworks report
# rounding noise there and only its size can be bounded
_BN_FED = re.compile(r"res\w*\.conv[12]\.bias$")


def port_config(audio_len=T_TEST, compute_dtype="float32", **train_kw):
    """The port's counterpart of torch_assets.train_config."""
    model, shaping = configs_from_arch(read_arch(SHAPECAP_ARCH))
    cfg = get_config("base")
    return dataclasses.replace(
        cfg, model=model, shaping=shaping, audio_len=audio_len,
        loss=dataclasses.replace(cfg.loss, dec_loss_mode="mean"),
        train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype, **train_kw),
    )


def shapecap_state(cfg):
    state = tr.init_state(cfg, device="cpu")
    assert load_into(state.gen, state.det, SHAPECAP_NPZ) == []
    return state


def chunks(n=2, t=T_TEST):
    return ta.golden_inputs(ta.TRAIN_SEED, n)[0][:, :t]


def named(state, what):
    """{'gen.<name>': tensor} over both networks' parameters or buffers."""
    out = {}
    for net in ("gen", "det"):
        items = getattr(getattr(state, net), f"named_{what}")()
        out.update({f"{net}.{k}": v for k, v in items})
    return out


# -- BatchNorm in train mode ---------------------------------------------------


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16], ids=["f32", "bf16"])
def test_batchnorm_train_mode_matches_flax(rng, dtype):
    """Output and running statistics after one train-mode call vs flax's
    BatchNorm (momentum 0.9, biased fast variance, fp32 statistics).  fp32:
    output 1e-5, statistics 1e-6.  bf16 compute: the same statistics (taken
    in fp32 from the same bf16 input) to 1e-6, output to one bf16 ulp (8e-3
    of values of order 1)."""
    import flax.linen as fnn

    from awm_tpu_torch.models.layers import BatchNorm

    x = (rng.standard_normal((3, 40, 8)) * 2.0 + 0.5).astype(np.float32)  # (B, T, C)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    mean0 = rng.standard_normal(8).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=dtype)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    jx = jnp.asarray(x).astype(dtype) if dtype is not None else jnp.asarray(x)
    ref, upd = bn.apply(variables, jx, mutable=["batch_stats"])

    m = BatchNorm(8)
    m.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                       "running_mean": torch.from_numpy(mean0), "running_var": torch.from_numpy(var0)})
    m.compute_dtype = torch.bfloat16 if dtype is not None else None
    tx = torch.from_numpy(x).transpose(1, 2)
    out = m.train()(tx.to(torch.bfloat16) if dtype is not None else tx)
    out = out.detach().float().transpose(1, 2).numpy()
    tol = 1e-5 if dtype is None else 8e-3 * 4
    np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)), atol=tol)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    # torch's own train-mode BN would update with the unbiased variance
    n = x.shape[0] * x.shape[1]
    unbiased = 0.9 * var0 + 0.1 * x.reshape(-1, 8).var(axis=0) * n / (n - 1)
    assert np.abs(m.running_var.numpy() - unbiased).max() > 1e-4


# -- schedules ------------------------------------------------------------------


@pytest.mark.parametrize("epochs,spe,pct", [(2, 7, 0.3), (1, 3, 0.1), (4, 25, 0.45)])
def test_onecycle_matches_optax(epochs, spe, pct):
    """Every step of the onecycle schedule (plus a few past its end), the
    clamp included ((1, 3, 0.1) has pct_start * total < 1): 1e-5 relative
    (optax evaluates in fp32, the port in float64; measured 6e-6)."""
    from awm_tpu.config import Config as JConfig, ScheduleConfig as JSch, TrainConfig as JTrain
    from awm_tpu.train import make_schedule as jsched

    sch = dict(kind="onecycle", max_lr=3e-4, pct_start=pct)
    ref = jsched(JConfig(train=JTrain(epochs=epochs, schedule=JSch(**sch))), spe)
    got = tr.make_schedule(Config(train=TrainConfig(epochs=epochs, schedule=ScheduleConfig(**sch))), spe)
    for step in range(max(epochs * spe, 10) + 5):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-5, atol=1e-12,
                                   err_msg=str(step))


def test_schedule_rejects_and_constant():
    assert tr.make_schedule(Config())(123) == 1e-3
    for bad in (0.0, 1.0):
        cfg = Config(train=TrainConfig(schedule=ScheduleConfig(kind="onecycle", pct_start=bad)))
        with pytest.raises(ValueError, match="pct_start"):
            tr.make_schedule(cfg)
    with pytest.raises(ValueError, match="schedule"):
        tr.make_schedule(Config(train=TrainConfig(schedule=ScheduleConfig(kind="step"))))
    strided = get_config("strided")  # ported: the main14b_2 family, s_w clamped
    assert strided.model.family == "strided" and strided.shaping.clamp_watermarked
    assert tr.make_schedule(strided)(0) == 1e-3
    robust = get_config("ft_robust")
    assert robust.shaping.postprocess and robust.train.epochs == 3
    assert tr.make_schedule(robust)(0) == 1e-5


# -- one train step --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step():
    """One fp32 JAX train_step (and its loss function's gradients) from the
    shapecap weights at T=800, B=2."""
    from awm_tpu import train as jtr

    cfg = ta.train_config(audio_len=T_TEST)
    state, gen, det, tx = ta.jax_state_from_npz(cfg)
    s = jnp.asarray(chunks())
    message = ta.jax_message(cfg, state, s.shape[0], seed=0)
    new_state, terms = jtr.train_step(cfg, gen, det, tx, state, s, jax.random.key(0))
    _, grads, _ = ta.jax_loss_and_grads(cfg, gen, det, state, s, message)
    return {
        "message": np.asarray(message),
        "terms": {k: float(v) for k, v in terms.items()},
        "grads": ta.torch_named({"params": grads}),
        "params": ta.torch_named({"params": new_state.params}),
        "batch_stats": ta.torch_named({"batch_stats": new_state.batch_stats}),
    }


def test_fp32_train_step_matches_jax(jax_step):
    """The port's fp32 step (the LSTM through LSTMFunction's plain B and C)
    vs the JAX package's train_step, same weights, batch and message:
    - loss terms 1e-5 relative (measured 6e-7);
    - gradients 5e-3 of each parameter's max (measured 1.6e-3, in the
      detector's train-mode BatchNorm backward, a difference of large sums);
      the conv biases fed to a train-mode BatchNorm have zero gradient
      analytically and are bounded absolutely (1e-3 of the largest
      gradient);
    - BatchNorm statistics after the step 1e-5 (absolute and relative:
      variances of order 30 differ by 2e-5);
    - parameters after Adam's first step (p - lr * g / (|g| + eps)): 1e-2 of
      lr wherever |g| is 100x its difference between the two frameworks;
      elsewhere (gradients within rounding of zero, whose sign Adam's first
      step amplifies to +-lr) within 2 lr.  test_adam_matches_optax holds
      the update rule itself."""
    cfg = port_config()
    state = shapecap_state(cfg)
    before = {k: v.detach().clone() for k, v in named(state, "parameters").items()}
    terms = tr.train_step(cfg, state, torch.from_numpy(chunks()),
                          message=torch.from_numpy(jax_step["message"]).long())
    for k, v in jax_step["terms"].items():
        np.testing.assert_allclose(float(terms[k]), v, rtol=1e-5, err_msg=k)
    params = named(state, "parameters")
    assert sorted(params) == sorted(jax_step["grads"])
    gmax = max(np.abs(g).max() for g in jax_step["grads"].values())
    lr = cfg.train.schedule.lr
    for k, p in params.items():
        ref_g, g = jax_step["grads"][k], p.grad.numpy()
        step_err = np.abs(p.detach().numpy() - jax_step["params"][k])
        assert step_err.max() <= 2 * lr + 1e-7, k
        assert not torch.equal(p.detach(), before[k]), k
        if _BN_FED.search(k):
            assert np.abs(g).max() < 1e-3 * gmax, k
            continue
        diff = np.abs(g - ref_g)
        assert diff.max() < 5e-3 * np.abs(ref_g).max(), (k, diff.max() / np.abs(ref_g).max())
        sure = np.abs(ref_g) > 100 * diff.max()
        assert sure.any() and step_err[sure].max() < 1e-2 * lr, k
    for k, b in named(state, "buffers").items():
        np.testing.assert_allclose(b.numpy(), jax_step["batch_stats"][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert state.step == 1


def test_adam_matches_optax(rng):
    """Three Adam steps on the same gradients: torch.optim.Adam as
    make_optimizer builds it vs optax.adam, 1e-7 (one fp32 ulp of the
    parameters, 1e-4 of lr)."""
    import optax

    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * 10.0**-k for k in range(3)]
    tx = optax.adam(1e-3)
    jp, jstate = jnp.asarray(p0), None
    jstate = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([p], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-7)


@pytest.mark.parametrize("frozen", ["gen", "det"])
def test_freeze_keeps_the_frozen_net(frozen):
    """freeze: the frozen network's parameters and running statistics are
    bit-identical after a step (it still normalised with batch statistics),
    the other network's both move."""
    cfg = port_config(audio_len=256, freeze=frozen)
    state = shapecap_state(cfg)
    nets = {"gen": state.gen, "det": state.det}
    before = {n: {k: v.clone() for k, v in net.state_dict().items()} for n, net in nets.items()}
    terms = tr.train_step(cfg, state, torch.from_numpy(chunks(2, 256)))
    assert all(bool(torch.isfinite(v)) for v in terms.values())
    for name, net in nets.items():
        after = net.state_dict()
        same = [torch.equal(after[k], before[name][k]) for k in after]
        if name == frozen:
            assert all(same), name
        else:
            assert not any(same[k] for k, key in enumerate(after) if "running" in key)
            assert not all(same)


def test_bf16_step_on_aggregates():
    """The bf16 step (bf16 convs, BN output and LSTM operands; fp32
    parameters, statistics and losses) vs the port's fp32 step on the same
    batch and message, on aggregates only.  Queue 3 of ROADMAP.md: the bf16
    trajectory of the trained LSTM parts from the fp32 one, and so does its
    gradient: at T=800 the LSTM's weight-gradient norm moves between 6 and 48
    when the input moves by 1e-5 relative (measured on the CPU), in the port
    and in the JAX package's own bf16 paths alike.  Held: every loss term
    within 5% (l1 within 10%); finite fp32 gradients everywhere; gradient
    norms within 25% of fp32 for the layers downstream of the LSTM (the
    generator's decoder and the detector); every parameter fp32 and moved."""
    s = torch.from_numpy(chunks())
    message = torch.tensor([12345, 54321])
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = port_config(compute_dtype=dt)
        state = shapecap_state(cfg)
        before = {k: p.detach().clone() for k, p in named(state, "parameters").items()}
        terms = tr.train_step(cfg, state, s, message=message)
        out[dt] = (terms, named(state, "parameters"), before)
    t32, t16 = out["float32"][0], out["bfloat16"][0]
    for k in t32:
        tol = 0.10 if k == "l1" else 0.05
        assert abs(float(t16[k]) - float(t32[k])) <= tol * abs(float(t32[k])), (k, t16[k], t32[k])
    upstream = re.compile(r"^gen\.(enc_|lstm\.)")
    for k, p in out["bfloat16"][1].items():
        assert p.dtype == torch.float32 and torch.isfinite(p.grad).all(), k
        assert not torch.equal(p.detach(), out["bfloat16"][2][k]), k
        if not _BN_FED.search(k) and not upstream.search(k):
            n16, n32 = float(p.grad.norm()), float(out["float32"][1][k].grad.norm())
            assert abs(n16 - n32) <= 0.25 * n32, (k, n16, n32)


def test_generator_gradients_reach_the_encoder_through_the_kernel_route(monkeypatch):
    """The repaired fault, at the model level: with the device decision faked
    as "cuda" (kernels replaced by their plain versions), one loss backward
    through the generator reaches the LSTM's weights and every layer
    upstream of it (the encoder conv and both encoder ResBlocks)."""
    from awm_tpu_torch.ops import lstm as plain
    from awm_tpu_torch.ops import lstm_kernel

    monkeypatch.setattr(lstm_kernel, "_on_card", lambda x: True)
    monkeypatch.setattr(lstm_kernel, "forward_train_kernel", plain.lstm_forward_train)
    monkeypatch.setattr(lstm_kernel, "backward_kernel", plain.lstm_backward)
    cfg = port_config(audio_len=128)
    state = shapecap_state(cfg)
    state.gen.train()
    delta = state.gen(torch.from_numpy(chunks(2, 128)), torch.tensor([1, 2]))
    delta.square().sum().backward()
    for name in ("lstm.w_ih", "lstm.w_hh", "lstm.b", "enc_conv.weight",
                 "enc_res1.conv1.weight", "enc_res2.conv2.weight"):
        grad = state.gen.get_parameter(name).grad
        assert grad is not None and float(grad.abs().sum()) > 0, name


# -- fit and the CLI -------------------------------------------------------------


def test_fit_two_tiny_epochs(tmp_path):
    """fit() on synthetic clips: two epochs, finite per-term means, the CSV
    log, the early-stopping bookkeeping, select_metric validated up front,
    and a data-parallel mesh refused before training where this process
    joined no process group (tests/test_torch_parallel.py trains on one)."""
    from awm_tpu_torch.data import BatchLoader, SyntheticClips, split_indices
    from awm_tpu_torch.trainer import fit

    cfg = port_config(audio_len=256, compute_dtype="float32", batch_size=2, quick_val_every=2)
    ds = SyntheticClips(n=10, audio_len=256)
    tr_idx, va_idx, _ = split_indices(len(ds), seed=0)
    mk = lambda idx, sh: BatchLoader(ds, 2, indices=idx, shuffle=sh, drop_last=sh, num_workers=2)
    log = tmp_path / "m.csv"
    with pytest.raises(ValueError, match="select_metric"):
        fit(cfg, mk(tr_idx, True), mk(va_idx, False), select_metric="loc,typo", device="cpu")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        fit(cfg, mk(tr_idx, True), None, mesh=object(), device="cpu")
    out = fit(cfg, mk(tr_idx, True), mk(va_idx, False), epochs=2, init_from=SHAPECAP_NPZ,
              log_path=str(log), select_metric="loc,dec", device="cpu", verbose=False)
    assert len(out["history"]) == 2 and not out["stopped_early"]
    for row in out["history"]:
        assert all(np.isfinite(v) for k, v in row.items() if k.startswith(("train_", "val_")))
        assert {"train_total", "val_loc", "val_dec"} <= set(row)
    assert out["state"].step == 2 * (len(tr_idx) // 2)
    assert out["best_val"] == min(r["val_loc"] + r["val_dec"] for r in out["history"])
    assert log.read_text().count("\n") == 3  # header + 2 epochs


def test_early_stopping():
    es = tr.EarlyStopping(patience=2, min_delta=0.1)
    for v in (1.0, 0.95, 0.5, 0.49):
        es.step(v)
    assert not es.early_stop and es.best_loss == 0.5
    es.step(0.45)
    assert es.early_stop


def test_train_cli_on_cpu(capsys):
    """python -m awm_tpu_torch train --device cpu from the shapecap weights
    with its architecture's flags, bf16 compute: one epoch, finite."""
    from awm_tpu_torch.__main__ import main

    out = main(["train", "--device", "cpu", "--audio-len", "256", "--batch-size", "2",
                "--synthetic-n", "10", "--epochs", "1", "--workers", "2",
                "--init-from", SHAPECAP_NPZ, "--message-encoding", "bits",
                "--decode-head", "dilated", "--delta-band-hz", "3000",
                "--shape-max-rms", "0.01", "--dec-loss", "mean", "--dec-bit-balance", "1.0",
                "--loss-weights", "dec=2,l1=0.2", "--lr", "1e-4", "--select-metric", "loc,dec"])
    text = capsys.readouterr().out
    assert '"epochs": 1' in text and np.isfinite(out["best_val"])
    state = out["state"]
    assert state.gen.enc_conv.compute_dtype == torch.bfloat16
    assert state.optimizer.param_groups[0]["lr"] == 1e-4


def test_eval_and_evaluate_steps_match_jax():
    """eval_step (the loss terms, BatchNorm in eval mode) and evaluate_step
    (per-example detection probabilities, bit accuracies, delta RMS) vs the
    JAX package's, fp32, T=256, with the message JAX draws from its key:
    terms 1e-5 relative, probabilities 1e-5, delta RMS 1e-6, bit accuracies
    within one bit of 16 (a time-mean logit within rounding of zero may
    decode either way)."""
    from awm_tpu import train as jtr

    jcfg = ta.train_config(audio_len=256)
    jstate, gen, det, _ = ta.jax_state_from_npz(jcfg)
    s = chunks(2, 256)
    key = jax.random.key(3)
    message = torch.from_numpy(np.asarray(
        jax.random.randint(key, (2,), 0, 2**16, dtype=jnp.int32))).long()
    ref_terms = jtr.eval_step(jcfg, gen, det, jstate, jnp.asarray(s), key)
    ref_q = jtr.evaluate_step(jcfg, gen, det, jstate, jnp.asarray(s), key)
    cfg = port_config(audio_len=256)
    state = shapecap_state(cfg)
    terms = tr.eval_step(cfg, state, torch.from_numpy(s), message=message)
    q = tr.evaluate_step(cfg, state, torch.from_numpy(s), message=message)
    for k, v in ref_terms.items():
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=1e-5, err_msg=k)
    assert sorted(q) == sorted(ref_q)
    for k, tol in (("watermarked_prob", 1e-5), ("clean_prob", 1e-5), ("delta_rms", 1e-6),
                   ("bit_accuracy", 1 / 16), ("bit_accuracy_mean_logit", 1 / 16)):
        np.testing.assert_allclose(q[k].numpy(), np.asarray(ref_q[k]), atol=tol, err_msg=k)
    assert not state.gen.training and not state.det.training


# -- the attack curriculum in the step --------------------------------------------

# the C_robust leg's curriculum (awm_tpu/__main__.py:352-354 through :258-267)
ROBUST = dict(noise_snr_db=(10.0, 40.0), volume_range=(0.3, 1.2), lowpass_hz=(3500.0, 5000.0, 7000.0),
              quantize=True, resample_hz=(8000, 11025, 22050), attack_prob=0.45)
_UPSTREAM = re.compile(r"^gen\.(enc_|lstm\.)")


def _augment_configs(**fields):
    from awm_tpu.augment import AugmentConfig as JAug
    from awm_tpu_torch.augment import AugmentConfig

    return JAug(**fields), AugmentConfig(**fields)


def _draw_tensors(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def test_fp32_robust_train_step_matches_jax():
    """One fp32 step under the C_robust curriculum (every attack with
    probability 0.45 on both halves of the 2B detector batch), B=4, T=800:
    the JAX package's train_step under its key vs the port's step with the
    message and the attack draws read off that key.  Loss terms 1e-4
    relative (measured 7e-7; an int16 step that falls the other way would
    move a detector input by 3e-5); BatchNorm statistics 1e-4 absolute and
    relative (measured 1e-5); gradients of every layer downstream of the
    LSTM 1e-2 of each parameter's max (measured 1.6e-3), those fed to a
    train-mode BatchNorm bounded absolutely."""
    from awm_tpu import train as jtr

    jaug, aug = _augment_configs(**ROBUST)
    jcfg = dataclasses.replace(ta.train_config(audio_len=T_TEST), augment=jaug)
    jstate, gen, det, tx = ta.jax_state_from_npz(jcfg)
    s = chunks(4)
    message = ta.jax_message(jcfg, jstate, 4, seed=1)
    aug_key = ta.jax_step_aug_key(jstate, seed=1)
    new_state, ref_terms = jtr.train_step(jcfg, gen, det, tx, jstate, jnp.asarray(s), jax.random.key(1))
    _, ref_grads, _ = ta.jax_loss_and_grads(jcfg, gen, det, jstate, jnp.asarray(s), message, aug_key)
    ref_grads = ta.torch_named({"params": ref_grads})
    ref_stats = ta.torch_named({"batch_stats": new_state.batch_stats})

    cfg = dataclasses.replace(port_config(), augment=aug)
    state = shapecap_state(cfg)
    draws = _draw_tensors(ta.jax_augment_draws(aug_key, jaug, 8, T_TEST))
    terms = tr.train_step(cfg, state, torch.from_numpy(s),
                          message=torch.from_numpy(np.asarray(message)).long(), attack_draws=draws)
    for k, v in ref_terms.items():
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=1e-4, err_msg=k)
    clean = tr.train_step(port_config(), shapecap_state(port_config()), torch.from_numpy(s),
                          message=torch.from_numpy(np.asarray(message)).long())
    assert abs(float(clean["loc"]) - float(terms["loc"])) > 1e-3 * float(terms["loc"])
    gmax = max(np.abs(g).max() for g in ref_grads.values())
    for k, p in named(state, "parameters").items():
        g, ref_g = p.grad.numpy(), ref_grads[k]
        if _BN_FED.search(k):
            assert np.abs(g).max() < 1e-3 * gmax, k
        elif not _UPSTREAM.search(k):
            assert np.abs(g - ref_g).max() < 1e-2 * np.abs(ref_g).max(), (k, np.abs(g - ref_g).max() / np.abs(ref_g).max())
        assert np.isfinite(g).all(), k
    for k, b in named(state, "buffers").items():
        np.testing.assert_allclose(b.numpy(), ref_stats[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_ft_robust_step_matches_jax():
    """The ft_robust preset's channel (7 kHz biquad + int16 round trip of s_w
    inside the graph) in one fp32 step from the shapecap weights, T=800: loss
    terms vs the JAX package's step 1e-4 relative, the learning rate 1e-5."""
    from awm_tpu import train as jtr
    from awm_tpu.config import get_config as jget

    jbase, base = ta.train_config(audio_len=T_TEST), port_config()
    jcfg = dataclasses.replace(jbase, shaping=dataclasses.replace(jbase.shaping, postprocess=True),
                               train=dataclasses.replace(jget("ft_robust").train, compute_dtype="float32"))
    cfg = dataclasses.replace(base, shaping=dataclasses.replace(base.shaping, postprocess=True),
                              train=dataclasses.replace(get_config("ft_robust").train, compute_dtype="float32"))
    jstate, gen, det, _ = ta.jax_state_from_npz(jcfg)
    tx = jtr.make_optimizer(jcfg)
    s = chunks()
    message = ta.jax_message(jcfg, jstate, 2, seed=2)
    _, ref_terms = jtr.train_step(jcfg, gen, det, tx, jstate, jnp.asarray(s), jax.random.key(2))
    state = shapecap_state(cfg)
    terms = tr.train_step(cfg, state, torch.from_numpy(s),
                          message=torch.from_numpy(np.asarray(message)).long())
    for k, v in ref_terms.items():
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=1e-4, err_msg=k)
    assert state.optimizer.param_groups[0]["lr"] == 1e-5
    plain = tr.eval_step(base, shapecap_state(base), torch.from_numpy(s),
                         message=torch.from_numpy(np.asarray(message)).long())
    assert float(plain["loc"]) != float(tr.eval_step(cfg, state, torch.from_numpy(s),
                                        message=torch.from_numpy(np.asarray(message)).long())["loc"])


def test_eval_step_under_attacks():
    """With a curriculum eval_step measures detection under the attacks when
    given an attack generator: the same seed gives the same bits, another
    seed and the clean validation differ (the counterpart of
    tests/test_train.py::test_eval_step_attacked_val)."""
    _, aug = _augment_configs(noise_snr_db=(5.0, 6.0), attack_prob=1.0)
    cfg = dataclasses.replace(port_config(audio_len=256), augment=aug)
    state = shapecap_state(cfg)
    s, message = torch.from_numpy(chunks(2, 256)), torch.tensor([7, 70000 % 2**16])
    gen = lambda seed: torch.Generator().manual_seed(seed)
    clean = tr.eval_step(cfg, state, s, message=message)
    att1 = tr.eval_step(cfg, state, s, message=message, attack_generator=gen(9))
    att2 = tr.eval_step(cfg, state, s, message=message, attack_generator=gen(9))
    att3 = tr.eval_step(cfg, state, s, message=message, attack_generator=gen(10))
    assert float(att1["loc"]) == float(att2["loc"])
    assert float(att1["loc"]) != float(clean["loc"])
    assert float(att1["loc"]) != float(att3["loc"])
    assert float(tr.evaluate_step(cfg, state, s, message=message)["watermarked_prob"][0]) == \
        float(tr.evaluate_step(port_config(audio_len=256), state, s, message=message)["watermarked_prob"][0])


def test_fit_attacked_validation_deterministic():
    """fit() with a curriculum validates under the attacks, identically in
    two runs (draws seeded by the run seed and the batch index, never the
    epoch), and val_attacks=False restores clean validation (the counterpart
    of tests/test_data_trainer.py::test_fit_attacked_validation_deterministic)."""
    from awm_tpu_torch.trainer import fit

    rng = np.random.default_rng(0)
    clips = (rng.standard_normal((12, 256)) * 0.1).astype(np.float32)
    tr_b, val_b = [clips[:8]], [clips[8:10], clips[10:]]

    def run(val_attacks):
        _, aug = _augment_configs(noise_snr_db=(5.0, 8.0), attack_prob=1.0, val_attacks=val_attacks)
        cfg = dataclasses.replace(port_config(audio_len=256, epochs=2, quick_val_every=1), augment=aug)
        return fit(cfg, tr_b, val_b, seed=7, verbose=False, select_metric="loc,dec", device="cpu")["history"]

    att, att2, clean = run(True), run(True), run(False)
    assert [r["val_loc"] for r in att] == [r["val_loc"] for r in att2]
    assert [r["train_total"] for r in att] == [r["train_total"] for r in att2]
    assert att[0]["val_loc"] != clean[0]["val_loc"]
    assert att[0]["train_total"] == clean[0]["train_total"]  # the same train draws either way


def test_train_cli_augment_on_cpu(capsys):
    """python -m awm_tpu_torch train --augment with the C_robust leg's flags
    (and --mulaw, --lowpass-fir) on --device cpu --audio-len 800: one epoch
    from the shapecap weights, attacked validation, finite; the flags reach
    the AugmentConfig as the JAX CLI maps them; --clean-val and
    --preset ft_robust parse."""
    from awm_tpu_torch.__main__ import _train_config, main
    from awm_tpu_torch.augment import AugmentConfig

    argv = ["train", "--device", "cpu", "--audio-len", "800", "--batch-size", "2",
            "--synthetic-n", "10", "--epochs", "1", "--workers", "2", "--compute-dtype", "float32",
            "--init-from", SHAPECAP_NPZ, "--message-encoding", "bits", "--decode-head", "dilated",
            "--delta-band-hz", "3000", "--dec-loss", "mean", "--select-metric", "loc,dec",
            "--augment", "--attack-prob", "0.45", "--noise-snr", "10,40",
            "--lowpass-hz", "3500,5000,7000", "--resample-hz", "8000,11025,22050"]
    out = main(argv + ["--mulaw", "--lowpass-fir"])
    assert '"epochs": 1' in capsys.readouterr().out and np.isfinite(out["best_val"])
    row = out["history"][0]
    assert all(np.isfinite(v) for k, v in row.items() if k.startswith(("train_", "val_")))

    import argparse
    from unittest import mock

    with mock.patch("awm_tpu_torch.__main__.cmd_train", lambda a: a):
        parsed = main(argv)
        assert _train_config(parsed).augment == AugmentConfig(**ROBUST)
        defaults = _train_config(main(["train", "--augment", "--clean-val"])).augment
        assert defaults == AugmentConfig(noise_snr_db=(15.0, 40.0), volume_range=(0.3, 1.2),
                                         lowpass_hz=7000.0, quantize=True, resample_hz=8000,
                                         attack_prob=0.35, val_attacks=False)
        assert _train_config(main(["train"])).augment is None
        assert _train_config(main(["train", "--preset", "ft_robust"])).shaping.postprocess
    assert isinstance(parsed, argparse.Namespace)


# -- checkpoints in fit, resume, the curriculum ----------------------------------


def _resume_run(tmp_path, name, epochs_per_call, **kw):
    """fit() from the shapecap weights at T=256 on an unshuffled list of
    batches (a new BatchLoader restarts its epoch count, so a resumed run's
    shuffle order would be epoch 0's, as in the JAX package), called once
    per entry of epochs_per_call on one ckpt_dir."""
    from awm_tpu_torch.trainer import fit

    cfg = port_config(audio_len=256, epochs=max(epochs_per_call), quick_val_every=2)
    clips = ta.golden_inputs(ta.TRAIN_SEED, 8)[0][:, :256]
    train_b, val_b = [clips[:2], clips[2:4], clips[4:6]], [clips[6:]]
    out = None
    for epochs in epochs_per_call:
        out = fit(cfg, train_b, val_b, epochs=epochs, ckpt_dir=str(tmp_path / name), device="cpu",
                  init_from=SHAPECAP_NPZ, seed=5, verbose=True, **kw)
    return out


def test_resume_equals_uninterrupted_run(tmp_path, capsys):
    """fit for 2 epochs equals fit for 1 epoch then a resume to 2 from
    ckpt_latest, bit for bit on the CPU: the parameters, BatchNorm
    statistics, Adam state, step and the second epoch's metrics (the
    messages drawn from (seed, step)).  The resume prints the next epoch."""
    straight = _resume_run(tmp_path, "a", [2])
    resumed = _resume_run(tmp_path, "b", [1, 2])
    assert "resumed from" in capsys.readouterr().out
    assert resumed["history"][0]["epoch"] == 1 and len(resumed["history"]) == 1
    for k in ("train_total", "val_total", "val_loc"):
        assert resumed["history"][0][k] == straight["history"][1][k], k
    a, b = straight["state"], resumed["state"]
    assert a.step == b.step == 6
    for net in ("gen", "det"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), net
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert all(torch.equal(v, ob[i][k]) for i in oa for k, v in oa[i].items())
    assert resumed["best_val"] == straight["best_val"]


def test_ckpt_best_only_on_improvement(tmp_path, monkeypatch):
    """ckpt_latest is written every epoch with epoch + 1, ckpt_best only when
    the select metric improves (here: a validation that gets worse after
    epoch 0), both with their arch sidecar; init_from takes a checkpoint
    directory as it takes an .npz (weights only: step 0, fresh Adam)."""
    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch import trainer
    from awm_tpu_torch.trainer import fit

    saves = []
    real_save = ck.save_checkpoint
    monkeypatch.setattr(ck, "save_checkpoint",
                        lambda path, state, **kw: saves.append((os.path.basename(path), kw["epoch"]))
                        or real_save(path, state, **kw))
    vals = iter([1.0, 2.0, 0.5])
    monkeypatch.setattr(trainer, "_mean_terms", lambda terms: {k: next(vals) if k == "total" else 0.0
                                                               for k in terms[0]})
    cfg = port_config(audio_len=128, epochs=3)
    clips = ta.golden_inputs(ta.TRAIN_SEED, 4)[0][:, :128]
    out = fit(cfg, [clips[:2]], None, ckpt_dir=str(tmp_path), device="cpu", init_from=SHAPECAP_NPZ,
              verbose=False)
    assert saves == [("ckpt_best", 1), ("ckpt_latest", 1), ("ckpt_latest", 2),
                     ("ckpt_best", 3), ("ckpt_latest", 3)]
    assert out["best_val"] == 0.5
    for name in ("ckpt_best", "ckpt_latest"):
        assert read_arch(str(tmp_path / name)) == read_arch(SHAPECAP_ARCH)
    monkeypatch.undo()
    state = tr.init_state(cfg, device="cpu")
    kept, epoch, best_val = ck.restore_params(str(tmp_path / "ckpt_best"), state.gen, state.det)
    assert (kept, epoch, best_val) == ([], 3, 0.5)
    warm = fit(cfg, [clips[:2]], None, epochs=1, init_from=str(tmp_path / "ckpt_best"),
               device="cpu", verbose=False)["state"]
    assert warm.step == 1 and all(int(s["step"]) == 1 for s in warm.optimizer.state_dict()["state"].values())


def test_train_cli_checkpoints_music_and_plot(tmp_path, capsys):
    """train --ckpt-dir --music-frac --loss-plot on the CPU: the corpus is
    the JAX CLI's mix (synthetic speech, then music of seed 1), ckpt_best and
    ckpt_latest with sidecars, a loss PNG where matplotlib imports; a second
    call with --epochs 2 resumes at epoch 1."""
    from unittest import mock

    from awm_tpu_torch.__main__ import main

    argv = ["train", "--device", "cpu", "--audio-len", "128", "--batch-size", "2",
            "--synthetic-n", "10", "--music-frac", "0.3", "--workers", "2", "--compute-dtype", "float32",
            "--init-from", SHAPECAP_NPZ, "--message-encoding", "bits", "--decode-head", "dilated",
            "--delta-band-hz", "3000", "--dec-loss", "mean", "--ckpt-dir", str(tmp_path / "ck"),
            "--loss-plot", str(tmp_path / "loss.png")]
    seen = {}
    real_fit = __import__("awm_tpu_torch.trainer", fromlist=["fit"]).fit

    def spy(cfg, train_b, val_b, **kw):
        seen["ds"] = train_b.dataset
        return real_fit(cfg, train_b, val_b, **kw)

    with mock.patch("awm_tpu_torch.trainer.fit", spy):
        main(argv + ["--epochs", "1"])
    ds = seen["ds"]
    assert len(ds) == 10 and [len(d) for d in ds.datasets] == [7, 3] and ds.datasets[1].seed == 1
    assert {"ckpt_best", "ckpt_latest"} <= set(os.listdir(tmp_path / "ck"))
    try:
        import matplotlib  # noqa: F401
        assert (tmp_path / "loss.png").stat().st_size > 0
    except ImportError:
        assert not (tmp_path / "loss.png").exists()
    out = main(argv + ["--epochs", "2"])
    assert "next epoch = 1" in capsys.readouterr().out
    assert [r["epoch"] for r in out["history"]] == [1]


def test_curriculum_matches_jax_table_and_resumes(tmp_path, capsys):
    """The port's _CURRICULA is the JAX package's table; curriculum --smoke
    --stop-after B_dilated runs 2 legs on the CPU (T=128), each writing
    ckpt_best with its sidecar and a .done marker, B_dilated warm-starting
    its dilated head at init from A_shared; a re-run skips both legs."""
    from awm_tpu.__main__ import _CURRICULA as JAX_CURRICULA

    from awm_tpu_torch.__main__ import _CURRICULA, main

    assert _CURRICULA == JAX_CURRICULA
    argv = ["curriculum", "robust_decode", "--out", str(tmp_path), "--smoke", "--synthetic-n", "10",
            "--batch-size", "2", "--workers", "2", "--audio-len", "128", "--device", "cpu",
            "--stop-after", "B_dilated"]
    out = main(argv)
    text = capsys.readouterr().out
    assert list(out["legs"]) == ["A_shared", "B_dilated"]
    assert re.search(r"kept init for 8 leaves .*det\.dec_dil1\.weight", text)
    for leg in ("A_shared", "B_dilated"):
        assert os.path.isfile(tmp_path / leg / ".done")
        arch = read_arch(str(tmp_path / leg / "ckpt_best"))
        assert arch["decode_head"] == ("shared" if leg == "A_shared" else "dilated")
        assert arch["message_encoding"] == "bits" and arch["delta_band_hz"] == 3000.0
    again = main(argv)
    assert capsys.readouterr().out.count("already done, skipping") == 2
    assert again == out
    with pytest.raises(SystemExit, match="not a leg"):
        main(argv[:-1] + ["Z_leg"])

"""The port's entry points (awm_tpu_torch/entry.py) vs the JAX
package's (__graft_entry__.py), on the CPU.

- entry(): the base preset's forward through the bridge (the JAX seed-0
  weights passed in as numpy), B=2 speech-like clips at T=16000, against
  the JAX forward: at fp32 compute and at the preset's bf16; the contract
  shapes of tests/test_parallel.py::test_entry_contract.
- dryrun_multichip(): 4 gloo ranks, mesh (2, 2), from the JAX init with
  the JAX step's messages at fp32 compute (run_dry), against the JAX
  single-device train step by torch_parallel_worker.check_step's rules, the
  encoder's parameters by _check_encoder's, and why (the port's one-process
  step under a 1e-6 change of the input); 1 rank in process, the (n, 1)
  branch, at the preset's bf16; a rank that fails makes the call raise.
Inputs come from numpy seeds; every spawned rank has a deadline.
Tolerances are stated per test."""

import dataclasses
import re
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_assets as ta
import torch_parallel_worker as pw

from awm_tpu import train as jtr
from awm_tpu.config import get_config as jget

from awm_tpu_torch import entry as pe

ROOT = pw.REPO
# The generator's encoder, whose gradients a change of the input within
# rounding moves by more than check_step allows
# (test_encoder_gradients_move_under_a_rounding_change), its bound as a group
# (||g - g_ref|| / ||g_ref||; measured 1.1e-3), and the share of each of its
# parameters whose update must be the reference's (_check_encoder; measured
# 0.97).
ENCODER = re.compile(r"^gen\.enc_")
ENCODER_DRIFT = 5e-3
SURE_SHARE = 0.9


def _drift(got, want, names) -> float:
    """||g - g_ref|| / ||g_ref|| over the named gradients taken together."""
    diff = sum(float(np.square(np.float64(got[k]) - want[k]).sum()) for k in names)
    return (diff / sum(float(np.square(np.float64(want[k])).sum()) for k in names)) ** 0.5


def _jax_forward(compute_dtype):
    """(forward, state) of __graft_entry__.entry() at compute_dtype (None:
    the preset's, which is that function itself)."""
    if compute_dtype is None:
        sys.path.insert(0, ROOT)
        import __graft_entry__ as g

        fn, _ = g.entry()
        state, _, _ = jtr.init_state(jget("base"), jax.random.key(0))  # the weights entry() drew
        return fn, state
    cfg = jget("base")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype))
    state, gen, det = jtr.init_state(cfg, jax.random.key(0))

    def fn(s, message):  # __graft_entry__.py:26-38
        delta = gen.apply({"params": state.params["gen"], "batch_stats": state.batch_stats["gen"]},
                          s, message)
        s_w = s + delta
        return s_w, det.apply({"params": state.params["det"], "batch_stats": state.batch_stats["det"]},
                              jnp.concatenate([s_w, s], axis=0))

    return fn, state


# compute dtype -> (s_w max abs, logits max abs, logits mean abs).  fp32:
# two correct fp32 forwards in other summation orders (measured 4.2e-7 and
# 3.3e-7 on the CPU).  bf16 (the preset's, as the JAX entry runs it): every
# conv rounds its output to bf16 (2^-8 relative) after summing in its own
# framework's order, and the JAX CPU scan multiplies the fp32 h by bf16
# weights where the port rounds h first as the kernel does (ROADMAP Queue 3),
# so a value near a rounding boundary lands one ulp over, and the ulp is
# 2e-3-4e-3 at the outputs' scale (|s_w| and |logits| up to 0.5): measured
# 5.9e-3 max, 5.1e-4 mean on the logits.
ENTRY_TOL = {"float32": (1e-5, 1e-4, 1e-5), None: (2e-2, 2e-2, 2e-3)}


@pytest.mark.parametrize("compute_dtype", ["float32", None], ids=["f32", "preset-bf16"])
def test_entry_matches_jax_entry(compute_dtype):
    """The port's entry() with the JAX seed-0 weights through
    variables_from_flax equals the JAX forward on two speech-like clips and
    random messages, by ENTRY_TOL; (2B, 16000, 17) logits, fp32 outputs."""
    fn_j, state = _jax_forward(compute_dtype)
    variables = {"params": ta.jax_to_np(state.params), "batch_stats": ta.jax_to_np(state.batch_stats)}
    s, _ = ta.golden_inputs(seed=11, n=2)
    msg = np.random.default_rng(12).integers(0, 2**16, 2)
    sw_j, lg_j = (np.asarray(a, np.float32) for a in jax.jit(fn_j)(jnp.asarray(s), jnp.asarray(msg, jnp.int32)))
    fn, (s0, m0) = pe.entry(device="cpu", variables=variables, compute_dtype=compute_dtype)
    assert s0.device.type == "cpu" and m0.device.type == "cpu"
    s_w, logits = fn(torch.from_numpy(s), torch.from_numpy(msg))
    assert s_w.dtype == logits.dtype == torch.float32 and not s_w.requires_grad
    assert tuple(s_w.shape) == (2, 16000) and tuple(logits.shape) == (4, 16000, 17)
    tol_sw, tol_lg, tol_mean = ENTRY_TOL[compute_dtype]
    err_lg = np.abs(logits.numpy() - lg_j)
    assert np.abs(s_w.numpy() - sw_j).max() <= tol_sw
    assert err_lg.max() <= tol_lg and err_lg.mean() <= tol_mean, (err_lg.max(), err_lg.mean())


def test_entry_contract():
    """As tests/test_parallel.py::test_entry_contract holds the JAX entry:
    the example arguments are four zero clips and int64 messages, and the
    forward maps them to s_w (4, 16000) and logits (8, 16000, 17), finite;
    the seed-0 init is the same twice."""
    fn, args = pe.entry(device="cpu")
    s, message = args
    assert tuple(s.shape) == (4, 16000) and s.dtype == torch.float32 and not s.any()
    assert tuple(message.shape) == (4,) and message.dtype == torch.int64
    s_w, logits = fn(*args)
    assert tuple(s_w.shape) == (4, 16000) and tuple(logits.shape) == (8, 16000, 17)
    assert bool(torch.isfinite(s_w).all()) and bool(torch.isfinite(logits).all())
    fn2, _ = pe.entry(device="cpu")
    s_w2, _ = fn2(s[:1], message[:1])
    assert torch.equal(s_w2, s_w[:1])


@pytest.fixture(scope="module")
def jax_dry_step(tmp_path_factory):
    """The JAX package's single-device fp32 step of the dry run's batch
    from its seed-0 init: (cfg, init .npz, messages .npy, message, terms,
    ref), ref mapping each parameter to its value after the step and
    "grad.<name>" to its gradient, in the port's names."""
    d = tmp_path_factory.mktemp("jax_dry_step")
    cfg = dataclasses.replace(jget("base"), audio_len=pe.AUDIO_LEN)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    state, gen, det = jtr.init_state(cfg, jax.random.key(0))
    init, msgs = d / "init.npz", d / "messages.npy"
    np.savez(init, **ta.flatten({"params": ta.jax_to_np(state.params),
                                 "batch_stats": ta.jax_to_np(state.batch_stats)}))
    message = ta.jax_message(cfg, state, 8, seed=0)
    np.save(msgs, np.asarray(message))
    tx = jtr.make_optimizer(cfg)
    terms, grads, _ = ta.jax_loss_and_grads(cfg, gen, det, state, jnp.asarray(pe.dry_batch(4)), message)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    ref = {**ta.torch_named({"params": optax.apply_updates(state.params, updates)}),
           **{f"grad.{k}": v for k, v in ta.torch_named({"params": grads}).items()}}
    return cfg, str(init), str(msgs), np.asarray(message), {k: float(v) for k, v in terms.items()}, ref


def _check_encoder(got, ref, lr, names) -> tuple[float, float]:
    """The encoder's leaves (names): their gradients as a group within
    ENCODER_DRIFT of the reference's, and each updated parameter within
    1e-2 lr of the reference wherever the gradient's sign is sure (|g_ref|
    above 10x the gradients' difference there and 100x Adam's eps; Adam's
    first step moves every element by about lr, so an update of 0 or of the
    other sign is off by lr or 2 lr), which must hold for at least
    SURE_SHARE of each parameter's elements, and within 2 lr everywhere; a
    conv bias fed to a train-mode BatchNorm (zero gradient analytically) by
    check_grads' rule.  Returns (the drift, the least sure share)."""
    drift = _drift(got, ref, [f"grad.{k}" for k in names])
    assert drift <= ENCODER_DRIFT, drift
    gmax = max(np.abs(ref[f"grad.{k}"]).max() for k in names)
    least = 1.0
    for k in names:
        g, g_ref = np.float64(got[f"grad.{k}"]), np.float64(ref[f"grad.{k}"])
        step_err = np.abs(np.float64(got[k]) - ref[k])
        assert step_err.max() <= 2 * lr + 1e-7, (k, step_err.max() / lr)
        if pw.BN_FED.search(k):
            assert np.abs(g).max() < 1e-3 * gmax, (k, np.abs(g).max() / gmax)
            continue
        sure = (np.abs(g_ref) > 10 * np.abs(g - g_ref)) & (np.abs(g_ref) > 1e-6)
        least = min(least, float(sure.mean()))
        assert sure.mean() >= SURE_SHARE, (k, sure.mean())
        assert step_err[sure].max() < 1e-2 * lr, (k, step_err[sure].max() / lr)
    return drift, least


def test_dryrun_four_ranks_matches_jax_step(tmp_path, jax_dry_step):
    """dryrun_multichip's 4 ranks on the CPU (run_dry: the options the
    public call keeps out), mesh (2, 2), the 2^16 x 64 table cut into two
    halves over the model axis, the sharded LSTM gradient within 1e-4
    (measured 6e-8).  From the JAX seed-0 init (fp32 compute) with the JAX
    step's messages, its step against the JAX package's single-device step
    on the same 8 clips: loss terms 1e-5 relative; the gradients and the
    updated parameters, the gathered table and the LSTM included, by
    check_step (5e-3 of each parameter's largest gradient; parameters
    within 1e-2 lr where the gradient is clearly nonzero, 2 lr elsewhere).
    Except the generator's encoder (ENCODER), held by _check_encoder
    (measured: drift 1.1e-3): the sharded step's summation order moves
    gen.enc_res2.conv2.weight's gradient by 0.84% of its largest entry from
    the JAX step's, as a 1e-6 relative change of the input moves the port's
    own one-process step's."""
    cfg, init, msgs, _, terms, ref = jax_dry_step
    spec = pe.dry_spec(4, "cpu", str(tmp_path / "run"), compute_dtype="float32", init=init, messages=msgs,
                       keep=True)
    res = pe.run_dry(spec, timeout=300)
    assert res["mesh"] == {"data": 2, "model": 2}
    assert res["table_rows"] == [[0, 2**15], [2**15, 2**16]]
    assert res["lstm_grad_err"] < 1e-4 and np.isfinite(res["loss"])
    assert all(all(v == 0 for v in launched.values()) for launched in res["launches"])  # CPU: no kernel
    for k, v in terms.items():
        np.testing.assert_allclose(res["terms"][k], v, rtol=1e-5, err_msg=k)
    got = dict(np.load(tmp_path / "run" / "state.npz"))
    params = sorted(k for k in ref if not k.startswith("grad."))
    assert got["gen.embedding.weight"].shape == (2**16, 64)
    assert sorted(k for k in got if k.startswith("grad.")) == [f"grad.{k}" for k in params]
    assert any(k.startswith("gen.lstm.") for k in params)
    lr = cfg.train.schedule.lr
    pw.check_step(got, ref, lr, [k for k in params if not ENCODER.search(k)])
    _check_encoder(got, ref, lr, [k for k in params if ENCODER.search(k)])


def test_encoder_gradients_move_under_a_rounding_change(jax_dry_step):
    """Why the encoder is held by _check_encoder: the port's one-process fp32
    step from the same init, batch and messages matches the JAX step by
    check_step on every parameter, the encoder's included; on the batch
    times (1 + 1e-6) its gen.enc_res2.conv2.weight gradient moves by more
    than check_grads allows (5e-3 of its largest entry; measured 8.4e-3,
    from a ReLU input within rounding of zero), as the sharded step's
    summation order moves it, while the encoder as a group passes
    _check_encoder (measured drift 1.1e-3, as the sharded step's)."""
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.checkpoint import load_into
    from awm_tpu_torch.parallel import full_grads, full_state_dicts

    cfg, init, _, message, _, ref = jax_dry_step
    batch = pe.dry_batch(4)
    steps = []
    for scale in (1.0, 1.0 + 1e-6):
        state = tr.init_state(cfg, seed=0, device="cpu")
        assert load_into(state.gen, state.det, init) == []
        tr.train_step(cfg, state, torch.from_numpy(batch * np.float32(scale)),
                      message=torch.from_numpy(message.copy()).long())
        sds = full_state_dicts(state)
        step = {f"{net}.{k}": v.numpy() for net in ("gen", "det") for k, v in sds[net].items()}
        step.update({f"grad.{k}": v.numpy() for k, v in full_grads(state).items()})
        steps.append(step)
    params = sorted(k for k in ref if not k.startswith("grad."))
    encoder = [k for k in params if ENCODER.search(k)]
    lr = cfg.train.schedule.lr
    pw.check_step(steps[0], ref, lr, params)
    _check_encoder(steps[1], steps[0], lr, encoder)
    k = "gen.enc_res2.conv2.weight"
    moved = np.abs(steps[1][f"grad.{k}"] - steps[0][f"grad.{k}"]).max() / np.abs(steps[0][f"grad.{k}"]).max()
    assert moved > 5e-3, moved


def test_dryrun_one_rank_in_process(capsys):
    """dryrun_multichip(1, "cpu") in this process at the preset's bf16
    compute: the (n, 1) branch, one rank holding the whole table, a finite
    loss, the LSTM gradient within 1e-4, the JAX line's form printed; the
    process is in no group afterwards."""
    res = pe.dryrun_multichip(1, "cpu")
    assert res["mesh"] == {"data": 1, "model": 1} and res["table_rows"] == [[0, 2**16]]
    assert np.isfinite(res["loss"]) and res["lstm_grad_err"] < 1e-4
    assert "dryrun_multichip OK: mesh={'data': 1, 'model': 1} loss=" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    assert pe.mesh_shape(3) == {"data": 3, "model": 1} and pe.mesh_shape(8) == {"data": 4, "model": 2}


def test_dryrun_raises_when_a_rank_fails(tmp_path):
    """A rank that fails (here: an init file that does not exist) makes the
    call raise with that rank's output, and no rank is left running."""
    spec = pe.dry_spec(2, "cpu", str(tmp_path), init=str(tmp_path / "missing.npz"))
    with pytest.raises(RuntimeError, match="rank[01] exited"):
        pe.run_dry(spec, timeout=120)


def test_lstm_check_inputs_are_the_contracts():
    """The gradient check's inputs: x (n, 32, 16), weights (64, 16), bias
    (64,), fp32, the same for the same n; the batch (2n, 512)."""
    x, w_ih, w_hh, b = pe.lstm_check_inputs(4)
    assert x.shape == (4, 32, 16) and w_ih.shape == w_hh.shape == (64, 16) and b.shape == (64,)
    assert all(a.dtype == np.float32 for a in (x, w_ih, w_hh, b))
    assert np.array_equal(x, pe.lstm_check_inputs(4)[0])
    assert pe.dry_batch(4).shape == (8, 512)


def test_cli_dispatch(monkeypatch, capsys):
    """python -m awm_tpu_torch.entry runs entry()'s function and prints the
    shapes; --dryrun N runs the dry run on the device given."""
    calls = []
    monkeypatch.setattr(pe, "dryrun_multichip", lambda n, device: calls.append((n, device)))
    assert pe.main(["--dryrun", "4", "--device", "cpu"]) == 0 and calls == [(4, "cpu")]
    monkeypatch.setattr(pe, "entry", lambda device: (lambda s, m: (s, m), (torch.zeros(4, 8), torch.zeros(4))))
    assert pe.main(["--device", "cpu"]) == 0
    assert "entry OK: ((4, 8), (4,))" in capsys.readouterr().out

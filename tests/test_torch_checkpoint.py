"""The port's packaged assets stay true to the JAX package.

- assets/shapecap.npz equals the orbax restore of
  evidence/r5/shapecap/ckpt_best, and assets/awm_arch.json its sidecar;
- assets/t_flagship.npz and assets/t_flagship_arch.json equal
  evidence/r5/T_flagship/ckpt_best the same way;
- assets/shapecap_golden.npz, train_golden.npz, robust_golden.npz,
  robust_train_golden.npz and strided_golden.npz are what the JAX package
  computes now;
- the port loads the .npz and reproduces the goldens on the CPU (the robust
  table's check is in tests/test_torch_eval.py).
"""

import contextlib
import dataclasses
import io
import json
import os
import re

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
    load_npz,
    read_arch,
    variables_from_flax,
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


def test_strided_golden_reproduces_from_jax():
    """The strided preset's weights drawn again from the stored seed, the
    JAX package's fp32 session and train-step loss function -> the committed
    strided golden (inputs exactly; outputs, terms and gradient norms to
    1e-6 relative, allowing for threaded CPU reductions).  The port's side
    is in tests/test_torch_strided.py."""
    want = ta.strided_golden_arrays()
    with np.load(ta.STRIDED_GOLDEN_NPZ) as have:
        assert sorted(have.files) == sorted(want)
        for key in ("seed", "chunks", "messages", "train/chunks", "train/messages"):
            np.testing.assert_array_equal(have[key], want[key], err_msg=key)
        for key in set(want) - {"seed", "chunks", "messages", "train/chunks", "train/messages"}:
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


# -- restore_params: the JAX package's warm-start rules -------------------------

# Templates against the shapecap checkpoint (bits encoder, dilated head): a
# table encoder (its embedding stays at init), a shared decode head (the
# checkpoint's dilated head is ignored), the shapecap architecture with one
# leaf of another shape (det conv_out's weight with kernel 3; it counts as
# absent, its bias restores), and a network of another family (no shared
# leaf: raises).
SHAPECAP_MODEL = dict(message_encoding="bits", decode_head="dilated", delta_band_hz=3000.0)
WARM_START_CASES = {
    "table_encoder": dict(SHAPECAP_MODEL, message_encoding="table"),
    "shared_head": dict(SHAPECAP_MODEL, decode_head="shared"),
    "shape_mismatch": SHAPECAP_MODEL,
    "no_shared_leaf": None,
}
MISMATCHED_SHAPE = (17, 64, 3)  # torch layout of det conv_out's weight; flax (3, 64, 17)


class _Foreign(torch.nn.Module):
    """A network of no family the checkpoint knows."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 4, bias=False)


def _jax_warm_start(case):
    """(outcome, kept-at-init names in the port's dotted form) of the JAX
    package's restore_params(allow_missing=True) on the orbax tree; the names
    are read off what it prints."""
    import jax
    import jax.numpy as jnp

    from awm_tpu import checkpoint as jck
    from awm_tpu import train as jtr
    from awm_tpu.config import ModelConfig as JModel

    cfg = ta.shapecap_config()
    if WARM_START_CASES[case] is None:
        state, _, _ = jtr.init_state(cfg, jax.random.key(0))
        leaf = {"proj": {"kernel": np.zeros((3, 4), np.float32)}}
        state = state.replace(params={"gen": leaf, "det": leaf}, batch_stats={"gen": {}, "det": {}})
    else:
        cfg = dataclasses.replace(cfg, model=JModel(**WARM_START_CASES[case]))
        state, _, _ = jtr.init_state(cfg, jax.random.key(0))
    if case == "shape_mismatch":
        det = dict(state.params["det"])
        det["conv_out"] = dict(det["conv_out"], w=jnp.zeros(MISMATCHED_SHAPE[::-1], jnp.float32))
        state = state.replace(params=dict(state.params, det=det))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            jck.restore_params(ta.CKPT, state, allow_missing=True)
    except ValueError:
        return "raises", None
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("restore_params: kept init")]
    skipped = re.split(r", (?=state/)", lines[0].split(": state/", 1)[1]) if lines else []
    skipped = [s if s.startswith("state/") else "state/" + s for s in skipped]
    kept = []
    for item in skipped:
        _, part, net, *path = item.split(" (shape")[0].split("/")
        kept += [f"{net}.{k}" for k in ta.port_names(ta.jax_to_np(getattr(state, part)[net]), part, path)]
    return "returns", sorted(kept)


def _port_template(case):
    from awm_tpu_torch.models import build_models

    if WARM_START_CASES[case] is None:
        return _Foreign(), _Foreign()
    gen, det = build_models(ModelConfig(**WARM_START_CASES[case]))
    if case == "shape_mismatch":
        det.conv_out.weight = torch.nn.Parameter(torch.zeros(MISMATCHED_SHAPE))
    return gen, det


@pytest.mark.parametrize("case", list(WARM_START_CASES))
def test_restore_params_warm_start_matches_jax(case, capsys):
    """The repaired fault: the port's params-only restore follows the JAX
    package's rules on the same checkpoint (the orbax tree for JAX, its .npz
    twin for the port): the same leaves kept at init, named in the port's
    dotted form, and the same outcome.  Kept leaves hold their initial
    values, every other leaf the checkpoint's; without allow_missing an
    absent leaf raises."""
    from awm_tpu_torch.checkpoint import load_into

    want_outcome, want_kept = _jax_warm_start(case)
    gen, det = _port_template(case)
    before = {f"{n}.{k}": v.clone() for n, net in (("gen", gen), ("det", det))
              for k, v in net.state_dict().items()}
    try:
        kept = load_into(gen, det, SHAPECAP_NPZ)
    except ValueError as e:
        assert want_outcome == "raises" and "shares no parameter" in str(e), e
        return
    assert want_outcome == "returns" and sorted(kept) == want_kept
    assert f"kept init for {len(kept)} leaves" in capsys.readouterr().out or not kept
    tree = load_npz(SHAPECAP_NPZ)
    src = {f"{n}.{k}": v for n in ("gen", "det") for k, v in variables_from_flax(
        {p: tree[p][n] for p in ("params", "batch_stats")}).items()}
    for n, net in (("gen", gen), ("det", det)):
        for k, v in net.state_dict().items():
            name = f"{n}.{k}"
            assert torch.equal(v, before[name] if name in kept else src[name]), name
    if kept:
        from awm_tpu_torch.checkpoint import restore_params

        with pytest.raises(ValueError, match="allow_missing"):
            restore_params(SHAPECAP_NPZ, *_port_template(case))


# -- checkpoints of the port ------------------------------------------------------


def _small_state(seed):
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.config import get_config

    base = get_config("base")
    cfg = dataclasses.replace(base, audio_len=128,
                              train=dataclasses.replace(base.train, compute_dtype="float32"))
    return cfg, tr.init_state(cfg, seed=seed, device="cpu")


def test_checkpoint_round_trip_is_exact(tmp_path):
    """save_checkpoint then restore_checkpoint into a state of another init:
    every parameter, BatchNorm statistic and Adam moment equal bit for bit,
    step, epoch and best_val back; saving over a checkpoint leaves no
    temporary file; the arch sidecar sits beside the state file."""
    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch import train as tr

    cfg, state = _small_state(1)
    x = torch.from_numpy(ta.golden_inputs(n=2)[0][:, :128])
    for _ in range(2):
        tr.train_step(cfg, state, x)
    path = str(tmp_path / "ckpt_latest")
    ck.save_checkpoint(path, state, epoch=3, best_val=1.25, model_cfg=cfg.model)
    ck.save_checkpoint(path, state, epoch=3, best_val=1.25, model_cfg=cfg.model)
    assert sorted(os.listdir(path)) == [ck.ARCH_FILE, ck.STATE_FILE]
    _, other = _small_state(2)
    restored, epoch, best_val = ck.restore_checkpoint(path, other)
    assert (epoch, best_val, restored.step) == (3, 1.25, 2)
    for net in ("gen", "det"):
        a, b = getattr(state, net).state_dict(), getattr(restored, net).state_dict()
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a), net
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, moments in sa["state"].items():
        assert all(torch.equal(v, sb["state"][i][k]) for k, v in moments.items())
    assert ck.maybe_resume(str(tmp_path), _small_state(3)[1])[1:] == (3, 1.25, True)
    assert ck.maybe_resume(str(tmp_path / "none"), other)[1:] == (0, float("inf"), False)


@pytest.mark.parametrize("shaped", [True, False, "channels48"], ids=["shapecap", "default", "channels48"])
def test_arch_sidecars_cross_read(tmp_path, shaped):
    """The JAX package's write_arch and the port's give the same dict for the
    same configuration, and each package's read_arch parses the other's
    sidecar back to that configuration.  At channels=48 (a width the LSTM
    kernels take masked) the sidecar carries the width, and the bridge
    (seeded_flax_tree, variables_from_flax) loads the networks built from
    it strictly, LSTM(48, 48) included."""
    from awm_tpu import checkpoint as jck
    from awm_tpu.config import ModelConfig as JModel, ShapingConfig as JShaping
    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch.models import build_models

    model = (dict(channels=48) if shaped == "channels48"
             else dict(message_encoding="bits", decode_head="dilated", delta_band_hz=3000.0) if shaped else {})
    shaped = shaped is True
    shaping = dict(enabled=True, max_rms=0.01) if shaped else {}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jck.write_arch(str(tmp_path / "jax"), JModel(**model), JShaping(**shaping))
    ck.write_arch(str(tmp_path / "port"), ModelConfig(**model), ShapingConfig(**shaping))
    jdoc, pdoc = jck.read_arch(str(tmp_path / "port")), ck.read_arch(str(tmp_path / "jax"))
    assert jdoc == pdoc
    assert ("shaping" in pdoc) == shaped
    assert configs_from_arch(pdoc) == (ModelConfig(**model), ShapingConfig(**shaping) if shaped else None)
    if shaped:
        assert pdoc == read_arch(SHAPECAP_ARCH)
    if model.get("channels"):
        cfg = configs_from_arch(pdoc)[0]
        assert pdoc["channels"] == cfg.channels == 48
        variables = ck.variables_from_flax(ck.seeded_flax_tree(cfg, 0))
        for net, name in zip(build_models(cfg), ("gen", "det")):
            net.load_state_dict({k[len(name) + 1:]: v for k, v in variables.items() if k.startswith(name + ".")},
                                strict=True)
        assert tuple(build_models(cfg)[0].lstm.w_ih.shape) == (192, 48)


def test_orbax_checkpoint_is_refused_with_the_npz_crossing():
    """The port reads no orbax tree: restore_params, the session and the
    CLI's --ckpt name the .npz crossing instead."""
    from awm_tpu_torch.__main__ import main
    from awm_tpu_torch.checkpoint import restore_params
    from awm_tpu_torch.models import build_models

    model, _ = configs_from_arch(read_arch(SHAPECAP_ARCH))
    with pytest.raises(ValueError, match=r"orbax.*\.npz.*torch_assets"):
        restore_params(ta.CKPT, *build_models(model))
    with pytest.raises(ValueError, match="orbax"):
        InferenceSession.from_checkpoint(ta.CKPT, device="cpu")
    with pytest.raises(ValueError, match=r"\.npz"):
        main(["detect", "x.wav", "--ckpt", ta.CKPT, "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        restore_params(os.path.dirname(ta.CKPT), *build_models(model))


# -- the reference's .pth importers -----------------------------------------------


def _reference_state_dicts(seed, channels=8, bits=16):
    """Seeded state dicts in the reference's key layout (main14's Generator
    with an Embedding(2^bits) table and its residual Detector)."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.2).astype(np.float32))
    c = channels

    def conv(key, o, i, k):
        return {f"{key}.weight": t(o, i, k), f"{key}.bias": t(o)}

    def res(key):
        out = {}
        for conv_i, bn_i in ((0, 1), (3, 4)):
            out.update(conv(f"{key}.block.{conv_i}", c, c, 3))
            out.update({f"{key}.block.{bn_i}.weight": 1 + t(c), f"{key}.block.{bn_i}.bias": t(c),
                        f"{key}.block.{bn_i}.running_mean": t(c),
                        f"{key}.block.{bn_i}.running_var": 1 + t(c).abs(),
                        f"{key}.block.{bn_i}.num_batches_tracked": torch.tensor(7)})
        return out

    gen = {**conv("encoder.0", c, 1, 7), **res("encoder.1"), **res("encoder.2"),
           "lstm.weight_ih_l0": t(4 * c, c), "lstm.weight_hh_l0": t(4 * c, c),
           "lstm.bias_ih_l0": t(4 * c), "lstm.bias_hh_l0": t(4 * c),
           "embedding.weight": t(2**bits, c),
           "decoder.0.weight": t(c, c, 7), "decoder.0.bias": t(c), **res("decoder.1"),
           **conv("decoder.2", 1, c, 1)}
    det = {**conv("model.0", c, 1, 7), **res("model.1"), **res("model.2"), **conv("model.3", 1 + bits, c, 1)}
    return gen, det


@pytest.mark.parametrize("prefix", ["", "_orig_mod."], ids=["plain", "compiled"])
def test_pth_importers_match_jax(tmp_path, prefix):
    """Seeded reference-layout .pth files (the second with torch.compile's
    _orig_mod. prefix) through the JAX importers + variables_from_flax and
    through the port's importers: equal tensors, the LSTM biases summed, and
    fp32 sessions over them within 1e-5 on embed_detect (T=400)."""
    import jax.numpy as jnp

    from awm_tpu import checkpoint as jck
    from awm_tpu.api import InferenceSession as JSession
    from awm_tpu.models import Detector as JDet, Generator as JGen
    from awm_tpu_torch.checkpoint import import_torch_detector, import_torch_generator, variables_from_flax
    from awm_tpu_torch.models import Detector, Generator

    gsd, dsd = _reference_state_dicts(0)
    paths = {}
    for name, sd in (("gen", gsd), ("det", dsd)):
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save({prefix + k: v for k, v in sd.items()}, paths[name])
    port = {"gen": import_torch_generator(paths["gen"]), "det": import_torch_detector(paths["det"])}
    jvars = {"gen": jck.import_torch_generator(paths["gen"]), "det": jck.import_torch_detector(paths["det"])}
    for name in ("gen", "det"):
        want = variables_from_flax(ta.jax_to_np(jvars[name]))
        assert sorted(port[name]) == sorted(want), name
        for k, v in want.items():
            assert torch.equal(port[name][k], v), (name, k)
    assert torch.equal(port["gen"]["lstm.b"], gsd["lstm.bias_ih_l0"] + gsd["lstm.bias_hh_l0"])

    gen, det = Generator(channels=8), Detector(channels=8)
    gen.load_state_dict(port["gen"])
    det.load_state_dict(port["det"])
    sess = InferenceSession(gen, det, compute_dtype=torch.float32, chunk_len=400, device="cpu")
    jsess = JSession(JGen(channels=8), JDet(channels=8), jvars["gen"], jvars["det"],
                     chunk_len=400, compute_dtype=jnp.float32)
    chunks, messages = ta.golden_inputs(n=3)
    got = sess.embed_detect(chunks[:, :400], messages)
    want = jsess.embed_detect(chunks[:, :400], messages)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-5, err_msg=key)


def test_session_from_checkpoint_and_state(tmp_path):
    """The shapecap weights written as a checkpoint of the port: a session
    over the directory (adopting its arch and shaping sidecar) equals
    from_npz bit for bit on embed_chunks and embed_detect (fp32, T=256), and
    from_state over the same TrainState does too; the CLI's --ckpt loads it,
    and an architecture flag that contradicts the sidecar exits."""
    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch import train as tr
    from awm_tpu_torch.__main__ import _load_session, parse_args
    from awm_tpu_torch.config import get_config

    model, shaping = configs_from_arch(read_arch(SHAPECAP_ARCH))
    cfg = dataclasses.replace(get_config("base"), model=model, shaping=shaping, audio_len=256)
    state = tr.init_state(cfg, device="cpu")
    ck.load_into(state.gen, state.det, SHAPECAP_NPZ)
    path = str(tmp_path / "ckpt_best")
    ck.save_checkpoint(path, state, epoch=1, model_cfg=cfg.model, shaping_cfg=cfg.shaping)
    assert read_arch(path) == read_arch(SHAPECAP_ARCH)
    kw = dict(compute_dtype=torch.float32, device="cpu", chunk_len=256)
    sessions = [InferenceSession.from_checkpoint(path, **kw), InferenceSession.from_npz(**kw),
                InferenceSession.from_state(cfg, state, compute_dtype=torch.float32)]
    chunks, messages = ta.golden_inputs(n=2)
    outs = [(s.embed_chunks(chunks[:, :256], messages), s.embed_detect(chunks[:, :256], messages))
            for s in sessions]
    for delta, summary in outs[1:]:
        assert np.array_equal(delta, outs[0][0])
        assert all(np.array_equal(summary[k], outs[0][1][k]) for k in summary)
    assert all(s.shaping == shaping for s in sessions)
    cli = _load_session(parse_args(["detect", "x.wav", "--ckpt", path, "--device", "cpu", "--audio-len",
                                    "256", "--compute-dtype", "float32", "--decode-head", "dilated"]))
    assert np.array_equal(cli.embed_chunks(chunks[:, :256], messages), outs[0][0])
    with pytest.raises(SystemExit, match="conflicts"):
        _load_session(parse_args(["detect", "x.wav", "--ckpt", path, "--device", "cpu",
                                  "--decode-head", "shared"]))

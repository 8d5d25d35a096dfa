"""The strided family (main14b_2) of the port against the JAX package, on
the CPU: the models against the flax modules, the two stacked LSTMs'
gradients against jax.grad, build_models' refusals, the sidecar and the
flax bridge for strided trees, the seeded weights against the JAX tree, the
.pth importers, the session and one fp32 train step against
assets/strided_golden.npz, the preset and the CLI.

Inputs are seeded numpy arrays handed to both packages; tolerances are
stated per test."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_assets as ta
from test_checkpoint import _torch_strided_pair

from awm_tpu.models import StridedDetector as JDetector, StridedGenerator as JGenerator

from awm_tpu_torch.checkpoint import (
    configs_from_arch,
    import_torch_strided_detector,
    import_torch_strided_generator,
    read_arch,
    seeded_flax_tree,
    variables_from_flax,
    write_arch,
)
from awm_tpu_torch.config import ModelConfig, get_config
from awm_tpu_torch.models import StridedDetector, StridedGenerator, build_models

NARROW = dict(message_bits=4, base_channels=8, hidden_dim=8, output_channels=16, strides=(2, 4))
# (generator kwargs, batch, T): the narrow replica of tests/test_checkpoint.py
# and the published width (32 / 32 / 128, strides (2, 4, 5, 8), 16 bits).
SIZES = [pytest.param(NARROW, 2, 160, id="narrow"), pytest.param({}, 2, 3200, id="full")]


def _det_kwargs(kw):
    return {k: kw[k] for k in ("message_bits", "base_channels", "strides") if k in kw}


def _numpy_tree(variables):
    return jax.tree.map(np.asarray, dict(variables))


def _signal(rng, b, t):
    return (0.3 * rng.standard_normal((b, t))).astype(np.float32)


@pytest.mark.parametrize("kw,b,t", SIZES)
def test_strided_generator_matches_flax(rng, kw, b, t):
    """Whole generator from a flax init (convs, ELU blocks, proj, the table
    added before the two LSTMs, ConvTranspose upsampler, pad/trim), fp32:
    summation order only, 1e-5 (the random init keeps the LSTMs
    contractive)."""
    s = _signal(rng, b, t)
    msg = rng.integers(0, 2 ** kw.get("message_bits", 16), size=b).astype(np.int32)
    jgen = JGenerator(**kw)
    variables = _numpy_tree(jgen.init(jax.random.key(0), jnp.asarray(s), jnp.asarray(msg)))
    ref = np.asarray(jgen.apply(variables, jnp.asarray(s), jnp.asarray(msg)))
    gen = StridedGenerator(**kw)
    gen.load_state_dict(variables_from_flax(variables), strict=True)
    with torch.no_grad():
        out = gen(torch.from_numpy(s), torch.from_numpy(msg.astype(np.int64)))
    assert out.shape == (b, t) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("kw,b,t", SIZES)
def test_strided_detector_matches_flax(rng, kw, b, t):
    """Detector logits (B, T, 1 + bits) from a flax init, fp32: 1e-5."""
    s = _signal(rng, b, t)
    jdet = JDetector(**_det_kwargs(kw))
    variables = _numpy_tree(jdet.init(jax.random.key(1), jnp.asarray(s)))
    ref = np.asarray(jdet.apply(variables, jnp.asarray(s)))
    det = StridedDetector(**_det_kwargs(kw))
    det.load_state_dict(variables_from_flax(variables), strict=True)
    with torch.no_grad():
        out = det(torch.from_numpy(s))
    assert out.shape == (b, t, 1 + kw.get("message_bits", 16))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_two_layer_lstm_stack_grads_match_jax(rng):
    """The generator's two stacked LSTM(32) at T = 50 under autograd:
    layer 1's dx is layer 0's dy, so a wrong stride or layout between the
    layers shows in the first layer's and the input's gradients.  Each
    layer through LSTMFunction (plain B and C on the CPU) vs jax.grad of the
    flax LSTM modules (lax.scan), loss sum(sin(y)), B=3, fp32: 1e-5 of each
    gradient's max (summation order only)."""
    from awm_tpu.models.layers import LSTM as JLSTM

    from awm_tpu_torch.models.layers import LSTM

    x = (0.5 * rng.standard_normal((3, 50, 32))).astype(np.float32)
    mods = [JLSTM(32, name=f"lstm{i}") for i in range(2)]
    params = [_numpy_tree(m.init(jax.random.key(i), jnp.asarray(x)))["params"] for i, m in enumerate(mods)]

    def loss(x, p0, p1):
        y = mods[1].apply({"params": p1}, mods[0].apply({"params": p0}, x))
        return jnp.sum(jnp.sin(y))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), *params)
    layers = [LSTM(32, 32) for _ in range(2)]
    for layer, p in zip(layers, params):
        layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_()
    torch.sin(layers[1](layers[0](tx))).sum().backward()
    pairs = [("x", tx.grad, ref[0])] + [
        (f"lstm{i}.{k}", getattr(layers[i], k).grad, ref[1 + i][k])
        for i in range(2) for k in ("w_ih", "w_hh", "b")]
    for name, got, want in pairs:
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        assert err < 1e-5, (name, err)


@pytest.mark.parametrize("field,value", [("message_encoding", "bits"), ("decode_head", "dilated"),
                                         ("delta_band_hz", 3000.0)])
def test_build_models_refuses_base_variants(field, value):
    """The JAX package's fail-fast refusals (awm_tpu/models/__init__.py:31-45)
    with its message."""
    from awm_tpu.config import ModelConfig as JModelConfig
    from awm_tpu.models import build_models as jbuild

    with pytest.raises(ValueError, match="strided family") as ours:
        build_models(ModelConfig(family="strided", **{field: value}))
    with pytest.raises(ValueError, match="strided family") as theirs:
        jbuild(JModelConfig(family="strided", **{field: value}))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown model family"):
        build_models(ModelConfig(family="dense"))


def test_strided_sidecar_round_trip_and_cross_read(tmp_path):
    """write_arch of a strided ModelConfig: the port reads back the same
    config (strides as a tuple), and the JAX package's read_arch + ModelConfig
    read the JAX preset's model from it."""
    from awm_tpu import checkpoint as jck
    from awm_tpu.config import ModelConfig as JModelConfig, get_config as jget_config

    model = ModelConfig(family="strided", hidden_dim=16, strides=(2, 4, 5))
    write_arch(str(tmp_path), model)
    doc = read_arch(str(tmp_path))
    assert doc["strides"] == [2, 4, 5] and doc["lstm_impl"] == "auto"
    assert configs_from_arch(doc) == (model, None)
    preset = get_config("strided").model
    write_arch(str(tmp_path), preset)
    arch = jck.read_arch(str(tmp_path))
    arch["strides"] = tuple(arch["strides"])
    assert JModelConfig(**arch) == jget_config("strided").model


def test_seeded_tree_matches_jax_init_layout():
    """seeded_flax_tree draws the JAX package's tree: the same keys and
    shapes as awm_tpu.train.init_state's params and batch_stats (traced with
    jax.eval_shape, nothing computed), for the strided preset (no BatchNorm)
    and the base one; the same seed gives the same arrays, another seed
    others; the draws keep the initialisers' bounds."""
    from awm_tpu import train as jtr
    from awm_tpu.config import get_config as jget_config

    def jax_layout(preset):
        cfg = dataclasses.replace(jget_config(preset), audio_len=320)
        state = jax.eval_shape(lambda k: jtr.init_state(cfg, k)[0], jax.random.key(0))
        leaves = jax.tree_util.tree_leaves_with_path({"params": state.params,
                                                      "batch_stats": state.batch_stats})
        return {"/".join(p.key for p in path): (leaf.shape, leaf.dtype) for path, leaf in leaves}

    for preset in ("strided", "base"):
        want = jax_layout(preset)
        got = ta.flatten(seeded_flax_tree(get_config(preset).model, 7))
        assert sorted(got) == sorted(want), preset
        for k, (shape, dtype) in want.items():
            assert got[k].shape == shape and got[k].dtype == dtype == np.float32, k
    model = get_config("strided").model
    first, again, other = (ta.flatten(seeded_flax_tree(model, seed)) for seed in (7, 7, 8))
    assert all(np.array_equal(first[k], again[k]) for k in first)
    w = first["params/gen/enc3/conv1/w"]  # (3, 256, 512): fan_in 768
    assert not np.array_equal(w, other["params/gen/enc3/conv1/w"])
    assert 0.99 / np.sqrt(768) < np.abs(w).max() <= 1 / np.sqrt(768)
    assert abs(float(first["params/gen/embedding/table"].std()) - 1.0) < 0.01


def test_bridge_carries_strided_tree():
    """variables_from_flax on a strided tree in the JAX layout (the seeded
    one; the flax-init trees of the model tests load strictly too): the
    ConvTranspose upsamplers dec_up{i} / up{i} as (in, out, k) without a
    flip, the proj Linear's (in, out) w as torch's (out, in) weight, the
    convs as (out, in, k); the port's networks load it strictly."""
    tree = seeded_flax_tree(get_config("strided").model, 3)["params"]
    gen, det = build_models(get_config("strided").model)
    sd = {}
    for name, net in (("gen", gen), ("det", det)):
        sd[name] = variables_from_flax({"params": tree[name]})
        net.load_state_dict(sd[name], strict=True)
    g = tree["gen"]
    np.testing.assert_array_equal(sd["gen"]["dec_up0.weight"].numpy(), g["dec_up0"]["w"].transpose(1, 2, 0))
    np.testing.assert_array_equal(sd["gen"]["proj.weight"].numpy(), g["proj"]["w"].T)
    np.testing.assert_array_equal(sd["gen"]["enc0.skip.weight"].numpy(),
                                  g["enc0"]["skip"]["w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["det"]["up3.weight"].numpy(),
                                  tree["det"]["up3"]["w"].transpose(1, 2, 0))
    assert tuple(sd["det"]["up3.weight"].shape) == (64, 32, 4)  # ConvTranspose(64 -> 32, k=2*2)


def test_restore_params_across_families(tmp_path):
    """restore_params' warm-start rules for strided trees: base weights into
    strided networks share no leaf and raise even with allow_missing, as the
    JAX package's restore_params does (the only same-named leaf,
    gen/embedding/table, differs in shape); a strided checkpoint into base
    networks raises the same way; a strided .npz restores into strided
    networks leaf for leaf."""
    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch import train as tr

    strided = get_config("strided")
    with pytest.raises(ValueError, match="shares no parameter"):
        ck.restore_params(ck.SHAPECAP_NPZ, *build_models(strided.model), allow_missing=True)
    state = tr.init_state(strided, device="cpu")
    ck.save_checkpoint(str(tmp_path / "s"), state, model_cfg=strided.model)
    with pytest.raises(ValueError, match="shares no parameter"):
        ck.restore_params(str(tmp_path / "s"), *build_models(get_config("base").model),
                          allow_missing=True)
    tree = seeded_flax_tree(strided.model, 5)
    np.savez(tmp_path / "s.npz", **ta.flatten(tree))
    gen, det = build_models(strided.model)
    assert ck.restore_params(str(tmp_path / "s.npz"), gen, det)[0] == []
    want = variables_from_flax({"params": tree["params"]["gen"]})
    assert all(torch.equal(v, want[k]) for k, v in gen.state_dict().items())


@pytest.mark.parametrize("prefix", ["", "_orig_mod."], ids=["plain", "compiled"])
def test_strided_pth_importers_match_jax_and_torch(tmp_path, prefix):
    """main14b_2 .pth of tests/test_checkpoint.py's torch replica through
    import_torch_strided_{generator,detector}: the port's models equal the
    replica's forward and the JAX importers' flax forward at 2e-5 (that
    test's tolerance), and every leaf equals the JAX importer's."""
    from awm_tpu import checkpoint as jck

    kw = NARROW
    tgen, tdet = _torch_strided_pair(kw["message_bits"], kw["base_channels"], kw["hidden_dim"],
                                     kw["output_channels"], kw["strides"])
    paths = {}
    for name, net in (("g", tgen), ("d", tdet)):
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save({prefix + k: v for k, v in net.state_dict().items()}, paths[name])
    n = len(kw["strides"])
    gen, det = StridedGenerator(**kw), StridedDetector(**_det_kwargs(kw))
    gsd = import_torch_strided_generator(paths["g"], n_strides=n)
    dsd = import_torch_strided_detector(paths["d"], n_strides=n)
    gen.load_state_dict(gsd, strict=True)
    det.load_state_dict(dsd, strict=True)
    for ours, theirs in ((gsd, jck.import_torch_strided_generator(paths["g"], n_strides=n)),
                         (dsd, jck.import_torch_strided_detector(paths["d"], n_strides=n))):
        want = variables_from_flax(_numpy_tree(theirs))
        assert sorted(ours) == sorted(want)
        assert all(torch.equal(ours[k], want[k]) for k in want)

    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((2, 160))).astype(np.float32)
    msg = np.array([3, 9], dtype=np.int64)
    with torch.no_grad():
        ref_d = tgen(torch.from_numpy(x).unsqueeze(1), torch.from_numpy(msg))[:, 0].numpy()
        ref_l = tdet(torch.from_numpy(x).unsqueeze(1)).permute(0, 2, 1).numpy()
        out_d = gen(torch.from_numpy(x), torch.from_numpy(msg)).numpy()
        out_l = det(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_d, ref_d, atol=2e-5)
    np.testing.assert_allclose(out_l, ref_l, atol=2e-5)
    fgen = JGenerator(**kw, lstm_layers=2)
    jd = np.asarray(fgen.apply(jck.import_torch_strided_generator(paths["g"], n_strides=n),
                               jnp.asarray(x), jnp.asarray(msg, jnp.int32)))
    np.testing.assert_allclose(out_d, jd, atol=2e-5)


def _golden():
    with np.load(ta.STRIDED_GOLDEN_NPZ) as g:
        return {k: g[k] for k in g.files}


def _seeded_nets(cfg, seed, gen, det):
    tree = seeded_flax_tree(cfg.model, seed)
    for name, net in (("gen", gen), ("det", det)):
        net.load_state_dict(variables_from_flax({"params": tree["params"][name]}), strict=True)


def test_port_reproduces_strided_golden_on_cpu():
    """The port's fp32 strided session, weights drawn from the golden's
    seed, on the golden's 8 chunks of 16000: deltas 1e-6 (summation order
    through 4.1 M generator weights; measured 7e-8), probabilities, bit
    logits and delta RMS 1e-6 (measured 6e-8)."""
    from awm_tpu_torch.api import InferenceSession

    golden = _golden()
    cfg = get_config("strided")
    gen, det = build_models(cfg.model)
    _seeded_nets(cfg, int(golden["seed"]), gen, det)
    sess = InferenceSession(gen, det, compute_dtype=torch.float32, shaping=cfg.shaping, device="cpu")
    delta = sess.embed_chunks(golden["chunks"], golden["messages"])
    np.testing.assert_allclose(delta, golden["embed_delta"], atol=1e-6)
    out = sess.embed_detect(golden["chunks"], golden["messages"])
    for key in ("wm_prob", "clean_prob", "msg_logit_mean", "delta_rms"):
        np.testing.assert_allclose(out[key], golden[key], atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(out["msg_vote_frac"], golden["msg_vote_frac"])


def test_port_reproduces_strided_train_golden_on_cpu():
    """One fp32 strided train step (clamped s_w, the two LSTMs through
    LSTMFunction's plain B and C) from the golden's seeded weights on its 4
    train chunks: terms 1e-5 relative (measured 2e-7), every parameter's
    gradient norm 2e-3 relative (measured 1.8e-4 at worst, a detector bias
    whose gradient is a sum of cancelling terms).  No BatchNorm statistics:
    the family has none."""
    from awm_tpu_torch import train as tr

    golden = _golden()
    cfg = get_config("strided")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    state = tr.init_state(cfg, device="cpu")
    _seeded_nets(cfg, int(golden["seed"]), state.gen, state.det)
    assert not list(state.gen.buffers()) and not list(state.det.buffers())
    terms = tr.train_step(cfg, state, torch.from_numpy(golden["train/chunks"]),
                          message=torch.from_numpy(golden["train/messages"]).long())
    for k, v in terms.items():
        ref = float(golden[f"term/{k}"])
        assert abs(float(v) - ref) <= 1e-5 * abs(ref), k
    n = 0
    for net in ("gen", "det"):
        for k, p in getattr(state, net).named_parameters():
            ref = float(golden[f"grad_norm/{net}.{k}"])
            assert abs(float(p.grad.norm()) - ref) <= 2e-3 * ref, (net, k)
            n += 1
    assert n == sum(1 for k in golden if k.startswith("grad_norm/"))


def test_strided_preset_matches_jax():
    """The strided preset: the JAX package's model config field for field,
    s_w clamped, no shaping chain."""
    from awm_tpu.config import get_config as jget_config

    ours, theirs = get_config("strided"), jget_config("strided")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert {k: v for k, v in dataclasses.asdict(theirs.model).items() if k in fields} == \
        dataclasses.asdict(ours.model)
    assert dataclasses.asdict(ours.shaping) == dataclasses.asdict(theirs.shaping)
    assert ours.shaping.clamp_watermarked and not ours.shaping.enabled
    assert ours.train.epochs == theirs.train.epochs


def test_cli_strided_train_and_torch_import(tmp_path, capsys):
    """train --preset strided on the CPU at a short length writes a strided
    checkpoint with its sidecar; detect --preset strided with the replica's
    .pth weights (every command's --preset takes strided) and with --ckpt
    over that checkpoint both run; the session args and train refuse a base
    variant on the strided preset."""
    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch.__main__ import main, parse_args
    from awm_tpu_torch.utils.audio_io import save_wav

    out = main(["train", "--preset", "strided", "--device", "cpu", "--audio-len", "800",
                "--batch-size", "2", "--synthetic-n", "10", "--epochs", "1", "--workers", "1",
                "--ckpt-dir", str(tmp_path / "run")])
    assert out["state"].step == 4
    best = str(tmp_path / "run" / "ckpt_best")
    arch = ck.read_arch(best)
    assert arch["family"] == "strided" and arch["strides"] == [2, 4, 5, 8]
    wav = str(tmp_path / "x.wav")
    save_wav(wav, (0.2 * np.random.default_rng(1).standard_normal(1600)).astype(np.float32), 16000)
    capsys.readouterr()
    main(["detect", wav, "--ckpt", best, "--device", "cpu", "--audio-len", "800"])
    got = json.loads(capsys.readouterr().out)
    assert 0.0 <= got["mean_probability"] <= 1.0

    tgen, tdet = _torch_strided_pair(16, 32, 32, 128, (2, 4, 5, 8))
    gp, dp = str(tmp_path / "g.pth"), str(tmp_path / "d.pth")
    torch.save(tgen.state_dict(), gp)
    torch.save(tdet.state_dict(), dp)
    main(["detect", wav, "--preset", "strided", "--torch-generator", gp, "--torch-detector", dp,
          "--device", "cpu", "--audio-len", "800"])
    assert 0.0 <= json.loads(capsys.readouterr().out)["mean_probability"] <= 1.0
    for cmd in (["embed", "a", "b"], ["verify", "a", "--message", "1"], ["evaluate", "d"],
                ["embed-folder", "a", "b"], ["detect-folder", "a"], ["serve"]):
        assert parse_args(cmd + ["--preset", "strided"]).preset == "strided"
    with pytest.raises(ValueError, match="strided family"):
        main(["train", "--preset", "strided", "--device", "cpu", "--audio-len", "800",
              "--batch-size", "2", "--synthetic-n", "4", "--epochs", "1", "--workers", "1",
              "--decode-head", "dilated"])

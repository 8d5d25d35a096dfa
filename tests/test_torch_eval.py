"""The port's evaluation suite (awm_tpu_torch.eval) and the api leftovers vs
the JAX package, on the CPU.

Both packages' sessions carry the committed weights (shapecap with its
shaping chain, or T_flagship without one) at chunk_len=800 in fp32.  The
trained LSTM amplifies rounding, so the robustness sweep is held on its
table's columns, never on per-sample logits.  evaluate_robustness embeds
through embed_chunks (shaped deltas); evaluate_model and evaluate_classifier
through embed_detect (the generator's own deltas)."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_assets as ta

from awm_tpu import api as japi
from awm_tpu import eval as jeval
from awm_tpu.config import ModelConfig as JModelConfig, ShapingConfig as JShapingConfig
from awm_tpu.models import build_models as jbuild_models

from awm_tpu_torch import api
from awm_tpu_torch import eval as teval
from awm_tpu_torch.checkpoint import (
    SHAPECAP_ARCH,
    SHAPECAP_NPZ,
    T_FLAGSHIP_ARCH,
    T_FLAGSHIP_NPZ,
    load_npz,
)
from awm_tpu_torch.data import SyntheticClips
from awm_tpu_torch.utils.audio_io import load_audio, save_wav

CHUNK = 800
WEIGHTS = {"shapecap": (SHAPECAP_NPZ, SHAPECAP_ARCH, JShapingConfig(enabled=True, max_rms=0.01)),
           "t_flagship": (T_FLAGSHIP_NPZ, T_FLAGSHIP_ARCH, None)}
_SESSIONS = {}


def sessions(name, chunk=CHUNK):
    """(JAX session, port session) over one set of committed weights, fp32."""
    if (name, chunk) not in _SESSIONS:
        npz, arch, shaping = WEIGHTS[name]
        tree = load_npz(npz)
        gen, det = jbuild_models(
            JModelConfig(message_encoding="bits", decode_head="dilated", delta_band_hz=3000.0))
        net = lambda n: {p: tree[p][n] for p in ("params", "batch_stats")}  # noqa: E731
        jsess = japi.InferenceSession(gen, det, net("gen"), net("det"), chunk_len=chunk,
                                      compute_dtype=jnp.float32, shaping=shaping)
        sess = api.InferenceSession.from_npz(npz, arch, compute_dtype=torch.float32, device="cpu",
                                             chunk_len=chunk)
        assert (sess.shaping is None) == (shaping is None)
        _SESSIONS[name, chunk] = (jsess, sess)
    return _SESSIONS[name, chunk]


def clips(n, t=CHUNK, seed=0):
    ds = SyntheticClips(n=n, audio_len=t, seed=seed)
    return np.stack([ds[i] for i in range(n)])


def deterministic(attacks):
    return {k: v for k, v in attacks.items() if k not in ta.STOCHASTIC_ATTACKS}


# absolute tolerance per column of evaluate_robustness's table at n clips:
# probabilities and the calibrated threshold (a midpoint of two of them) 1e-4;
# a rate moves by 1/n (or 2/n on a half) if one probability sits within
# rounding of its threshold; AUC by 1/n^2 per swapped pair; bit accuracy by
# 1/(16 n) per time-mean logit within rounding of zero.
def column_tolerances(n):
    return {"wm_prob": 1e-4, "clean_prob": 1e-4, "calibrated_threshold": 1e-4,
            "detect_rate": 1 / n, "false_positive_rate": 1 / n, "auc": 1 / n**2,
            "detect_rate_calibrated": 2 / n, "fpr_calibrated": 2 / n, "bit_accuracy": 2 / (16 * n),
            "exact_rate_raw": 1 / n, "exact_rate_ecc": 1 / n, "ecc_flagged_rate": 1 / n}


@pytest.mark.parametrize("weights,ecc", [("shapecap", False), ("shapecap", True), ("t_flagship", False)],
                         ids=["shapecap", "shapecap-ecc", "t_flagship"])
def test_evaluate_robustness_matches_jax(weights, ecc):
    """The ten deterministic attacks passed to both packages' sweep, 12
    clips of 800 samples, with and without ecc: every column of every row
    within column_tolerances; the exact columns (rates, AUC) measured equal."""
    jsess, sess = sessions(weights)
    x = clips(12)
    ref = jeval.evaluate_robustness(jsess, x, seed=3, ecc=ecc,
                                    attacks=deterministic(jeval.default_attacks(16000, seed=3)))
    got = teval.evaluate_robustness(sess, x, seed=3, ecc=ecc,
                                    attacks=deterministic(teval.default_attacks(16000, seed=3)))
    assert list(got) == list(ref) and len(got) == 10
    tol = column_tolerances(12)
    for name, row in ref.items():
        assert list(got[name]) == list(row), name
        assert ("exact_rate_ecc" in row) == ecc
        for col, v in row.items():
            assert abs(got[name][col] - v) <= tol[col], (name, col, got[name][col], v)
    assert got["none"]["wm_prob"] > got["none"]["clean_prob"]


def test_default_attacks_rows():
    """The 12 channels, same names and order as the JAX package's; the two
    noise rows draw from independent generators; a row called twice (the
    sweep's watermarked and clean halves) meets the same noise; the SNRs are
    30 and 20 dB; tensors stay on their device and keep their shape."""
    attacks = teval.default_attacks(16000, seed=0)
    assert list(attacks) == list(jeval.default_attacks(16000, seed=0))
    x = torch.from_numpy(clips(3))
    out = {k: fn(x) for k, fn in attacks.items()}
    assert all(v.shape == x.shape and v.dtype == torch.float32 for v in out.values())
    n30, n20 = out["noise_30db"] - x, out["noise_20db"] - x
    snr = lambda n: float(10 * torch.log10(x.square().mean() / n.square().mean()))
    assert abs(snr(n30) - 30.0) < 0.1 and abs(snr(n20) - 20.0) < 0.1
    corr = float((n30 * n20).sum() / (n30.norm() * n20.norm()))
    assert abs(corr) < 0.1  # one shared generator would give 1.0
    assert torch.equal(attacks["noise_30db"](x), out["noise_30db"])
    other = teval.default_attacks(16000, seed=1)["noise_30db"](x)
    assert not torch.equal(other, out["noise_30db"])
    assert torch.equal(out["none"], x) and torch.equal(out["volume_0.5"], 0.5 * x)


def test_evaluate_robustness_default_table():
    """The default sweep (noise rows included): 12 rows of 9 finite columns,
    the noise rows between their neighbours in severity."""
    _, sess = sessions("shapecap")
    table = teval.evaluate_robustness(sess, clips(8), seed=0)
    assert len(table) == 12 and all(len(row) == 9 for row in table.values())
    assert all(np.isfinite(v) for row in table.values() for v in row.values())
    assert abs(table["noise_30db"]["wm_prob"] - table["none"]["wm_prob"]) < 0.1


@pytest.mark.parametrize("seed,ties", [(5, False), (6, True), (7, False), (8, True)])
def test_roc_threshold_kfold_match_jax(seed, ties):
    """roc_auc is numpy here and scikit-learn in the JAX package: the same
    fpr, tpr, thresholds and AUC to the bit, tied scores (rounded to one
    decimal) and float32 scores included; optimal_threshold, kfold_cv and
    interpret_results the same values."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, 60)
    probs = np.clip(0.35 * labels + 0.3 + 0.2 * rng.standard_normal(60), 0, 1)
    probs = np.round(probs, 1).astype(np.float32) if ties else probs
    ref, got = jeval.roc_auc(labels, probs), teval.roc_auc(labels, probs)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))
    assert teval.optimal_threshold(labels, probs) == jeval.optimal_threshold(labels, probs)
    assert 0.0 < teval.optimal_threshold(labels, probs)["threshold"] < 1.0
    preds = (probs > 0.5).astype(int)
    assert teval.kfold_cv(labels, preds, k=5, seed=42) == jeval.kfold_cv(labels, preds, k=5, seed=42)
    for acc in (0.995, 0.96, 0.9, 0.5):
        assert teval.interpret_results(acc) == jeval.interpret_results(acc)
    assert teval.AUDIO_EXTS == jeval.AUDIO_EXTS


def test_evaluate_model_and_classifier_match_jax():
    """evaluate_model / evaluate_classifier over two batches (embed_detect:
    unshaped deltas): probabilities and delta RMS 1e-5, bit accuracies within
    one bit of the 8 x 16, the same confusion matrix and report."""
    jsess, sess = sessions("shapecap")
    batches = [clips(5, seed=1), clips(3, seed=2)]
    ref, got = jeval.evaluate_model(jsess, batches, seed=4), teval.evaluate_model(sess, batches, seed=4)
    assert list(got) == list(ref)
    for k, tol in (("watermarked_prob", 1e-5), ("clean_prob", 1e-5), ("delta_rms", 1e-6),
                   ("bit_accuracy", 1 / 128), ("bit_accuracy_mean_logit", 1 / 128)):
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])
    shaped = np.sqrt((sess.embed_chunks(batches[0], np.arange(5)) ** 2).mean(axis=1)).mean()
    assert got["delta_rms"] > shaped  # the entry point that applies no shaping
    (jcm, jrep), (cm, rep) = (jeval.evaluate_classifier(jsess, batches, 0.5, seed=4),
                              teval.evaluate_classifier(sess, batches, 0.5, seed=4))
    np.testing.assert_array_equal(cm, jcm)
    assert rep == jrep and cm.sum() == 16


# -- folders --------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 1-s synthetic WAVs in a tree, and a file that does not decode."""
    root = tmp_path_factory.mktemp("corpus")
    x = clips(3, t=16000, seed=9)
    for i, sub in enumerate(("", "a", os.path.join("a", "b"))):
        save_wav(str(root / sub / f"clip{i}.wav"), x[i], 16000)
    (root / "broken.wav").write_bytes(b"RIFFnot a wav file")
    return str(root)


def test_evaluate_corpus_matches_jax(corpus):
    """Directory sweep: 3 files evaluated, the broken one skipped and
    counted, in both packages; averages 1e-4 (STOI and NSIM 1e-3: they see
    the delta's 1e-6 differences through a ratio), the same confusion matrix."""
    jsess, sess = sessions("shapecap")
    ref, got = jeval.evaluate_corpus(corpus, jsess, seed=1), teval.evaluate_corpus(corpus, sess, seed=1)
    assert got["n_files"] == ref["n_files"] == 3 and got["errors"] == ref["errors"] == 1
    assert set(got) == set(ref)
    for k in ("avg_prob_clean", "avg_prob_watermarked", "avg_delta_rms", "accuracy", "auc"):
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])
    assert abs(got["avg_si_snr_db"] - ref["avg_si_snr_db"]) <= 1e-2
    for k in ("avg_stoi", "avg_nsim"):
        assert abs(got[k] - ref[k]) <= 1e-3 and 0.0 < got[k] <= 1.0, (k, got[k], ref[k])
    assert got["confusion_matrix"] == ref["confusion_matrix"] and got["kfold_acc"] == ref["kfold_acc"]
    assert teval.evaluate_corpus(corpus, sess, max_files=1)["n_files"] == 1
    only_broken = teval.evaluate_corpus(corpus, sess, exts=("broken.wav",))
    assert only_broken == {"n_files": 0, "errors": 1}
    assert teval.evaluate_unseen_file(os.path.join(corpus, "broken.wav"), sess) is None


def test_embed_and_detect_folders(corpus, tmp_path):
    """embed_watermark_folder mirrors the tree with the prefix and counts the
    broken file; detect_watermark_folder calls the written files watermarked
    and the originals not; both agree with the JAX package's."""
    jsess, sess = sessions("shapecap")
    out_dir = tmp_path / "wm"
    got = teval.embed_watermark_folder(corpus, str(out_dir), sess, seed=2)
    ref = jeval.embed_watermark_folder(corpus, str(tmp_path / "jwm"), jsess, seed=2)
    assert got["n_files"] == ref["n_files"] == 3 and got["errors"] == ref["errors"] == 1
    assert abs(got["avg_rms"] - ref["avg_rms"]) <= 1e-6
    assert abs(got["avg_power_ratio_db"] - ref["avg_power_ratio_db"]) <= 1e-3
    written = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                     for d, _, fs in os.walk(out_dir) for f in fs)
    assert written == sorted(["watermarked_clip0.wav", os.path.join("a", "watermarked_clip1.wav"),
                              os.path.join("a", "b", "watermarked_clip2.wav")])
    det_wm = teval.detect_watermark_folder(str(out_dir), sess)
    det_clean = teval.detect_watermark_folder(corpus, sess)
    jdet = jeval.detect_watermark_folder(str(out_dir), jsess)
    assert det_wm["n_watermarked"] == 3 and det_wm["fraction_watermarked"] == 1.0
    assert det_clean["n_watermarked"] == 0 and det_clean["errors"] == 1 and det_clean["n_files"] == 3
    for f, r in det_wm["per_file"].items():
        assert abs(r["mean_probability"] - jdet["per_file"][f]["mean_probability"]) <= 1e-4


def test_eval_cli_on_cpu(corpus, tmp_path, capsys):
    """python -m awm_tpu_torch evaluate / embed-folder / detect-folder on
    --device cpu at --audio-len 800."""
    from awm_tpu_torch.__main__ import main

    common = ["--device", "cpu", "--audio-len", "800", "--compute-dtype", "float32"]
    out = main(["evaluate", corpus, *common])
    text = capsys.readouterr().out
    assert out["n_files"] == 3 and out["errors"] == 1 and "watermarked" in text
    assert teval.interpret_results(out["accuracy"]) in text
    assert main(["evaluate", corpus, "--max-files", "1", *common])["n_files"] == 1
    emb = main(["embed-folder", corpus, str(tmp_path / "out"), *common])
    assert emb["n_files"] == 3 and emb["errors"] == 1
    det = main(["detect-folder", str(tmp_path / "out"), "--threshold", "0.5", *common])
    assert det["n_watermarked"] == 3 and "per_file" not in det
    assert json.loads(capsys.readouterr().out.split("\\n{")[-1].join(["{", ""]) if False else "{}") == {}


# -- the api leftovers ----------------------------------------------------------


def test_detect_chunks_matches_summary_and_jax():
    """Raw logits (N, L, 17): their sigmoid and time means are
    detect_summary's outputs (1e-6), and they equal the JAX session's to 1e-4
    + 2e-5 relative on logits of magnitude ~20."""
    jsess, sess = sessions("shapecap")
    x = clips(3, seed=4)
    logits = sess.detect_chunks(x)
    assert logits.shape == (3, CHUNK, 17) and logits.dtype == np.float32
    probs, mlm, mvf, mp = sess.detect_summary(x)
    np.testing.assert_allclose(1 / (1 + np.exp(-logits[:, :, 0])), probs, atol=1e-6)
    np.testing.assert_allclose(logits[:, :, 1:].mean(axis=1), mlm, atol=1e-5)
    np.testing.assert_allclose((logits[:, :, 1:] > 0).mean(axis=1), mvf, atol=1e-6)
    np.testing.assert_allclose(logits, np.asarray(jsess.detect_chunks(x)), atol=1e-4, rtol=2e-5)
    on_device = sess.detect_summary(torch.from_numpy(x))  # a tensor takes the same path
    np.testing.assert_array_equal(on_device[3], mp)


def test_save_audio_quality_and_file_helpers(tmp_path):
    """save_audio_quality (7 kHz biquad -> int16 WAV) writes the JAX
    package's samples to within one int16 step; run_inference_on_file returns
    (watermarked, detection probability, delta RMS under the shaping cap,
    SI-SNR) for its random messages; detect_watermark(visualize=True) and the CLI's
    detect --visualize write the PNG next to the input.  The file is three
    whole chunks: the cap holds per chunk, so a cut tail chunk's kept part
    may exceed it (by 0.5% for some messages at 2000 samples)."""
    from awm_tpu_torch.__main__ import main

    jsess, sess = sessions("shapecap")
    x = clips(1, t=2400, seed=6)[0]
    api.save_audio_quality(x, str(tmp_path / "q.wav"), device="cpu")
    japi.save_audio_quality(x, str(tmp_path / "jq.wav"))
    (a, sr), (b, _) = load_audio(str(tmp_path / "q.wav")), load_audio(str(tmp_path / "jq.wav"))
    assert sr == 16000 and a.shape == b.shape
    assert np.abs(a - b).max() <= 1.01 / 32767
    assert np.abs(a.reshape(-1) - x).max() > 1e-3  # it did filter

    src = str(tmp_path / "in.wav")
    save_wav(src, x, 16000)
    wm, prob, rms, snr = api.run_inference_on_file(src, sess)
    assert wm.shape == x.shape and 0.5 < prob <= 1.0 and 0.0 < rms <= 0.01 and 10.0 < snr < 60.0

    out = api.detect_watermark(src, sess, visualize=True)
    png = tmp_path / "in_detection.png"
    assert png.exists() and png.stat().st_size > 1000 and "temporal_probs" in out
    png.unlink()
    main(["detect", src, "--visualize", "--device", "cpu", "--audio-len", "800"])
    assert png.exists()


def test_plot_helpers_write_files(tmp_path):
    _, sess = sessions("shapecap")
    teval.visualize_delta(sess, clips(2), str(tmp_path / "p" / "delta.png"), num_examples=2)
    teval.plot_confusion([[3, 1], [0, 4]], str(tmp_path / "cm.png"))
    teval.plot_roc([0, 0, 1, 1], [0.1, 0.4, 0.35, 0.8], str(tmp_path / "roc.png"))
    for name in ("p/delta.png", "cm.png", "roc.png"):
        assert (tmp_path / name).stat().st_size > 1000, name


# -- the full-length table against the golden -------------------------------------


def test_port_reproduces_robust_golden_on_cpu():
    """The port's fp32 session on the golden's 8 chunks at T=16000 through
    evaluate_robustness (seed 0, the ten deterministic attacks) vs the JAX
    package's table in assets/robust_golden.npz: every column within
    column_tolerances(8) (measured: probabilities and the calibrated
    threshold 1.5e-7, every other column equal)."""
    sess = api.InferenceSession.from_npz(compute_dtype=torch.float32, device="cpu")
    with np.load(ta.ROBUST_GOLDEN_NPZ) as g:
        golden = {k: g[k] for k in g.files}
    chunks, _ = ta.golden_inputs()
    table = teval.evaluate_robustness(sess, chunks, seed=0,
                                      attacks=deterministic(teval.default_attacks(16000, seed=0)))
    tol = column_tolerances(8)
    assert len(table) == 10
    for name, row in table.items():
        for col, v in row.items():
            assert abs(v - float(golden[f"table/{name}/{col}"])) <= tol[col], (name, col, v)

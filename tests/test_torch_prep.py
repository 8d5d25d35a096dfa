"""The port's dataset tools (awm_tpu_torch/data/prep.py and the ``prep``
command) vs the JAX package's, on the same temporary corpus (the fixture of
tests/test_prep_cli.py).  Both are numpy/scipy on the host: metadata CSVs,
selections, lists, labels and silent files are held equal exactly, segmented
clips bit for bit, features at rtol 1e-6."""

import contextlib
import csv
import glob
import io
import json
import os

import numpy as np
import pytest

from awm_tpu.data import prep as jprep
from awm_tpu.utils.audio_io import save_wav

from awm_tpu_torch.__main__ import main
from awm_tpu_torch.data import prep


@pytest.fixture
def corpus(tmp_path, rng):
    d = tmp_path / "raw"
    d.mkdir()
    t = np.arange(32000) / 16000.0
    speech = (0.4 * np.sin(2 * np.pi * 200 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))).astype(np.float32)
    speech = speech * (np.abs(speech) > 0.2)
    noise = (0.3 * rng.standard_normal(32000)).astype(np.float32)
    silent = np.zeros(16000, np.float32)
    save_wav(str(d / "speech.wav"), speech, 16000)
    save_wav(str(d / "noise.wav"), noise, 16000)
    save_wav(str(d / "silent.wav"), silent, 16000)
    return str(d)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _tree(root):
    """{relative path: bytes} of every file under root."""
    return {os.path.relpath(p, root): _read(p)
            for p in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True))
            if os.path.isfile(p)}


def _close_features(a, b):
    assert a.keys() == b.keys()
    for k, v in b.items():
        if isinstance(v, float):
            np.testing.assert_allclose(a[k], v, rtol=1e-6, err_msg=k)
        else:
            assert a[k] == v, k


def test_metadata_select_compare_match_jax(tmp_path, corpus):
    """build_metadata, read_metadata, select_audios under two seeds and
    compare_metadata: the same files and return values."""
    got, ref = str(tmp_path / "m.csv"), str(tmp_path / "jm.csv")
    assert prep.build_metadata(corpus, got) == jprep.build_metadata(corpus, ref) == 3
    assert _read(got) == _read(ref)
    assert prep.read_metadata(got) == jprep.read_metadata(ref)
    for seed in (1, 7):
        a, b = str(tmp_path / f"s{seed}.csv"), str(tmp_path / f"js{seed}.csv")
        assert prep.select_audios(got, a, seconds=3.0, seed=seed) == \
            jprep.select_audios(ref, b, seconds=3.0, seed=seed)
        assert _read(a) == _read(b)
        assert prep.compare_metadata(got, a) == jprep.compare_metadata(ref, b)


@pytest.mark.parametrize("subdirs", [False, True], ids=["flat", "per_file"])
def test_segment_matches_jax_bit_for_bit(tmp_path, corpus, subdirs):
    files = sorted(glob.glob(os.path.join(corpus, "*.wav")))
    got, ref = str(tmp_path / "clips"), str(tmp_path / "jclips")
    assert prep.segment_to_clips(files, got, per_file_subdirs=subdirs, workers=2) == \
        jprep.segment_to_clips(files, ref, per_file_subdirs=subdirs, workers=2)
    a, b = _tree(got), _tree(ref)
    assert a == b and len(a) >= 4


@pytest.mark.parametrize("full", [False, True], ids=["six", "full"])
def test_features_and_labels_match_jax(corpus, full):
    """analyze_audio's features (rtol 1e-6) and the classifier's labels,
    per file, and the tuning mode's statistics."""
    for p in sorted(glob.glob(os.path.join(corpus, "*.wav"))):
        a, b = prep.analyze_audio(p, full=full), jprep.analyze_audio(p, full=full)
        _close_features(a, b)
        assert prep.classify_speech_noise(a) == jprep.classify_speech_noise(b)
    a = prep.sample_feature_stats(corpus, 3, full=full)
    b = jprep.sample_feature_stats(corpus, 3, full=full)
    assert a.keys() == b.keys() and a["_classification"] == b["_classification"]
    for k in b:
        _close_features(a[k], b[k])


def test_classify_copy_silent_match_jax(tmp_path, corpus):
    """classify_folder (labels, lists, CSV features), copy_speech_only and
    find_silent."""
    got, ref = str(tmp_path / "cls"), str(tmp_path / "jcls")
    assert prep.classify_folder(corpus, got, workers=2, full=True) == \
        jprep.classify_folder(corpus, ref, workers=2, full=True)
    for name in ("speech_files.txt", "noise_files.txt"):
        assert _read(os.path.join(got, name)) == _read(os.path.join(ref, name))
    a, b = (_rows(os.path.join(d, "audio_classification_results.csv")) for d in (got, ref))
    assert a[0] == b[0] and len(a) == len(b) == 4
    for ra, rb in zip(a[1:], b[1:]):
        assert ra[0] == rb[0] and ra[-1] == rb[-1]
        np.testing.assert_allclose(np.float64(ra[1:-1]), np.float64(rb[1:-1]), rtol=1e-6)
    assert prep.copy_speech_only(os.path.join(got, "speech_files.txt"), str(tmp_path / "sp")) == \
        jprep.copy_speech_only(os.path.join(ref, "speech_files.txt"), str(tmp_path / "jsp"))
    assert _tree(str(tmp_path / "sp")) == _tree(str(tmp_path / "jsp"))
    assert prep.find_silent(corpus) == jprep.find_silent(corpus) == [os.path.join(corpus, "silent.wav")]


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["prep", *argv])
    return out.getvalue()


def test_prep_subcommands_match_jax(tmp_path, corpus):
    """The seven subcommands through the port's main() in process, each
    against the JAX function it wraps (awm_tpu/__main__.py:510-549)."""
    meta, ref_meta = str(tmp_path / "m.csv"), str(tmp_path / "jm.csv")
    assert _cli("metadata", corpus, meta) == f"wrote 3 rows to {meta}\n"
    jprep.build_metadata(corpus, ref_meta)
    assert _read(meta) == _read(ref_meta)

    sel, ref_sel = str(tmp_path / "s.csv"), str(tmp_path / "js.csv")
    n, total = jprep.select_audios(ref_meta, ref_sel, seconds=3.0, seed=1)
    assert _cli("select", meta, sel, "--seconds", "3", "--seed", "1") == \
        f"selected {n} files / {total / 3600:.2f} h -> {sel}\n"
    assert _read(sel) == _read(ref_sel)

    assert json.loads(_cli("compare", meta, sel)) == jprep.compare_metadata(ref_meta, ref_sel)

    clips, ref_clips = str(tmp_path / "c"), str(tmp_path / "jc")
    files = [p for p, _ in jprep.read_metadata(ref_meta)]
    n = jprep.segment_to_clips(files, ref_clips, workers=2)
    assert _cli("segment", clips, "--metadata", meta, "--workers", "2") == \
        f"wrote {n} clips to {clips}\n"
    assert _tree(clips) == _tree(ref_clips)
    assert _cli("segment", str(tmp_path / "c2"), "--dir", corpus, "--workers", "2") == \
        f"wrote {n} clips to {tmp_path / 'c2'}\n"

    cls = str(tmp_path / "cls")
    assert json.loads(_cli("classify", corpus, cls, "--workers", "2")) == \
        jprep.classify_folder(corpus, str(tmp_path / "jcls"), workers=2)
    stats = json.loads(_cli("classify", corpus, "unused", "--sample", "3"))
    assert stats["_classification"] == jprep.sample_feature_stats(corpus, 3)["_classification"]

    n = jprep.copy_speech_only(os.path.join(cls, "speech_files.txt"), str(tmp_path / "jsp"))
    assert _cli("speech-only", os.path.join(cls, "speech_files.txt"), str(tmp_path / "sp")) == \
        f"copied {n} speech files to {tmp_path / 'sp'}\n"

    assert _cli("silent", corpus).split() == jprep.find_silent(corpus)
    assert _cli("silent", corpus, "--threshold", "1.0").split() == jprep.find_silent(corpus, 1.0)

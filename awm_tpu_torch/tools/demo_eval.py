"""Reproduce the DEMO.md quality tables from a checkpoint of the port
(counterpart of tools/demo_eval.py).

Drives the public eval surface end to end on the held-out test split of the
synthetic corpus the train command builds (the same 80/10/10 split seed),
as the reference's post-training evaluation blocks do (ref:
py/main14.py:1043-1093, main14.ipynb cells 11/16/19):

  quality   detection probabilities, detect / false-positive rate, ROC AUC,
            bit accuracy (vote and mean-logit rules), delta RMS, power
            ratio, a 13.3-s file round trip with STOI and NSIM
  robust    the 12-attack sweep (eval.evaluate_robustness)
  variance  that sweep's spread over --robust-seeds
  ecc       message-exact decode rates per attack, raw vs SECDED payloads
  music     embed + detect and decode on out-of-domain music-like clips
  cross     the reference's detector (--torch-detector .pth) on our
            watermarks, when that file is given and exists

As in the JAX package, embed_detect applies no shaping: quality's and
music's delta_rms are the generator's own deltas (ROADMAP.md, Queue 3).

Usage:
  python -m awm_tpu_torch.tools.demo_eval --ckpt runs/x/ckpt_best
      [--n-eval 1024] [--sections quality,robust,ecc,music] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

SECTIONS = ("quality", "robust", "ecc", "music", "cross", "variance")


def test_clips(audio_len: int, n_total: int, n_eval: int, split_seed: int = 42) -> np.ndarray:
    """The first n_eval clips of the synthetic corpus's test split."""
    from awm_tpu_torch.data import SyntheticClips, split_indices

    ds = SyntheticClips(n=n_total, audio_len=audio_len)
    _, _, te_idx = split_indices(len(ds), (0.8, 0.1, 0.1), seed=split_seed)
    return np.stack([ds[int(i)] for i in te_idx[:n_eval]])


def _bits_of(msgs: np.ndarray, bits: int) -> np.ndarray:
    return (msgs[:, None] & (1 << np.arange(bits))) > 0


def section_quality(sess, clips: np.ndarray, batch: int):
    from awm_tpu_torch.api import detect_watermark, generate_watermarked_audio
    from awm_tpu_torch.dsp.quality import nsim_quality
    from awm_tpu_torch.dsp.stoi import stoi
    from awm_tpu_torch.eval import roc_auc
    from awm_tpu_torch.utils.audio_io import save_wav

    sr = sess.sample_rate
    rng = np.random.default_rng(0)
    p_wm, p_clean, bits, bits_ml, d_rms, s_rms = [], [], [], [], [], []
    for i in range(0, len(clips), batch):
        s = clips[i : i + batch]
        msgs = rng.integers(0, 2**sess.message_bits, size=len(s)).astype(np.int32)
        out = sess.embed_detect(s, msgs)
        p_wm.extend(out["wm_prob"])
        p_clean.extend(out["clean_prob"])
        target = _bits_of(msgs, sess.message_bits)
        bits.extend(((out["msg_vote_frac"] > 0.5) == target).mean(axis=1))
        bits_ml.extend(((out["msg_logit_mean"] > 0) == target).mean(axis=1))
        d_rms.extend(out["delta_rms"])
        s_rms.extend(np.sqrt((s**2).mean(axis=1)))
    p_wm, p_clean = np.asarray(p_wm), np.asarray(p_clean)
    d_rms, s_rms = np.asarray(d_rms), np.asarray(s_rms)
    _, _, _, auc = roc_auc([1] * len(p_wm) + [0] * len(p_clean), np.concatenate([p_wm, p_clean]))

    # file round trip on a multi-second concatenation of held-out clips
    long = np.concatenate(clips[:14])[: int(13.3 * sr)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "long.wav")
        save_wav(path, long, sr)
        emb = generate_watermarked_audio(path, sess, os.path.join(d, "wm.wav"), seed=0)
        det_wm = detect_watermark(os.path.join(d, "wm.wav"), sess)
        det_clean = detect_watermark(path, sess)
    wm_wave = emb["watermarked_waveform"]
    return {
        "watermarked_prob": float(p_wm.mean()),
        "clean_prob": float(p_clean.mean()),
        "detect_rate": float((p_wm > 0.5).mean()),
        "false_positive_rate": float((p_clean > 0.5).mean()),
        "roc_auc": float(auc),
        "bit_accuracy": float(np.mean(bits)),
        "bit_accuracy_mean_logit": float(np.mean(bits_ml)),
        "delta_rms": float(d_rms.mean()),
        "power_ratio_db": float((20 * np.log10(s_rms / np.maximum(d_rms, 1e-12))).mean()),
        "file_roundtrip": {
            "seconds": round(len(long) / sr, 1),
            "clean_prob": det_clean["mean_probability"],
            "wm_prob": det_wm["mean_probability"],
            "si_snr_db": emb["metrics"]["si_snr_db"],
            "stoi": float(stoi(long, wm_wave, sr)),
            "nsim": float(nsim_quality(long, wm_wave, sr)),
        },
    }


def _rounded(table, keep=None):
    return {k: {m: round(float(v), 4) for m, v in row.items() if keep is None or m in keep}
            for k, row in table.items()}


def section_robust(sess, clips: np.ndarray, n: int = 128):
    from awm_tpu_torch.eval import evaluate_robustness

    return _rounded(evaluate_robustness(sess, clips[:n], seed=0))


def aggregate_tables(tables):
    """{attack: {metric: value}} tables -> {attack: {metric: {mean, std, min, max}}}."""
    out = {}
    for atk in tables[0]:
        out[atk] = {}
        for m in tables[0][atk]:
            vals = np.asarray([t[atk][m] for t in tables], dtype=np.float64)
            out[atk][m] = {"mean": round(float(vals.mean()), 4), "std": round(float(vals.std()), 4),
                           "min": round(float(vals.min()), 4), "max": round(float(vals.max()), 4)}
    return out


def section_variance(sess, clips: np.ndarray, seeds, n: int = 128):
    """The attack matrix's spread over seeds: each seed redraws the clip
    subset, the messages and the noise realisations."""
    from awm_tpu_torch.eval import evaluate_robustness

    tables = []
    for s in seeds:
        idx = np.random.default_rng(1000 + s).choice(len(clips), size=min(n, len(clips)), replace=False)
        tables.append(evaluate_robustness(sess, clips[idx], seed=s))
    return {"seeds": list(seeds), "n_per_seed": int(min(n, len(clips))), "attacks": aggregate_tables(tables)}


def section_ecc(sess, clips: np.ndarray, n: int = 128):
    """Message-exact decode rates per attack, raw 16-bit vs SECDED-coded
    11-bit payloads."""
    from awm_tpu_torch.eval import evaluate_robustness

    keep = ("exact_rate_raw", "exact_rate_ecc", "ecc_flagged_rate", "bit_accuracy")
    return _rounded(evaluate_robustness(sess, clips[:n], seed=0, ecc=True), keep)


def section_music(sess, audio_len: int, n: int, batch: int):
    """Out-of-domain music generalisation: embed + detect and decode on
    SyntheticMusicClips of seed 7 (the training mix uses seed 1)."""
    from awm_tpu_torch.data import SyntheticMusicClips
    from awm_tpu_torch.eval import roc_auc

    ds = SyntheticMusicClips(n=n, audio_len=audio_len, seed=7)
    clips = np.stack([ds[i] for i in range(len(ds))])
    rng = np.random.default_rng(0)
    p_wm, p_clean, bits_ml, d_rms = [], [], [], []
    for i in range(0, len(clips), batch):
        s = clips[i : i + batch]
        msgs = rng.integers(0, 2**sess.message_bits, size=len(s)).astype(np.int32)
        out = sess.embed_detect(s, msgs)
        p_wm.extend(out["wm_prob"])
        p_clean.extend(out["clean_prob"])
        bits_ml.extend(((out["msg_logit_mean"] > 0) == _bits_of(msgs, sess.message_bits)).mean(axis=1))
        d_rms.extend(out["delta_rms"])
    p_wm, p_clean = np.asarray(p_wm), np.asarray(p_clean)
    _, _, _, auc = roc_auc([1] * len(p_wm) + [0] * len(p_clean), np.concatenate([p_wm, p_clean]))
    return {
        "watermarked_prob": float(p_wm.mean()),
        "clean_prob": float(p_clean.mean()),
        "accuracy": float(((p_wm > 0.5).sum() + (p_clean <= 0.5).sum()) / (2 * len(p_wm))),
        "roc_auc": float(auc),
        "bit_accuracy": float(np.mean(bits_ml)),
        "delta_rms": float(np.mean(d_rms)),
    }


def section_cross(sess, clips: np.ndarray, torch_detector: str, batch: int):
    """The reference's shipped detector on our watermarks: near-chance AUC is
    the expected key-specificity property.  The reference detector is the
    base family's shared head whatever the evaluated checkpoint's head."""
    import torch

    from awm_tpu_torch.api import InferenceSession
    from awm_tpu_torch.checkpoint import import_torch_detector
    from awm_tpu_torch.eval import roc_auc
    from awm_tpu_torch.models import Detector

    ref_det = Detector(message_bits=sess.message_bits, channels=sess.det.conv_in.weight.shape[0])
    ref_det.load_state_dict(import_torch_detector(torch_detector))
    ref = InferenceSession(sess.gen, ref_det, message_bits=sess.message_bits,
                           sample_rate=sess.sample_rate, chunk_len=sess.chunk_len,
                           compute_dtype=torch.float32, device=sess.device)
    rng = np.random.default_rng(0)
    p_wm, p_clean = [], []
    for i in range(0, len(clips), batch):
        s = clips[i : i + batch]
        msgs = rng.integers(0, 2**sess.message_bits, size=len(s)).astype(np.int32)
        wm = s + sess.embed_chunks(s, msgs)  # our generator's watermark
        p_wm.extend(ref.detect_summary(wm)[3])
        p_clean.extend(ref.detect_summary(s)[3])
    _, _, _, auc = roc_auc([1] * len(p_wm) + [0] * len(p_clean), np.concatenate([p_wm, p_clean]))
    return {"ref_detector_prob_clean": float(np.mean(p_clean)),
            "ref_detector_prob_our_wm": float(np.mean(p_wm)),
            "ref_detector_auc_vs_our_wm": float(auc)}


def load_checkpoint(args, *, shaping: bool = True):
    """(session, best_val) over --ckpt: its recorded architecture (the arch
    flags only validate against it; a checkpoint without a sidecar takes
    --preset's), its shaping chain unless shaping=False, on --device in
    --compute-dtype."""
    import torch

    from awm_tpu_torch.api import InferenceSession
    from awm_tpu_torch.checkpoint import configs_from_arch, read_arch, restore_params
    from awm_tpu_torch.config import AUDIO_LEN, get_config
    from awm_tpu_torch.models import build_models

    recorded = read_arch(args.ckpt)
    if recorded is None:
        preset = get_config(args.preset)
        model, shaping_cfg = preset.model, preset.shaping
    else:
        model, shaping_cfg = configs_from_arch(recorded)
    for flag in ("message_encoding", "decode_head"):
        given = getattr(args, flag, None)
        if given and given != getattr(model, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} {given} conflicts with the checkpoint's "
                             f"recorded architecture ({flag}={getattr(model, flag)!r})")
    gen, det = build_models(model)
    _, _, best_val = restore_params(args.ckpt, gen, det)
    dtype = torch.float32 if args.compute_dtype == "float32" else torch.bfloat16
    sess = InferenceSession(gen, det, message_bits=model.message_bits,
                            chunk_len=args.audio_len or AUDIO_LEN, compute_dtype=dtype,
                            shaping=shaping_cfg if shaping else None, device=args.device)
    return sess, best_val


def add_checkpoint_args(ap) -> None:
    ap.add_argument("--ckpt", required=True, help="checkpoint directory of the port")
    ap.add_argument("--preset", default="base",
                    help="architecture of a checkpoint without an awm_arch.json (base, light, "
                         "onecycle20, quality, ft_robust, strided); a recorded one wins")
    ap.add_argument("--synthetic-n", type=int, default=24576)
    ap.add_argument("--audio-len", type=int, default=None,
                    help="chunk length in samples (default 16000; tests use short chunks)")
    ap.add_argument("--message-encoding", choices=("table", "bits"), default=None,
                    help="validated against the checkpoint's recorded architecture")
    ap.add_argument("--decode-head", choices=("shared", "dilated"), default=None)
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="demo_eval", description=__doc__.splitlines()[0])
    add_checkpoint_args(ap)
    ap.add_argument("--n-eval", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--sections", default="quality,robust,ecc,music,cross")
    ap.add_argument("--robust-seeds", default="0,1,2",
                    help="seeds of the opt-in 'variance' section")
    ap.add_argument("--torch-detector", default=None,
                    help="the reference's detector_best.pth for the 'cross' section")
    ap.add_argument("--dec-loss", choices=("per_sample", "mean"), default=None,
                    help="accepted as `train` takes it; ignored: eval computes no losses and "
                         "reports bit accuracy under both decode rules")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    wanted = {s.strip() for s in args.sections.split(",") if s.strip()}
    unknown = wanted - set(SECTIONS)
    if unknown:  # before any model work: a typo must not give a partial evaluation
        raise SystemExit(f"unknown --sections {sorted(unknown)}; valid names: {sorted(SECTIONS)}")
    sess, best_val = load_checkpoint(args)
    clips = test_clips(sess.chunk_len, args.synthetic_n, args.n_eval)

    report = {"ckpt": args.ckpt, "best_val": best_val, "n_eval": len(clips)}
    if "quality" in wanted:
        report["quality"] = section_quality(sess, clips, args.batch_size)
    if "robust" in wanted:
        report["robust"] = section_robust(sess, clips)
    if "variance" in wanted:
        seeds = [int(s) for s in args.robust_seeds.split(",") if s.strip()]
        report["variance"] = section_variance(sess, clips, seeds)
    if "ecc" in wanted:
        report["ecc"] = section_ecc(sess, clips)
    if "music" in wanted:
        report["music"] = section_music(sess, sess.chunk_len, min(args.n_eval, 512), args.batch_size)
    if "cross" in wanted and args.torch_detector and os.path.exists(args.torch_detector):
        report["cross"] = section_cross(sess, clips[:256], args.torch_detector, args.batch_size)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()

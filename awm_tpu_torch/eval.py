"""Evaluation suites: corpus sweeps, classifier metrics, ROC, K-fold, folders
and the attack-matrix robustness sweep (counterpart of awm_tpu/eval.py).

Host-side orchestration over the batched device calls of awm_tpu_torch.api;
the channel attacks of the robustness sweep run as tensor ops on the
session's device, and only summaries come back to the host.  Metric
definitions are identical to the reference so quality numbers are directly
comparable (ref: evaluate_model py/main14.py:289-340,
evaluate_classifier py/main14.py:501-580, evaluate_unseen_file
py/main14.py:1005-1041, ROC py/main14.py:1459-1473, K-fold
py/main14.py:1430-1453, folder processors py/main15.py:1480-1517 and
py/main14d.py:1052-1112).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from awm_tpu_torch.api import (
    InferenceSession,
    detect_array,
    generate_watermarked_audio,
    watermark_array,
    _si_snr_np,
)
from awm_tpu_torch.utils.audio_io import load_mono_16k

AUDIO_EXTS = (".wav", ".mp3", ".flac", ".ogg")  # ref: py/main14.py:1055-1058


def _nanmean_or_nan(values) -> float:
    """np.nanmean without the all-NaN RuntimeWarning (metric absent on
    every file, e.g. stoi=False sweeps)."""
    a = np.asarray(values, dtype=np.float64)
    mask = ~np.isnan(a)
    return float(a[mask].mean()) if mask.any() else float("nan")


def evaluate_model(
    session: InferenceSession,
    batches: Iterable[np.ndarray],
    *,
    seed: int = 0,
) -> Dict[str, float]:
    """Aggregate eval over an iterable of (B, T) clean batches: detection
    probs for watermarked/clean halves, bit accuracy under BOTH decode
    rules (per-timestep majority vote = reference rule, and time-mean
    logit = the statistic dec_loss_mode='mean' trains), delta RMS
    (ref: py/main14.py:289-340, decode rule :925-929)."""
    rng = np.random.default_rng(seed)
    probs_wm, probs_clean, bit_accs, bit_accs_ml, rms_deltas = [], [], [], [], []
    for s in batches:
        s = np.asarray(s, dtype=np.float32)
        b = s.shape[0]
        msgs = rng.integers(0, 2**session.message_bits, size=b).astype(np.int32)
        out = session.embed_detect(s, msgs)  # fused, summaries only
        probs_wm.extend(out["wm_prob"])
        probs_clean.extend(out["clean_prob"])
        # majority vote: sigmoid>0.5 per step -> mean over T -> >0.5
        votes = out["msg_vote_frac"] > 0.5
        target = ((msgs[:, None] & (1 << np.arange(session.message_bits))) > 0)
        bit_accs.extend((votes == target).mean(axis=1))
        bit_accs_ml.extend(((out["msg_logit_mean"] > 0) == target).mean(axis=1))
        rms_deltas.extend(out["delta_rms"])
    return {
        "watermarked_prob": float(np.mean(probs_wm)),
        "clean_prob": float(np.mean(probs_clean)),
        "bit_accuracy": float(np.mean(bit_accs)),
        "bit_accuracy_mean_logit": float(np.mean(bit_accs_ml)),
        "delta_rms": float(np.mean(rms_deltas)),
    }


def evaluate_classifier(
    session: InferenceSession,
    batches: Iterable[np.ndarray],
    threshold: float = 0.5,
    *,
    seed: int = 0,
):
    """Segment-level confusion matrix + classification report at a threshold
    (ref: py/main14.py:501-580).  Returns (confusion_matrix, report_str)."""
    from sklearn.metrics import classification_report, confusion_matrix

    rng = np.random.default_rng(seed)
    y_true, y_pred = [], []
    for s in batches:
        s = np.asarray(s, dtype=np.float32)
        b = s.shape[0]
        msgs = rng.integers(0, 2**session.message_bits, size=b).astype(np.int32)
        out = session.embed_detect(s, msgs)
        y_pred.extend((out["wm_prob"] > threshold).astype(int))
        y_pred.extend((out["clean_prob"] > threshold).astype(int))
        y_true.extend([1] * b + [0] * b)
    cm = confusion_matrix(y_true, y_pred)
    report = classification_report(
        y_true, y_pred, target_names=["clean", "watermarked"], zero_division=0
    )
    return cm, report


def evaluate_unseen_file(
    path: str, session: InferenceSession, *, seed: Optional[int] = None
) -> Optional[Dict[str, float]]:
    """Per-file eval: embed a random message, detect on clean and
    watermarked, SI-SNR, delta RMS, STOI (ref: py/main14.py:1005-1041;
    PESQ/STOI variant :1141-1204).  Returns None on decode failure
    (skip-and-count, ref: py/main14.py:1006-1009)."""
    try:
        wav = load_mono_16k(path, session.sample_rate)
    except Exception:
        return None
    if wav.shape[-1] < 32:
        return None
    res = watermark_array(wav, session, seed=seed)
    wm, delta = res["watermarked_waveform"], res["delta_waveform"]
    prob_clean = detect_array(wav, session)["mean_probability"]
    prob_wm = detect_array(wm, session)["mean_probability"]
    out = {
        "prob_clean": prob_clean,
        "prob_watermarked": prob_wm,
        "delta_rms": float(np.sqrt((delta**2).mean())),
        "si_snr_db": _si_snr_np(wav, wm),
    }
    try:
        from awm_tpu_torch.dsp.stoi import stoi

        out["stoi"] = stoi(wav, wm, session.sample_rate)
    except Exception:
        out["stoi"] = float("nan")
    # framework-native perceptual column (NSIM, ViSQOL-style) — always
    # present, so quality reports keep a PESQ-class metric even without the
    # optional pesq package (ref perceptual slot: py/main14.py:1186-1195)
    try:
        from awm_tpu_torch.dsp.quality import nsim_quality

        out["nsim"] = nsim_quality(wav, wm, session.sample_rate)
    except Exception:
        out["nsim"] = float("nan")
    # optional wide-band PESQ, present only when the pesq package is
    # installed (ref: py/main14.py:1186-1195); STOI/SI-SNR above are the
    # documented fallbacks when it is not
    from awm_tpu_torch.dsp.stoi import pesq_score

    p = pesq_score(wav, wm, session.sample_rate)
    if p is not None:
        out["pesq"] = p
    return out


def roc_auc(labels: Sequence[int], probs: Sequence[float]):
    """ROC curve + AUC over file-level probabilities
    (ref: py/main14.py:1459-1473): (fpr, tpr, thresholds, auc) as
    sklearn.metrics.roc_curve (collinear points dropped, an inf threshold
    first) and sklearn.metrics.auc give them, in numpy, so that the
    robustness sweep needs no scikit-learn where it runs."""
    y_true = np.asarray(labels) == 1
    y_score = np.asarray(probs, dtype=np.float64)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    # one point per distinct score, at the last sample that has it
    idx = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx - tps
    thr = y_score[idx]
    if len(fps) > 2:  # drop points collinear with their neighbours
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps, fps, thr = np.r_[0, tps], np.r_[0, fps], np.r_[np.inf, thr]
    fpr, tpr = fps / fps[-1], tps / tps[-1]
    return fpr, tpr, thr, float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def optimal_threshold(labels: Sequence[int], probs: Sequence[float]) -> Dict[str, float]:
    """Youden's-J optimal decision threshold from ROC points.

    Deployment companion to the fixed 0.5 threshold the reference uses
    everywhere (ref: py/main14.py:914): a channel attack can shift the
    probability mass below 0.5 while leaving the ranking perfect (see
    evaluate_robustness AUC) — calibrating the threshold on a labeled
    holdout recovers detection.  Returns {threshold, tpr, fpr, j, auc}.

    sklearn's ROC thresholds ARE sample scores with `>=`-decision
    semantics; the returned threshold is shifted to the midpoint between
    the chosen score and the next one below, so the natural strict-`>`
    decision rule reproduces the reported tpr/fpr exactly (including
    boundary samples).
    """
    fpr, tpr, thr, auc = roc_auc(labels, probs)
    j = tpr - fpr
    i = int(np.argmax(j))
    lo = float(thr[i + 1]) if i + 1 < len(thr) else float(np.min(probs)) - 1e-6
    # midpoint below the `>=` score point (sklearn's first point is an
    # "inf" sentinel; clamp into [0, 1])
    t = float(np.clip((min(thr[i], 1.0) + min(lo, 1.0)) / 2.0, 0.0, 1.0))
    return {
        "threshold": t,
        "tpr": float(tpr[i]),
        "fpr": float(fpr[i]),
        "j": float(j[i]),
        "auc": float(auc),
    }


def kfold_cv(labels: Sequence[int], preds: Sequence[int], k: int = 5, seed: int = 42):
    """K-fold CV of binary accuracy (ref: py/main14.py:1430-1453)."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    idx = np.random.default_rng(seed).permutation(len(labels))
    folds = np.array_split(idx, k)
    return [float((labels[f] == preds[f]).mean()) for f in folds if len(f)]


def evaluate_corpus(
    root: str,
    session: InferenceSession,
    *,
    exts: Sequence[str] = AUDIO_EXTS,
    max_files: Optional[int] = None,
    seed: int = 0,
) -> Dict:
    """Directory sweep: per-file embed+detect, aggregate stats, confusion
    matrix, ROC AUC, K-fold CV (ref: py/main14.py:1043-1093).  Bad files are
    skipped and counted."""
    files: List[str] = []
    for ext in exts:
        files.extend(glob.glob(os.path.join(root, "**", f"*{ext}"), recursive=True))
    files.sort()
    if max_files:
        files = files[:max_files]

    results, errors = [], 0
    for i, f in enumerate(files):
        r = evaluate_unseen_file(f, session, seed=seed + i)
        if r is None:
            errors += 1
        else:
            results.append(r)
    if not results:
        return {"n_files": 0, "errors": errors}

    probs = [r["prob_clean"] for r in results] + [r["prob_watermarked"] for r in results]
    labels = [0] * len(results) + [1] * len(results)
    preds = [int(p > 0.5) for p in probs]
    _, _, _, auc_val = roc_auc(labels, probs)
    from sklearn.metrics import classification_report, confusion_matrix

    return {
        "n_files": len(results),
        "errors": errors,
        "avg_prob_clean": float(np.mean([r["prob_clean"] for r in results])),
        "avg_prob_watermarked": float(np.mean([r["prob_watermarked"] for r in results])),
        "avg_si_snr_db": float(np.mean([r["si_snr_db"] for r in results])),
        "avg_delta_rms": float(np.mean([r["delta_rms"] for r in results])),
        "avg_stoi": _nanmean_or_nan([r.get("stoi", float("nan")) for r in results]),
        "avg_nsim": _nanmean_or_nan([r.get("nsim", float("nan")) for r in results]),
        "accuracy": float(np.mean(np.asarray(preds) == np.asarray(labels))),
        "auc": float(auc_val),
        "kfold_acc": kfold_cv(labels, preds),
        "confusion_matrix": confusion_matrix(labels, preds).tolist(),
        "report": classification_report(
            labels, preds, target_names=["clean", "watermarked"], zero_division=0
        ),
    }


def interpret_results(accuracy: float) -> str:
    """Heuristic verdict strings (ref: py/main14.py:1417-1424)."""
    if accuracy >= 0.99:
        return "Excellent: watermark detection is near-perfect."
    if accuracy >= 0.95:
        return "Good: watermark detection is reliable with rare errors."
    if accuracy >= 0.85:
        return "Fair: detection works but misclassifies a notable fraction."
    return "Poor: detection is unreliable on this corpus."


# -- folder batch processors (ref: py/main15.py:1480-1517, py/main14d.py:1052-1112)


def embed_watermark_folder(
    input_dir: str,
    output_dir: str,
    session: InferenceSession,
    *,
    prefix: str = "watermarked_",
    exts: Sequence[str] = (".wav",),
    seed: int = 0,
) -> Dict:
    """Watermark every file under input_dir, mirroring the directory tree
    with a filename prefix; aggregates RMS / power-ratio stats."""
    files: List[str] = []
    for ext in exts:
        files.extend(glob.glob(os.path.join(input_dir, "**", f"*{ext}"), recursive=True))
    files.sort()
    rms_vals, pr_vals, errors = [], [], 0
    for i, f in enumerate(files):
        rel = os.path.relpath(f, input_dir)
        out_path = os.path.join(output_dir, os.path.dirname(rel), prefix + os.path.basename(rel))
        try:
            res = generate_watermarked_audio(f, session, out_path, seed=seed + i)
            rms_vals.append(res["metrics"]["watermark_rms"])
            pr_vals.append(res["metrics"]["power_ratio_db"])
        except Exception:
            errors += 1
    return {
        "n_files": len(files) - errors,
        "errors": errors,
        "avg_rms": float(np.mean(rms_vals)) if rms_vals else float("nan"),
        "avg_power_ratio_db": float(np.mean(pr_vals)) if pr_vals else float("nan"),
    }


def detect_watermark_folder(
    folder: str,
    session: InferenceSession,
    *,
    threshold: float = 0.5,
    exts: Sequence[str] = (".wav",),
) -> Dict:
    """Run detection over every file; returns per-file decisions + aggregate."""
    files: List[str] = []
    for ext in exts:
        files.extend(glob.glob(os.path.join(folder, "**", f"*{ext}"), recursive=True))
    files.sort()
    per_file, errors = {}, 0
    for f in files:
        try:
            r = detect_array(load_mono_16k(f, session.sample_rate), session, threshold)
            per_file[f] = {
                "mean_probability": r["mean_probability"],
                "is_watermarked": r["is_watermarked"],
            }
        except Exception:
            errors += 1
    n_wm = sum(1 for v in per_file.values() if v["is_watermarked"])
    return {
        "per_file": per_file,
        "n_files": len(per_file),
        "errors": errors,
        "n_watermarked": n_wm,
        "fraction_watermarked": n_wm / max(1, len(per_file)),
    }


def visualize_delta(
    session: InferenceSession,
    clips: "np.ndarray",
    out_path: str,
    *,
    num_examples: int = 3,
    seed: int = 0,
) -> None:
    """Plot original vs watermarked waveforms for a few clips
    (ref: visualize_delta py/main14.py:346-364); saves a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    n = min(num_examples, clips.shape[0])
    msgs = rng.integers(0, 2**session.message_bits, size=n).astype(np.int32)
    deltas = session.embed_chunks(clips[:n].astype(np.float32), msgs)
    fig, axes = plt.subplots(n, 2, figsize=(12, 3 * n), squeeze=False)
    for i in range(n):
        axes[i][0].plot(clips[i], lw=0.5)
        axes[i][0].set_title(f"original #{i}")
        axes[i][1].plot(clips[i] + deltas[i], lw=0.5, color="tab:orange")
        axes[i][1].set_title(f"watermarked #{i} (delta RMS {np.sqrt((deltas[i]**2).mean()):.5f})")
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path)
    plt.close(fig)


def plot_confusion(cm, out_path: str, labels=("clean", "watermarked")) -> None:
    """Confusion-matrix heatmap (ref: py/main14.py:1396-1410, seaborn there;
    plain matplotlib here)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.asarray(cm)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(cm, cmap="Blues")
    for (i, j), v in np.ndenumerate(cm):
        ax.text(j, i, str(int(v)), ha="center", va="center",
                color="white" if v > cm.max() / 2 else "black")
    ax.set_xticks(range(len(labels)), labels)
    ax.set_yticks(range(len(labels)), labels)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.colorbar(im)
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path)
    plt.close(fig)


def plot_roc(labels, probs, out_path: str) -> None:
    """ROC curve figure with AUC (ref: py/main14.py:1459-1473)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fpr, tpr, _, auc_val = roc_auc(labels, probs)
    plt.figure(figsize=(5, 4))
    plt.plot(fpr, tpr, label=f"AUC = {auc_val:.4f}")
    plt.plot([0, 1], [0, 1], "k--", alpha=0.4)
    plt.xlabel("false positive rate")
    plt.ylabel("true positive rate")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path)
    plt.close()


def default_attacks(sample_rate: int, *, seed: int = 0) -> Dict[str, callable]:
    """The 12-channel attack matrix of the robustness evals (DEMO.md), each a
    function of a (N, T) tensor on any device: identity, additive noise at
    30 / 20 dB SNR, volume, biquad lowpass at 7 / 4 kHz, int16 quantisation
    (ref channel sim: main15c.ipynb cell 4), resample round trips at 8 kHz
    and the non-integer ratios 22.05 kHz (441/320) and 11.025 kHz (441/640)
    through the polyphase resampler, and the 8-bit G.711 telephony codecs
    (mu-law and A-law, dsp/codec.py).  Each noise row has its own generator
    seed (sharing one would test one noise realisation at both SNRs), and a
    row seeds a fresh generator at each call, so the watermarked and the
    clean clips of a sweep meet the same noise, as under the JAX package's
    fixed key."""
    from awm_tpu_torch.augment import add_noise, resample_roundtrip
    from awm_tpu_torch.dsp import (
        alaw_roundtrip,
        lowpass_biquad,
        mulaw_roundtrip,
        quantize_int16,
    )

    def noise(snr_db: float, row_seed: int):
        def attack(x):
            gen = torch.Generator(device=x.device).manual_seed(row_seed)
            return add_noise(x, gen, (snr_db, snr_db))

        return attack

    return {
        "none": lambda x: x,
        "noise_30db": noise(30.0, 2 * seed),
        "noise_20db": noise(20.0, 2 * seed + 1),
        "volume_0.5": lambda x: x * 0.5,
        "lowpass_7k": lambda x: lowpass_biquad(x, sample_rate, 7000.0),
        "lowpass_4k": lambda x: lowpass_biquad(x, sample_rate, 4000.0),
        "quantize_int16": quantize_int16,
        "resample_8k": lambda x: resample_roundtrip(x, 8000, sample_rate),
        "resample_22k": lambda x: resample_roundtrip(x, 22050, sample_rate),
        "resample_11k": lambda x: resample_roundtrip(x, 11025, sample_rate),
        "mulaw_8bit": mulaw_roundtrip,
        "alaw_8bit": alaw_roundtrip,
    }


def evaluate_robustness(
    session: InferenceSession,
    clips: "np.ndarray",
    *,
    seed: int = 0,
    attacks: Optional[Dict[str, callable]] = None,
    ecc: bool = False,
) -> Dict[str, Dict[str, float]]:
    """Attack-matrix robustness sweep: watermark the clips (embed_chunks, so
    the deltas are shaped where the session shapes), apply each channel
    attack to the watermarked and to the clean audio on the session's device,
    and measure detection.  Returns {attack: {wm_prob, clean_prob,
    detect_rate, ..., bit_accuracy}}; bit_accuracy is the message's survival
    under the channel, decoded with the time-mean-logit rule
    (ref decode: py/main14.py:925-929).

    ecc=True embeds SECDED codewords of random 11-bit payloads
    (awm_tpu_torch.ecc) and also reports message-exact rates per attack:
    exact_rate_raw (all 16 decoded bits right), exact_rate_ecc (payload
    recovered after single-error correction) and ecc_flagged_rate (decodes
    refused as uncorrectable: visible failures, never silent wrong payloads).
    """
    if attacks is None:
        attacks = default_attacks(session.sample_rate, seed=seed)

    clips = np.asarray(clips, dtype=np.float32)
    n = clips.shape[0]
    rng = np.random.default_rng(seed)
    payloads = None
    if ecc:
        from awm_tpu_torch.ecc import PAYLOAD_BITS, ecc_decode_batch, ecc_encode

        payloads = rng.integers(0, 2**PAYLOAD_BITS, size=n)
        msgs = np.asarray([ecc_encode(int(p)) for p in payloads], np.int32)
    else:
        msgs = rng.integers(0, 2**session.message_bits, size=n).astype(np.int32)
    deltas = session.embed_chunks(clips, msgs)
    target_bits = (msgs[:, None] & (1 << np.arange(session.message_bits))) > 0
    clean_dev = torch.from_numpy(clips).to(session.device)
    wm_dev = clean_dev + torch.from_numpy(deltas).to(session.device)

    results = {}
    for name, fn in attacks.items():
        with torch.no_grad():
            atk_wm, atk_clean = fn(wm_dev), fn(clean_dev)
        _, mlm_wm, _, p_wm = session.detect_summary(atk_wm)
        _, _, _, p_clean = session.detect_summary(atk_clean)
        # per-attack AUC, free of a threshold: an attack can push the
        # probabilities below the global 0.5 (detect_rate 0) while the
        # detector still ranks watermarked above clean perfectly; AUC tells
        # "miscalibrated under this channel" from "blind"
        _, _, _, auc = roc_auc(
            [1] * len(p_wm) + [0] * len(p_clean),
            np.concatenate([p_wm, p_clean]),
        )
        # per-channel calibrated operating point (Youden's J), split-half:
        # the threshold is fit on the even-indexed clips and the calibrated
        # rates are measured on the held-out odd-indexed ones; in-sample
        # calibration would overstate the operating point
        cal = optimal_threshold(
            [1] * len(p_wm[0::2]) + [0] * len(p_clean[0::2]),
            np.concatenate([p_wm[0::2], p_clean[0::2]]),
        )
        results[name] = {
            "wm_prob": float(p_wm.mean()),
            "clean_prob": float(p_clean.mean()),
            "detect_rate": float((p_wm > 0.5).mean()),
            "false_positive_rate": float((p_clean > 0.5).mean()),
            "auc": float(auc),
            "calibrated_threshold": cal["threshold"],
            "detect_rate_calibrated": float((p_wm[1::2] > cal["threshold"]).mean()),
            "fpr_calibrated": float((p_clean[1::2] > cal["threshold"]).mean()),
            "bit_accuracy": float(((mlm_wm > 0) == target_bits).mean()),
        }
        if ecc:
            bits = (mlm_wm > 0).astype(np.int64)  # (n, 16), LSB first
            dec_payloads, _, ok = ecc_decode_batch(bits)
            results[name]["exact_rate_raw"] = float((bits == target_bits).all(axis=1).mean())
            results[name]["exact_rate_ecc"] = float(((dec_payloads == payloads) & ok).mean())
            results[name]["ecc_flagged_rate"] = float((~ok).mean())
    return results

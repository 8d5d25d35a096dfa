"""Render a demo_eval JSON as the DEMO.md markdown tables (a copy of the
JAX package's tools/demo_table.py; its output is the same, character for
character).

Makes the end-of-arc doc update mechanical: point it at a demo_eval.json
(plus optional per_bit.txt, the JSON line bit_diagnostic prints) and paste
the output into DEMO.md.  Pure host-side formatting — no torch import.

Usage:
    python -m awm_tpu_torch.tools.demo_table runs/x/demo_eval.json \
        [--per-bit runs/x/per_bit.txt] [--vs OTHER.json]
"""
from __future__ import annotations

import argparse
import json
import os


def _f(x, nd=3):
    return "—" if x is None else f"{x:.{nd}f}"


def headline(d: dict, other: dict | None = None) -> str:
    rows = [
        ("bit accuracy (mean-logit, clean)", lambda q: q["quality"].get("bit_accuracy_mean_logit"), 3),
        ("bit accuracy (majority vote, clean)", lambda q: q["quality"].get("bit_accuracy"), 3),
        ("wm / clean prob", lambda q: None, 0),  # special-cased below
        ("fixed-threshold detect / FPR", lambda q: None, 0),
        ("delta RMS", lambda q: q["quality"].get("delta_rms"), 4),
        ("power ratio (dB)", lambda q: q["quality"].get("power_ratio_db"), 1),
        ("STOI (file round-trip)", lambda q: q["quality"].get("file_roundtrip", {}).get("stoi"), 3),
        ("SI-SNR dB (file round-trip)", lambda q: q["quality"].get("file_roundtrip", {}).get("si_snr_db"), 1),
    ]
    cols = [d] + ([other] if other else [])
    names = [os.path.basename(os.path.dirname(c.get("ckpt", "?"))) or c.get("ckpt", "?") for c in cols]
    out = ["| Axis | " + " | ".join(names) + " |", "|---|" + "---|" * len(cols)]
    for label, get, nd in rows:
        vals = []
        for c in cols:
            q = c.get("quality", {})
            if label.startswith("wm / clean"):
                vals.append(f"{_f(q.get('watermarked_prob'), 3)} / {_f(q.get('clean_prob'), 3)}")
            elif label.startswith("fixed-threshold"):
                vals.append(f"{_f(q.get('detect_rate'), 2)} / {_f(q.get('false_positive_rate'), 2)}")
            else:
                vals.append(_f(get(c), nd))
        out.append(f"| {label} | " + " | ".join(vals) + " |")
    return "\n".join(out)


def robust(d: dict) -> str:
    r = d.get("robust", {})
    out = [
        "| Channel | wm prob | clean prob | detect/FPR @0.5 | AUC | bit acc |",
        "|---|---|---|---|---|---|",
    ]
    strict = 0
    for name, m in r.items():
        det, fpr = m.get("detect_rate"), m.get("false_positive_rate")
        if det is not None and det >= 0.995 and fpr is not None and fpr <= 0.005:
            strict += 1
        out.append(
            f"| {name} | {_f(m.get('wm_prob'))} | {_f(m.get('clean_prob'))} "
            f"| {_f(det, 2)} / {_f(fpr, 2)} | {_f(m.get('auc'), 4)} "
            f"| {_f(m.get('bit_accuracy'))} |"
        )
    bits = [m.get("bit_accuracy") for m in r.values() if m.get("bit_accuracy") is not None]
    if bits:
        out.append(
            f"\nStrict 1.00/0.00 channels: **{strict}/{len(r)}**; "
            f"bit accuracy range **{min(bits):.3f}–{max(bits):.3f}**."
        )
    return "\n".join(out)


def ecc(d: dict) -> str:
    e = d.get("ecc", {})
    out = [
        "| Channel | exact (raw) | exact (SECDED) | flagged-uncorrectable | bit acc |",
        "|---|---|---|---|---|",
    ]
    for name, m in e.items():
        out.append(
            f"| {name} | {_f(m.get('exact_rate_raw'))} | {_f(m.get('exact_rate_ecc'))} "
            f"| {_f(m.get('ecc_flagged_rate'))} | {_f(m.get('bit_accuracy'))} |"
        )
    return "\n".join(out)


def variance(d: dict) -> str:
    v = d.get("variance", {})
    if not v:
        return ""
    out = [
        f"Across seeds {v.get('seeds')} ({v.get('n_per_seed')} clips/seed):",
        "",
        "| Channel | detect μ±σ | FPR μ±σ | bit acc μ±σ |",
        "|---|---|---|---|",
    ]
    for name, m in v.get("attacks", {}).items():
        def ms(key):
            s = m.get(key, {})
            if isinstance(s, dict):
                return f"{_f(s.get('mean'))}±{_f(s.get('std'))}"
            return _f(s)
        out.append(f"| {name} | {ms('detect_rate')} | {ms('false_positive_rate')} | {ms('bit_accuracy')} |")
    return "\n".join(out)


def per_bit(path: str) -> str:
    with open(path) as f:
        line = [l for l in f if l.startswith("{")]
    if not line:
        return ""
    d = json.loads(line[-1])
    ml = d["ml_acc"]
    live = sum(a > 0.7 for a in ml)
    import statistics

    return (
        f"Per-bit (n={d.get('n_eval')}): aggregate ml {sum(ml)/len(ml):.3f}, "
        f"**{live}/16 live** (>0.7), min/max {min(ml):.2f}/{max(ml):.2f}, "
        f"std {statistics.pstdev(ml):.3f}."
    )


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="demo_table", description=__doc__.splitlines()[0])
    ap.add_argument("json_path")
    ap.add_argument("--per-bit", default=None)
    ap.add_argument("--vs", default=None, help="second demo_eval.json for a comparison column")
    a = ap.parse_args(argv)
    d = _load(a.json_path)
    other = _load(a.vs) if a.vs else None

    print(f"ckpt: `{d.get('ckpt')}`  (n_eval {d.get('n_eval')})\n")
    print("### Headline\n")
    print(headline(d, other))
    if a.per_bit and os.path.isfile(a.per_bit):
        print()
        print(per_bit(a.per_bit))
    if d.get("robust"):
        print("\n### Robustness (12-channel attack matrix)\n")
        print(robust(d))
    if d.get("ecc"):
        print("\n### SECDED ECC message-exact rates\n")
        print(ecc(d))
    if d.get("variance"):
        print("\n### Variance\n")
        print(variance(d))
    if d.get("music"):
        m = d["music"]
        print(
            f"\nMusic: wm/clean prob {_f(m.get('watermarked_prob'))}/{_f(m.get('clean_prob'))}, "
            f"AUC {_f(m.get('roc_auc'), 4)}, bit acc {_f(m.get('bit_accuracy'))}, "
            f"delta RMS {_f(m.get('delta_rms'), 4)}."
        )
    if d.get("cross"):
        c = d["cross"]
        print(
            f"Cross-detector (reference detector_best.pth on our wm): clean prob "
            f"{_f(c.get('ref_detector_prob_clean'))}, our-wm prob {_f(c.get('ref_detector_prob_our_wm'))}, "
            f"AUC {_f(c.get('ref_detector_auc_vs_our_wm'), 3)} — mutually invisible carriers, as designed."
        )


if __name__ == "__main__":
    main()

"""Command line of the port: python -m awm_tpu_torch
embed|detect|verify|train|evaluate|embed-folder|detect-folder.

The commands and their arguments are those of ``python -m awm_tpu``'s
serving and evaluation commands and the subset of its ``train`` that the
port supports (the attack curriculum included; no checkpoint saving, music
mix or data parallelism yet).  Serving
weights come from a flattened ``.npz`` (--params) and the architecture from
its ``awm_arch.json`` (--arch); both default to the packaged shapecap
checkpoint.  Runs on cuda unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from awm_tpu_torch.checkpoint import SHAPECAP_ARCH, SHAPECAP_NPZ


def _load_session(args):
    import torch

    from awm_tpu_torch.api import InferenceSession

    dtype = torch.float32 if args.compute_dtype == "float32" else torch.bfloat16
    kw = {"chunk_len": args.audio_len} if args.audio_len else {}
    return InferenceSession.from_npz(
        args.params, args.arch, compute_dtype=dtype, device=args.device, **kw
    )


def cmd_embed(args):
    from awm_tpu_torch.api import generate_watermarked_audio

    res = generate_watermarked_audio(
        args.input, _load_session(args), args.output, message=args.message,
        seed=args.seed, ecc=args.ecc,
    )
    out = {"output": args.output, **res["metrics"]}
    if "payloads" in res:
        out["payloads"] = [int(p) for p in res["payloads"]]
    print(json.dumps(out, indent=2))


def cmd_detect(args):
    from awm_tpu_torch.api import detect_watermark

    r = detect_watermark(args.input, _load_session(args), args.threshold,
                         visualize=args.visualize, ecc=args.ecc)
    out = {k: r[k] for k in ("mean_probability", "is_watermarked", "decision")}
    out["predicted_message"] = r.get("predicted_message")
    if "ecc" in r:
        out["ecc"] = r["ecc"]
    print(json.dumps(out, indent=2))


def cmd_verify(args):
    from awm_tpu_torch.api import verify_watermark

    r = verify_watermark(
        args.input, _load_session(args), args.message, args.threshold,
        alpha=args.alpha, ecc=args.ecc,
    )
    print(json.dumps(r, indent=2))


_LOSS_FIELDS = {"l1": "lambda_l1", "mel": "lambda_msspec", "loud": "lambda_loud",
                "loc": "lambda_loc", "dec": "lambda_dec", "hf": "hf_penalty_w"}


def _train_config(args):
    """The preset with the command line's overrides (awm_tpu/__main__.py:27-48,
    178-245)."""
    from awm_tpu_torch.config import get_config

    cfg = get_config(args.preset)
    rep = dataclasses.replace
    if args.audio_len:
        cfg = rep(cfg, audio_len=args.audio_len)
    model = {k: getattr(args, k) for k in ("message_encoding", "decode_head", "delta_band_hz")
             if getattr(args, k) is not None}
    cfg = rep(cfg, model=rep(cfg.model, **model))
    train = {k: v for k, v in (("epochs", args.epochs), ("batch_size", args.batch_size),
                               ("early_stop_patience", args.patience), ("seed", args.seed),
                               ("freeze", args.freeze), ("compute_dtype", args.compute_dtype))
             if v is not None}
    if args.lr:  # the field the schedule reads: constant -> lr, onecycle -> max_lr
        field = "max_lr" if cfg.train.schedule.kind == "onecycle" else "lr"
        train["schedule"] = rep(cfg.train.schedule, **{field: args.lr})
    cfg = rep(cfg, train=rep(cfg.train, **train))
    loss = {}
    if args.dec_loss:
        loss["dec_loss_mode"] = args.dec_loss
    if args.dec_bit_balance is not None:
        if (args.dec_loss or cfg.loss.dec_loss_mode) != "mean":
            sys.exit("--dec-bit-balance requires --dec-loss mean")
        loss["dec_bit_balance"] = args.dec_bit_balance
    if args.loss_weights:
        for kv in args.loss_weights.split(","):
            k, _, v = kv.partition("=")
            try:
                loss[_LOSS_FIELDS[k.strip()]] = float(v)
            except (KeyError, ValueError):
                sys.exit(f"--loss-weights: expected term=value with term in "
                         f"{sorted(_LOSS_FIELDS)} and a numeric value, got {kv!r}")
    cfg = rep(cfg, loss=rep(cfg.loss, **loss))
    if args.shape_max_rms is not None:
        cfg = rep(cfg, shaping=rep(cfg.shaping, enabled=True, max_rms=args.shape_max_rms))
    if args.augment:
        # the robustness curriculum of the JAX CLI (awm_tpu/__main__.py:246-267):
        # every channel attack independently per example with p < 1, on both
        # detector halves (train._forward)
        from awm_tpu_torch.augment import AugmentConfig

        lo, hi = (float(x) for x in args.noise_snr.split(","))
        cuts = tuple(float(x) for x in args.lowpass_hz.split(","))
        rates = tuple(int(x) for x in args.resample_hz.split(","))
        cfg = rep(cfg, augment=AugmentConfig(
            noise_snr_db=(lo, hi), volume_range=(0.3, 1.2),
            lowpass_hz=cuts if len(cuts) > 1 else cuts[0],
            lowpass_filter="fir" if args.lowpass_fir else "biquad",
            quantize=True,
            resample_hz=rates if len(rates) > 1 else rates[0],
            attack_prob=args.attack_prob,
            mulaw=args.mulaw,
            val_attacks=not args.clean_val,
        ))
    return cfg


def cmd_train(args):
    from awm_tpu_torch.data import BatchLoader, OneSecClips, SyntheticClips, split_indices
    from awm_tpu_torch.trainer import fit

    cfg = _train_config(args)
    if args.data:
        ds = OneSecClips(args.data, cfg.sample_rate, cfg.audio_len)
        if not len(ds):
            sys.exit(f"no .wav files under {args.data}")
    else:
        print("no --data given; training on synthetic clips (smoke mode)")
        ds = SyntheticClips(n=args.synthetic_n, audio_len=cfg.audio_len)
    tr_idx, va_idx, _ = split_indices(len(ds), (0.8, 0.1, 0.1), seed=cfg.train.seed)
    # val keeps its partial batch, so a small split still validates
    mk = lambda idx, shuffle: BatchLoader(
        ds, cfg.train.batch_size, indices=idx, shuffle=shuffle, drop_last=shuffle,
        seed=cfg.train.seed, num_workers=args.workers,
    )
    out = fit(cfg, mk(tr_idx, True), mk(va_idx, False), init_from=args.init_from,
              log_path=args.log_csv, seed=cfg.train.seed, select_metric=args.select_metric,
              device=args.device)
    print(json.dumps({"best_val": out["best_val"], "epochs": len(out["history"]),
                      "stopped_early": out["stopped_early"]}, indent=2))
    return out


def cmd_evaluate(args):
    from awm_tpu_torch.eval import evaluate_corpus, interpret_results

    out = evaluate_corpus(args.data, _load_session(args), max_files=args.max_files)
    report = out.pop("report", "")
    print(json.dumps(out, indent=2))
    print(report)
    if "accuracy" in out:
        print(interpret_results(out["accuracy"]))
    return out


def cmd_embed_folder(args):
    from awm_tpu_torch.eval import embed_watermark_folder

    out = embed_watermark_folder(args.input, args.output, _load_session(args))
    print(json.dumps(out, indent=2))
    return out


def cmd_detect_folder(args):
    from awm_tpu_torch.eval import detect_watermark_folder

    out = detect_watermark_folder(args.input, _load_session(args), threshold=args.threshold)
    out.pop("per_file")
    print(json.dumps(out, indent=2))
    return out


def _add_session_args(p):
    p.add_argument("--params", default=SHAPECAP_NPZ,
                   help="flattened {'params','batch_stats'} .npz (default: packaged shapecap)")
    p.add_argument("--arch", default=SHAPECAP_ARCH,
                   help="awm_arch.json of those weights (default: packaged shapecap)")
    p.add_argument("--audio-len", type=int, help="override chunk length in samples (default 16000)")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="inference compute dtype (float32 = strict, TF32 off)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="awm_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("embed", help="watermark an audio file")
    _add_session_args(p)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--message", type=int, help="fixed 16-bit message (default: random per chunk)")
    p.add_argument("--seed", type=int)
    p.add_argument("--ecc", action="store_true",
                   help="treat --message as an 11-bit payload and embed its SECDED codeword")
    p.set_defaults(fn=cmd_embed)

    p = sub.add_parser("detect", help="detect a watermark in an audio file")
    _add_session_args(p)
    p.add_argument("input")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--visualize", action="store_true", help="save temporal-probability plot")
    p.add_argument("--ecc", action="store_true",
                   help="decode the 16 bits as a SECDED codeword")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("verify", help="authenticate a file against an expected message")
    _add_session_args(p)
    p.add_argument("input")
    p.add_argument("--message", type=int, required=True,
                   help="the 16-bit message the file is expected to carry")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--alpha", type=float, default=0.01,
                   help="significance level of the bit-agreement test")
    p.add_argument("--ecc", action="store_true",
                   help="--message is an 11-bit payload; verify against its SECDED codeword")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("train", help="train generator+detector")
    p.add_argument("--preset", default="base", help="base, light, onecycle20, quality or ft_robust")
    p.add_argument("--audio-len", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--data", help="directory of 1-s wav clips")
    p.add_argument("--synthetic-n", type=int, default=256)
    p.add_argument("--epochs", type=int)
    p.add_argument("--init-from", help="flattened .npz to fine-tune from (e.g. the packaged "
                                       "shapecap weights)")
    p.add_argument("--lr", type=float, help="override the schedule's (peak) learning rate")
    p.add_argument("--patience", type=int, help="early-stopping patience override")
    p.add_argument("--freeze", choices=("gen", "det"),
                   help="train only the other network; the frozen one keeps its params and "
                        "BN statistics")
    p.add_argument("--select-metric",
                   help="comma-separated val loss terms whose sum drives early stopping")
    p.add_argument("--augment", action="store_true",
                   help="on-device channel-attack curriculum (noise/volume/"
                        "lowpass/quantize/resample, per-example probability)")
    p.add_argument("--attack-prob", type=float, default=0.35,
                   help="per-example per-attack application probability")
    p.add_argument("--noise-snr", default="15,40",
                   help="noise-attack SNR range 'min,max' dB for --augment "
                        "(train past the eval edge: a curriculum whose MINIMUM "
                        "equals the eval SNR leaves that SNR undetected)")
    p.add_argument("--lowpass-fir", action="store_true",
                   help="use the steep 101-tap FIR for the --augment lowpass "
                        "attack instead of the biquad (the biquad's soft "
                        "rolloff leaks out-of-band carrier energy; the FIR "
                        "forces the watermark fully below the cutoff, which "
                        "resample-channel survival requires)")
    p.add_argument("--lowpass-hz", default="7000",
                   help="lowpass-attack cutoff(s) in Hz for --augment; a "
                        "comma list becomes a per-example curriculum (e.g. "
                        "'3500,5000,7000' keeps the watermark carrier below "
                        "the harshest cutoff so out-of-band lowpass attacks "
                        "cannot strip it)")
    p.add_argument("--resample-hz", default="8000",
                   help="resample-attack target rate(s) in Hz for --augment; "
                        "a comma list becomes a per-example curriculum.  Any "
                        "rational ratio works (polyphase, dsp.resample), e.g. "
                        "'8000,11025,22050'")
    p.add_argument("--mulaw", action="store_true",
                   help="add an 8-bit G.711 mu-law round trip to the "
                        "--augment attack chain (telephony codec, "
                        "dsp/codec.py, audioop-exact)")
    p.add_argument("--clean-val", action="store_true",
                   help="validate on CLEAN batches even with --augment.  By "
                        "default validation applies the same attack curriculum "
                        "with deterministic epoch-independent draws, so "
                        "--select-metric loc,dec tracks detection UNDER attack "
                        "(clean loc/dec are already converged at fine-tune "
                        "start and would freeze selection at epoch 0)")
    p.add_argument("--message-encoding", choices=("table", "bits"))
    p.add_argument("--decode-head", choices=("shared", "dilated"))
    p.add_argument("--delta-band-hz", type=float)
    p.add_argument("--dec-loss", choices=("per_sample", "mean"))
    p.add_argument("--loss-weights", help="e.g. 'dec=5,l1=0.2' (terms: l1, mel, loud, loc, dec, hf)")
    p.add_argument("--shape-max-rms", type=float, default=None,
                   help="enable the main16 shaping chain with this limit_rms cap")
    p.add_argument("--dec-bit-balance", type=float, default=None,
                   help="per-bit dec re-weighting exponent (needs --dec-loss mean)")
    p.add_argument("--seed", type=int, help="training seed (init, split, shuffle, messages)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--log-csv", default=None)
    p.add_argument("--compute-dtype", choices=("bfloat16", "float32"),
                   help="conv/BN compute dtype of the step (default: the preset's, bfloat16)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="corpus sweep: accuracy/AUC/K-fold")
    _add_session_args(p)
    p.add_argument("data")
    p.add_argument("--max-files", type=int)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("embed-folder", help="watermark a directory tree")
    _add_session_args(p)
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_embed_folder)

    p = sub.add_parser("detect-folder", help="detect over a directory tree")
    _add_session_args(p)
    p.add_argument("input")
    p.add_argument("--threshold", type=float, default=0.5)
    p.set_defaults(fn=cmd_detect_folder)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

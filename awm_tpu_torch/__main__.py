"""Command line of the port: python -m awm_tpu_torch
embed|detect|verify|train|curriculum|evaluate|embed-folder|detect-folder|serve|prep|bench.

The commands and their arguments are those of ``python -m awm_tpu``;
``bench`` prints the JSON line of the repo-level bench.py, measured on the
card (awm_tpu_torch/bench.py).  ``train --data-parallel [--model-parallel K]`` trains on
every rank of a torchrun launch (``torchrun --nproc-per-node N -m
awm_tpu_torch train --data-parallel``; one card a rank, NCCL, or gloo with
--device cpu); without torchrun it is a world of one.  Sessions load a
checkpoint directory of the port (--ckpt: its recorded architecture and
shaping chain), the reference's torch .pth weights (--torch-generator /
--torch-detector of the preset's family, fp32 unless --compute-dtype says
otherwise), or a flattened .npz with its awm_arch.json (--params / --arch,
the packaged shapecap checkpoint by default for the base family's presets;
a strided session given no weights starts from the seed-0 init, as the JAX
package's does).  Architecture flags only validate against
a recorded architecture.  Every command runs on cuda unless --device cpu is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

_ARCH_FLAGS = ("message_encoding", "decode_head", "delta_band_hz")


def _session_config(args, recorded, source):
    """The preset with --audio-len, and the architecture recorded at
    `source` (a dict from read_arch, or None): an architecture flag that
    conflicts with it exits (awm_tpu/__main__.py:62-90)."""
    from awm_tpu_torch.checkpoint import configs_from_arch
    from awm_tpu_torch.config import get_config

    cfg = get_config(args.preset)
    if args.audio_len:
        cfg = dataclasses.replace(cfg, audio_len=args.audio_len)
    given = {k: getattr(args, k) for k in _ARCH_FLAGS if getattr(args, k) is not None}
    if recorded is None:
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **given))
    model, shaping = configs_from_arch(recorded)
    for flag, value in given.items():
        if value != getattr(model, flag):
            sys.exit(f"--{flag.replace('_', '-')}={value} conflicts with the checkpoint's recorded "
                     f"architecture ({flag}={getattr(model, flag)!r} in {source})")
    return dataclasses.replace(cfg, model=model, shaping=shaping or cfg.shaping)


def _load_session(args):
    import torch

    from awm_tpu_torch import checkpoint as ck
    from awm_tpu_torch.api import InferenceSession
    from awm_tpu_torch.config import get_config
    from awm_tpu_torch.models import build_models

    from_torch = args.torch_generator or args.torch_detector
    if args.compute_dtype:
        dtype = torch.float32 if args.compute_dtype == "float32" else torch.bfloat16
    else:  # imported reference weights: strict fp32 parity unless asked otherwise
        dtype = torch.float32 if from_torch else torch.bfloat16
    if args.ckpt:
        path, source = args.ckpt, os.path.join(args.ckpt, ck.ARCH_FILE)
    elif from_torch or (args.params is None and get_config(args.preset).model.family != "base"):
        path, source = None, None
    else:
        path, source = args.params or ck.SHAPECAP_NPZ, args.arch or ck.SHAPECAP_ARCH
    cfg = _session_config(args, ck.read_arch(source) if source else None, source)
    with torch.random.fork_rng(devices=[]):  # the networks not imported start from seed 0
        torch.manual_seed(0)
        gen, det = build_models(cfg.model)
    if path:
        ck.restore_params(path, gen, det)
    strided, n_strides = cfg.model.family == "strided", len(cfg.model.strides)
    if args.torch_generator:
        gen.load_state_dict(ck.import_torch_strided_generator(args.torch_generator, n_strides)
                            if strided else ck.import_torch_generator(args.torch_generator))
    if args.torch_detector:
        det.load_state_dict(ck.import_torch_strided_detector(args.torch_detector, n_strides)
                            if strided else ck.import_torch_detector(args.torch_detector))
    return InferenceSession(gen, det, message_bits=cfg.message_bits, sample_rate=cfg.sample_rate,
                            chunk_len=cfg.audio_len, compute_dtype=dtype, shaping=cfg.shaping,
                            device=args.device)


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


def _train_mesh(args):
    """(mesh, device) of a train command: with --data-parallel the group of
    torchrun's ranks (or of this process alone), each rank on the card of
    its LOCAL_RANK unless --device cpu; else (None, --device)."""
    if not args.data_parallel:
        return None, args.device
    import torch

    from awm_tpu_torch.parallel import initialize_distributed, make_mesh

    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(device=device)
    return make_mesh(model_parallel=args.model_parallel), device


def cmd_train(args):
    from awm_tpu_torch.data import (BatchLoader, ConcatClips, OneSecClips, SyntheticClips,
                                    SyntheticMusicClips, split_indices)
    from awm_tpu_torch.parallel.mesh import is_lead
    from awm_tpu_torch.trainer import fit

    cfg = _train_config(args)
    mesh, device = _train_mesh(args)
    if args.data:
        ds = OneSecClips(args.data, cfg.sample_rate, cfg.audio_len)
        if not len(ds):
            sys.exit(f"no .wav files under {args.data}")
        n_total = len(ds)
    else:
        if is_lead(mesh):
            print("no --data given; training on synthetic clips (smoke mode)")
        n_total = args.synthetic_n
        ds = SyntheticClips(n=n_total - int(round(args.music_frac * n_total)), audio_len=cfg.audio_len)
    if args.music_frac > 0.0:
        # the music share of the final corpus: synthetic keeps the total at
        # --synthetic-n, --data gets music on top.  Music seed 1; demo_eval's
        # music section draws seed 7, so its clips stay unseen.
        ds = ConcatClips(ds, SyntheticMusicClips(n=int(round(args.music_frac * n_total)),
                                                 audio_len=cfg.audio_len, seed=1))
    tr_idx, va_idx, _ = split_indices(len(ds), (0.8, 0.1, 0.1), seed=cfg.train.seed)
    # val keeps its partial batch, so a small split still validates
    mk = lambda idx, shuffle: BatchLoader(
        ds, cfg.train.batch_size, indices=idx, shuffle=shuffle, drop_last=shuffle,
        seed=cfg.train.seed, num_workers=args.workers,
    )
    out = fit(cfg, mk(tr_idx, True), mk(va_idx, False), ckpt_dir=args.ckpt_dir,
              init_from=args.init_from, log_path=args.log_csv, plot_path=args.loss_plot,
              seed=cfg.train.seed, select_metric=args.select_metric, device=device, mesh=mesh)
    if is_lead(mesh):
        print(json.dumps({"best_val": out["best_val"], "epochs": len(out["history"]),
                          "stopped_early": out["stopped_early"]}, indent=2))
    return out


# Staged training recipes as data: leg name -> (extra train argv, robust?,
# environment argv appended last, so it wins argparse's last-occurrence
# rule).  A copy of awm_tpu/__main__.py's table (312-402), whose comments
# give the measurements behind each leg's flags and order.
_BL_ENV = ["--music-frac", "0.0", "--resample-hz", "8000"]

_CURRICULA = {
    "robust_decode": {
        "common": ["--message-encoding", "bits", "--dec-loss", "mean",
                   "--delta-band-hz", "3000"],
        "robust": ["--augment", "--attack-prob", "0.45", "--noise-snr", "10,40",
                   "--lowpass-hz", "3500,5000,7000",
                   "--resample-hz", "8000,11025,22050"],
        "legs": [
            # clean scratch, shared decode head, relaxed perceptual budget
            ("A_shared", ["--epochs", "22", "--patience", "6",
                          "--loss-weights", "dec=10,loud=3,mel=1",
                          "--select-metric", "dec"], False, []),
            # dilated head added fresh (restore_params keeps init for new leaves)
            ("B_dilated", ["--decode-head", "dilated", "--epochs", "18",
                           "--patience", "6",
                           "--loss-weights", "dec=10,loud=3,mel=1",
                           "--select-metric", "dec"], False, []),
            # channel-attack curriculum, budget held, no balance
            ("C_robust", ["--decode-head", "dilated", "--epochs", "26",
                          "--patience", "99",
                          "--loss-weights", "dec=10,loud=3,mel=1",
                          "--select-metric", "loc,dec"], True, []),
            # first post-robust budget step, no balance
            ("D2_budget", ["--decode-head", "dilated", "--epochs", "28",
                           "--patience", "99",
                           "--loss-weights", "dec=10,loud=6,mel=1.5",
                           "--select-metric", "loc,dec"], True, []),
            # balance turned on at the held budget
            ("E2_balance", ["--decode-head", "dilated", "--epochs", "30",
                            "--patience", "99", "--dec-bit-balance", "1.0",
                            "--loss-weights", "dec=10,loud=6,mel=1.5",
                            "--select-metric", "loc,dec"], True, _BL_ENV),
            # gradual re-tighten with balance held
            ("F2_tighten", ["--decode-head", "dilated", "--epochs", "40",
                            "--patience", "99", "--dec-bit-balance", "1.0",
                            "--loss-weights", "dec=10,loud=8,mel=1.75",
                            "--select-metric", "loc,dec"], True, _BL_ENV),
            ("G2_tighten", ["--decode-head", "dilated", "--epochs", "30",
                            "--patience", "99", "--dec-bit-balance", "1.0",
                            "--loss-weights", "dec=10,loud=10,mel=2.0",
                            "--select-metric", "loc,dec"], True, _BL_ENV),
            ("H2_tighten", ["--decode-head", "dilated", "--epochs", "30",
                            "--patience", "99", "--dec-bit-balance", "1.0",
                            "--loss-weights", "dec=10,loud=13,mel=2.5,loc=14",
                            "--select-metric", "loc,dec"], True, _BL_ENV),
        ],
    },
}


def cmd_curriculum(args):
    """Run a staged recipe; each leg fine-tunes the previous leg's
    ckpt_best.  A finished leg leaves a .done marker and is skipped on a
    re-run.  Each leg's TrainState is dropped before the next one starts."""
    import gc

    rec = _CURRICULA[args.recipe]
    leg_names = [n for n, *_ in rec["legs"]]
    if args.stop_after and args.stop_after not in leg_names:
        raise SystemExit(f"--stop-after {args.stop_after!r} is not a leg of {args.recipe!r}; "
                         f"legs: {', '.join(leg_names)}")
    shared = ["--batch-size", str(args.batch_size), "--music-frac", str(args.music_frac),
              "--workers", str(args.workers)]
    shared += ["--data", args.data] if args.data else ["--synthetic-n", str(args.synthetic_n)]
    if args.seed is not None:
        shared += ["--seed", str(args.seed)]
    if args.audio_len:
        shared += ["--audio-len", str(args.audio_len)]
    if args.data_parallel:
        shared += ["--data-parallel", "--model-parallel", str(args.model_parallel)]

    prev = args.init_from
    legs_out = {}
    for name, leg, robust, env_override in rec["legs"]:
        d = os.path.join(args.out, name)
        marker = os.path.join(d, ".done")
        if os.path.isfile(marker):
            print(f"curriculum: leg {name} already done, skipping", flush=True)
        else:
            leg = list(leg)
            k = leg.index("--epochs") + 1
            if args.smoke:
                leg[k] = "1"
            elif args.epochs_scale != 1.0:
                leg[k] = str(max(1, round(int(leg[k]) * args.epochs_scale)))
            argv = ["train"] + rec["common"] + shared + leg
            argv += rec["robust"] if robust else []
            argv += env_override  # last occurrence wins in argparse
            if prev:
                argv += ["--init-from", prev]
            argv += ["--ckpt-dir", d, "--log-csv", os.path.join(d, "metrics.csv"),
                     "--device", args.device]
            print(f"== curriculum leg {name}: awm_tpu_torch " + " ".join(argv), flush=True)
            main(argv)  # its TrainState is dropped here
            gc.collect()
            with open(marker, "w") as f:
                f.write("")
        prev = os.path.join(d, "ckpt_best")
        legs_out[name] = prev
        if args.stop_after and name == args.stop_after:
            print(f"curriculum: stopping after leg {name} (--stop-after)", flush=True)
            break
    out = {"recipe": args.recipe, "legs": legs_out, "final_ckpt": prev}
    print(json.dumps(out, indent=2))
    return out


def cmd_prep(args):
    """The dataset tools of data/prep.py (awm_tpu/__main__.py:510-549)."""
    from awm_tpu_torch.data import prep

    if args.prep_cmd == "metadata":
        n = prep.build_metadata(args.dir, args.output)
        print(f"wrote {n} rows to {args.output}")
    elif args.prep_cmd == "select":
        n, total = prep.select_audios(args.metadata, args.output, hours=args.hours,
                                      seconds=args.seconds, seed=args.seed)
        print(f"selected {n} files / {total / 3600:.2f} h -> {args.output}")
    elif args.prep_cmd == "segment":
        if args.metadata:
            files = [p for p, _ in prep.read_metadata(args.metadata)]
        else:
            import glob

            files = sorted(glob.glob(os.path.join(args.dir, "**", "*.wav"), recursive=True))
        n = prep.segment_to_clips(files, args.output, seg_seconds=args.seconds or 1.0,
                                  per_file_subdirs=args.subdirs, workers=args.workers)
        print(f"wrote {n} clips to {args.output}")
    elif args.prep_cmd == "classify":
        if args.sample:
            print(json.dumps(prep.sample_feature_stats(args.dir, args.sample, full=args.full),
                             indent=2))
            return
        print(json.dumps(prep.classify_folder(args.dir, args.output, workers=args.workers,
                                              max_files=args.max_files, full=args.full), indent=2))
    elif args.prep_cmd == "speech-only":
        n = prep.copy_speech_only(args.list, args.output)
        print(f"copied {n} speech files to {args.output}")
    elif args.prep_cmd == "silent":
        for p in prep.find_silent(args.dir, args.threshold):
            print(p)
    elif args.prep_cmd == "compare":
        print(json.dumps(prep.compare_metadata(args.a, args.b), indent=2))


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


def cmd_serve(args):
    from awm_tpu_torch.serve import serve

    serve(_load_session(args), host=args.host, port=args.port, max_batch=args.max_batch,
          max_wait_ms=args.max_wait_ms)


def cmd_bench(args):
    from awm_tpu_torch.bench import main as bench_main

    return bench_main(args.device)


def _add_session_args(p):
    p.add_argument("--preset", default="base",
                   help="config preset (base, light, onecycle20, quality, ft_robust, strided)")
    p.add_argument("--ckpt", help="checkpoint directory of the port (train --ckpt-dir's "
                                  "ckpt_best / ckpt_latest); its awm_arch.json is adopted")
    p.add_argument("--torch-generator", help="reference generator_best.pth to import")
    p.add_argument("--torch-detector", help="reference detector_best.pth to import")
    p.add_argument("--params", default=None,
                   help="flattened {'params','batch_stats'} .npz when neither --ckpt nor "
                        "--torch-* is given (default: packaged shapecap for the base "
                        "family; none for strided: its seed-0 init)")
    p.add_argument("--arch", default=None,
                   help="awm_arch.json of those weights (default: packaged shapecap)")
    p.add_argument("--audio-len", type=int, help="override chunk length in samples (default 16000)")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   help="inference compute dtype (default: bfloat16, or float32 when "
                        "importing --torch-* weights; float32 = strict, TF32 off)")
    # must match how the checkpoint was trained; with a recorded
    # architecture they only validate against it
    p.add_argument("--message-encoding", choices=("table", "bits"),
                   help="generator message pathway the checkpoint was trained with")
    p.add_argument("--decode-head", choices=("shared", "dilated"),
                   help="detector bit head the checkpoint was trained with")
    p.add_argument("--delta-band-hz", type=float,
                   help="carrier band-limit the checkpoint was trained with")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def parse_args(argv=None) -> argparse.Namespace:
    """The parsed command line; its .fn runs the command."""
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
    p.add_argument("--preset", default="base",
                   help="base, light, onecycle20, quality, ft_robust or strided")
    p.add_argument("--audio-len", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--data", help="directory of 1-s wav clips")
    p.add_argument("--synthetic-n", type=int, default=256)
    p.add_argument("--music-frac", type=float, default=0.0,
                   help="fraction of the training corpus drawn from synthetic music clips "
                        "(tonal-content curriculum axis)")
    p.add_argument("--epochs", type=int)
    p.add_argument("--ckpt-dir", default=None,
                   help="write ckpt_best (on improvement of the select metric) and "
                        "ckpt_latest (every epoch) here, and resume from ckpt_latest; "
                        "default: no checkpoints")
    p.add_argument("--init-from", help="checkpoint directory of the port or flattened .npz to "
                                       "fine-tune from (weights only; e.g. the packaged "
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
    p.add_argument("--loss-plot", default=None, help="loss-curve PNG (needs matplotlib)")
    p.add_argument("--compute-dtype", choices=("bfloat16", "float32"),
                   help="conv/BN compute dtype of the step (default: the preset's, bfloat16)")
    p.add_argument("--data-parallel", action="store_true",
                   help="train on every rank of a torchrun launch, the batch sharded over the "
                        "mesh's data axis (one process: a world of one)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks a model group: the message table's rows are sharded over them")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; under torchrun cuda:$LOCAL_RANK)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("curriculum", help="staged multi-leg training recipe in one command")
    p.add_argument("recipe", choices=sorted(_CURRICULA))
    p.add_argument("--out", required=True, help="root dir; one subdir per leg")
    p.add_argument("--data", help="directory of 1-s wav clips")
    p.add_argument("--synthetic-n", type=int, default=24576)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--music-frac", type=float, default=0.15)
    p.add_argument("--audio-len", type=int)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--seed", type=int, help="training seed for every leg")
    p.add_argument("--init-from", help="start the first leg from a checkpoint")
    p.add_argument("--smoke", action="store_true", help="1 epoch per leg (pipeline smoke test)")
    p.add_argument("--epochs-scale", type=float, default=1.0,
                   help="scale every leg's epoch budget (e.g. 0.5)")
    p.add_argument("--stop-after", default=None,
                   help="stop after the named leg finishes; a re-run continues (finished "
                        "legs are skipped)")
    p.add_argument("--data-parallel", action="store_true",
                   help="every leg trains with train --data-parallel")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--device", default="cuda", help="torch device of every leg (default cuda)")
    p.set_defaults(fn=cmd_curriculum)

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

    p = sub.add_parser("serve", help="HTTP embed/detect server")
    _add_session_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--max-batch", type=int, default=256,
                   help="micro-batch chunk budget per device call")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max time a request waits for batch co-riders")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("prep", help="dataset creation tools (host only)")
    psub = p.add_subparsers(dest="prep_cmd", required=True)
    q = psub.add_parser("metadata")
    q.add_argument("dir")
    q.add_argument("output")
    q = psub.add_parser("select")
    q.add_argument("metadata")
    q.add_argument("output")
    q.add_argument("--hours", type=float)
    q.add_argument("--seconds", type=float)
    q.add_argument("--seed", type=int)
    q = psub.add_parser("segment")
    q.add_argument("output")
    q.add_argument("--metadata")
    q.add_argument("--dir")
    q.add_argument("--seconds", type=float, default=1.0)
    q.add_argument("--subdirs", action="store_true")
    q.add_argument("--workers", type=int, default=8)
    q = psub.add_parser("classify")
    q.add_argument("dir")
    q.add_argument("output")
    q.add_argument("--workers", type=int, default=8)
    q.add_argument("--max-files", type=int)
    q.add_argument("--full", action="store_true",
                   help="record the full noise.py feature set (MFCC stats, spectral "
                        "bandwidth/rolloff, order-5 band filter)")
    q.add_argument("--sample", type=int,
                   help="tuning mode: analyze N random files and print per-feature "
                        "statistics instead of classifying the folder")
    q = psub.add_parser("speech-only")
    q.add_argument("list")
    q.add_argument("output")
    q = psub.add_parser("silent")
    q.add_argument("dir")
    q.add_argument("--threshold", type=float, default=1e-4)
    q = psub.add_parser("compare")
    q.add_argument("a")
    q.add_argument("b")
    p.set_defaults(fn=cmd_prep)

    p = sub.add_parser("bench", help="embed+detect, detect-only and train-step clips/s of the "
                                     "base preset on one card (one JSON line)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(fn=cmd_bench)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        main()
    finally:  # a process group exists only where the parallel package was imported
        if "awm_tpu_torch.parallel" in sys.modules:
            sys.modules["awm_tpu_torch.parallel"].shutdown()

"""Per-bit-position decode diagnostic (counterpart of tools/bit_diagnostic.py).

Are a checkpoint's decode errors spread over the 16 bit positions (a
carrier-SNR limit: budget or band) or concentrated in a few dead channels
(a head problem)?  Prints a per-bit table (accuracy under the vote and the
mean-logit decode rules, and the mean |time-mean logit| as a channel
strength) and one JSON line.  Like the JAX tool it adopts the checkpoint's
architecture but not its shaping chain (relevant with --attack only:
embed_detect applies none).

Usage:
    python -m awm_tpu_torch.tools.bit_diagnostic --ckpt runs/x/ckpt_best
        [--n-eval 256] [--batch-size 128] [--attack resample_8k] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from awm_tpu_torch.tools.demo_eval import add_checkpoint_args, load_checkpoint, test_clips


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bit_diagnostic", description=__doc__.splitlines()[0])
    add_checkpoint_args(ap)
    ap.add_argument("--n-eval", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attack", default=None,
                    help="apply a named channel attack (eval.default_attacks, e.g. "
                         "resample_8k) to the watermarked audio before detection")
    args = ap.parse_args(argv)

    import torch

    from awm_tpu_torch.eval import default_attacks

    sess, _ = load_checkpoint(args, shaping=False)
    clips = test_clips(sess.chunk_len, args.synthetic_n, args.n_eval)
    attack_fn = None
    if args.attack:
        table = default_attacks(sess.sample_rate, seed=args.seed)
        if args.attack not in table:
            raise SystemExit(f"--attack must be one of {sorted(table)}")
        attack_fn = table[args.attack]

    bits = sess.message_bits
    rng = np.random.default_rng(args.seed)
    vote_hits, ml_hits, abs_logit = np.zeros(bits), np.zeros(bits), np.zeros(bits)
    n = 0
    for i in range(0, len(clips), args.batch_size):
        s = clips[i : i + args.batch_size]
        msgs = rng.integers(0, 2**bits, size=len(s)).astype(np.int32)
        if attack_fn is None:
            out = sess.embed_detect(s, msgs)
            mlm, mvf = out["msg_logit_mean"], out["msg_vote_frac"]
        else:  # the attack runs on the session's device
            wm = torch.from_numpy(s + sess.embed_chunks(s, msgs)).to(sess.device)
            _, mlm, mvf, _ = sess.detect_summary(attack_fn(wm))
        target = (msgs[:, None] & (1 << np.arange(bits))) > 0
        vote_hits += ((mvf > 0.5) == target).sum(axis=0)
        ml_hits += ((mlm > 0) == target).sum(axis=0)
        abs_logit += np.abs(mlm).sum(axis=0)
        n += len(s)

    vote_acc, ml_acc, strength = vote_hits / n, ml_hits / n, abs_logit / n
    print(f"{'bit':>3} {'vote_acc':>9} {'ml_acc':>8} {'|logit|':>8}")
    for b in range(bits):
        print(f"{b:>3} {vote_acc[b]:>9.4f} {ml_acc[b]:>8.4f} {strength[b]:>8.3f}")
    print(f"agg vote {vote_acc.mean():.4f}  ml {ml_acc.mean():.4f}  "
          f"ml min/max {ml_acc.min():.4f}/{ml_acc.max():.4f}  std {ml_acc.std():.4f}")
    report = {
        "ckpt": args.ckpt,
        "attack": args.attack,
        "n_eval": n,
        "vote_acc": [round(float(v), 4) for v in vote_acc],
        "ml_acc": [round(float(v), 4) for v in ml_acc],
        "mean_abs_logit": [round(float(v), 3) for v in strength],
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

#!/bin/bash
# Real-corpus readiness drill of the port (counterpart of
# tools/corpus_drill.sh).
#
# Proves the full disk path a VoxPopuli user would run, end to end, ON
# FILES, through the port's CLI only, with the native wav decoder in the
# training loader:
#
#   raw multi-second WAVs -> prep metadata -> prep select -> prep segment
#   -> prep classify -> prep speech-only -> train --data -> demo_eval
#
# Mirrors the reference L0->L4 path (ref: dataset_creation/subset.py,
# select_audios.py, 1_sec_files.py:59-78, noise_mul.py, speech_only.py ->
# py/main14.py:370-385).  A user with a real corpus runs the SAME commands
# minus the synthesis step.
#
# Usage: bash awm_tpu_torch/tools/corpus_drill.sh [DIR] [DEVICE]
#   DIR     work directory, emptied first (default: a new directory under
#           ${TMPDIR:-/tmp}, printed).  The CSVs in evidence/drill/ were
#           written in /tmp/awm_corpus_drill: compare them with DIR's after
#           putting that name in place of DIR.
#   DEVICE  torch device of train and demo_eval (default cuda)
set -ex
cd "$(dirname "$0")/../.."
D=${1:-$(mktemp -d "${TMPDIR:-/tmp}/awm_corpus_drill.XXXXXX")}
echo "drill directory: $D"
DEV=${2:-cuda}
rm -rf "$D" && mkdir -p "$D/raw"

# 0. synthesize a raw "downloaded corpus": 96 speech-like multi-second WAVs
#    + 24 noise WAVs that the classifier must reject (stand-in for
#    VoxPopuli's non-speech segments)
python - "$D" <<'EOF'
import sys, numpy as np
from awm_tpu_torch.data.dataset import SyntheticClips
from awm_tpu_torch.utils.audio_io import save_wav

d = sys.argv[1]
ds = SyntheticClips(n=1024, audio_len=16000)
rng = np.random.default_rng(42)
k = 0
for i in range(96):  # 3-8 s speech-like files
    n = int(rng.integers(3, 9))
    wav = np.concatenate([ds[k + j] for j in range(n)]); k += n
    save_wav(f"{d}/raw/speech_{i:03d}.wav", wav, 16000)
for i in range(24):  # noise files (white / lowpassed white)
    n = int(rng.integers(3, 7)) * 16000
    x = rng.standard_normal(n).astype(np.float32)
    if i % 2:
        x = np.convolve(x, np.ones(8) / 8.0, mode="same")
    save_wav(f"{d}/raw/other_{i:03d}.wav", 0.08 * x, 16000)
print("raw corpus written")
EOF

# 1. metadata CSV over the raw corpus (ref: dataset_creation/subset.py)
python -m awm_tpu_torch prep metadata "$D/raw" "$D/metadata.csv"

# 2. duration-budgeted random selection (ref: select_audios.py) — 9 min
python -m awm_tpu_torch prep select "$D/metadata.csv" "$D/selected.csv" --seconds 540 --seed 0

# 3. segment into 1-s clips (ref: 1_sec_files.py:59-78)
python -m awm_tpu_torch prep segment --metadata "$D/selected.csv" "$D/clips"

# 4. speech/noise classification over the clips (ref: noise_mul.py)
python -m awm_tpu_torch prep classify "$D/clips" "$D/classified" --workers 8

# 5. keep speech only (ref: speech_only.py)
python -m awm_tpu_torch prep speech-only "$D/classified/speech_files.txt" "$D/speech"

# 6. train on the disk corpus — OneSecClips + the native wav batch decoder
python -m awm_tpu_torch train --data "$D/speech" \
    --epochs 2 --batch-size 32 \
    --ckpt-dir "$D/run" --log-csv "$D/run/metrics.csv" --device "$DEV"

# 7. sanity eval on the trained checkpoint
python -m awm_tpu_torch.tools.demo_eval --ckpt "$D/run/ckpt_best" \
    --sections quality --n-eval 64 --synthetic-n 512 --batch-size 32 \
    --device "$DEV" > "$D/demo_eval.json"
echo DRILL_DONE

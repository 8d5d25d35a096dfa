"""Input pipeline: 1-second clip datasets and a prefetching batch loader
(the port's own copy of awm_tpu/data/dataset.py).

Clips are decoded on host threads while the card computes, and the loop
gets ready (B, T) float32 numpy batches.  A filepath-backed dataset
(OneSecClips) is decoded a batch per C call by the native WAV decoder
(data/native.py) where g++ could build it, else through utils/audio_io.
The two agree bit for bit on files at the target rate; on other rates the
native decoder interpolates linearly and utils/audio_io resamples
polyphase, as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import os
import warnings
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from awm_tpu_torch.config import AUDIO_LEN, SAMPLE_RATE
from awm_tpu_torch.utils.audio_io import load_audio, resample, to_mono


class OneSecClips:
    """Recursive *.wav dataset of fixed-length mono clips: resampled to
    sample_rate, then cut or zero-padded to audio_len."""

    def __init__(self, root_dir: str, sample_rate: int = SAMPLE_RATE, audio_len: int = AUDIO_LEN):
        self.filepaths: List[str] = sorted(
            glob.glob(os.path.join(root_dir, "**", "*.wav"), recursive=True)
        )
        self.sample_rate = sample_rate
        self.audio_len = audio_len

    def __len__(self) -> int:
        return len(self.filepaths)

    def __getitem__(self, idx: int) -> np.ndarray:
        wav, sr = load_audio(self.filepaths[idx])
        x = to_mono(wav)
        if sr != self.sample_rate:
            x = resample(x, sr, self.sample_rate)
        if x.shape[-1] > self.audio_len:
            x = x[: self.audio_len]
        elif x.shape[-1] < self.audio_len:
            x = np.pad(x, (0, self.audio_len - x.shape[-1]))
        return np.asarray(x, dtype=np.float32)


class SyntheticClips:
    """Deterministic synthetic speech-like clips (fixture data for tests and
    smoke training when no corpus is mounted); clip idx is the same array as
    the JAX package's."""

    def __init__(self, n: int = 256, audio_len: int = AUDIO_LEN, seed: int = 0):
        self.n = n
        self.audio_len = audio_len
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        t = np.arange(self.audio_len) / SAMPLE_RATE
        f0 = 120.0 + 200.0 * rng.random()
        x = (
            0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.15 * np.sin(2 * np.pi * 2.3 * f0 * t + rng.random())
            + 0.05 * np.sin(2 * np.pi * 5.1 * f0 * t)
        ) * (0.6 + 0.4 * np.sin(2 * np.pi * (2.0 + 3.0 * rng.random()) * t))
        x = x + 0.02 * rng.standard_normal(self.audio_len)
        return x.astype(np.float32)


def split_indices(
    n: int, fractions: Sequence[float] = (0.8, 0.1, 0.1), seed: int = 42
) -> Tuple[np.ndarray, ...]:
    """Deterministic random split (the reference's 80/10/10 random_split)."""
    idx = np.random.default_rng(seed).permutation(n)
    out, start = [], 0
    for frac in fractions[:-1]:
        k = int(round(frac * n))
        out.append(idx[start : start + k])
        start += k
    out.append(idx[start:])
    return tuple(out)


class BatchLoader:
    """Threaded prefetching loader: a worker pool decodes clips and keeps
    up to `prefetch` batches ahead of the consumer.  An undecodable clip
    becomes silence and is counted (n_errors), so one bad file does not end
    an epoch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        indices: Optional[np.ndarray] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 4,
        native: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch = 0
        self.n_errors = 0
        self.native_batches = 0  # batches the native decoder produced
        self._native = None
        if native and hasattr(dataset, "filepaths"):
            from awm_tpu_torch.data import native as native_mod

            self._native = native_mod if native_mod.available() else None

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        if not self.shuffle:
            return self.indices
        return np.random.default_rng(self.seed + self._epoch).permutation(self.indices)

    def _item(self, i: int) -> np.ndarray:
        try:
            return self.dataset[int(i)]
        except Exception as e:  # skip-and-count, as the JAX loader does
            self.n_errors += 1
            if self.n_errors <= 5:
                warnings.warn(f"skipping undecodable clip idx {i}: {e}")
            return np.zeros(self.dataset.audio_len, dtype=np.float32)

    def __iter__(self) -> Iterator[np.ndarray]:
        order = self._epoch_order()
        self._epoch += 1
        batches = [order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(len(self))]

        def load_batch(batch_idx: np.ndarray) -> np.ndarray:
            if self._native is None:
                return np.stack([self._item(i) for i in batch_idx])
            out, ok = self._native.load_clips(
                [self.dataset.filepaths[int(i)] for i in batch_idx],
                clip_len=self.dataset.audio_len, target_sr=self.dataset.sample_rate,
                n_threads=self.num_workers)
            for j in np.nonzero(~ok)[0]:  # what the native decoder rejects, in Python
                out[j] = self._item(batch_idx[j])
            self.native_batches += 1
            return out

        def gen():
            with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                futures: List[cf.Future] = []
                it = iter(batches)
                for b in it:
                    futures.append(pool.submit(load_batch, b))
                    if len(futures) >= self.prefetch:
                        break
                for b in it:
                    done = futures.pop(0)
                    futures.append(pool.submit(load_batch, b))
                    yield done.result()
                for fut in futures:
                    yield fut.result()

        return gen()


class ConcatClips:
    """Clip datasets laid end to end: the speech + music training mix
    (--music-frac).  split_indices' shuffled split then spreads both sources
    over train, val and test."""

    def __init__(self, *datasets):
        if not datasets:
            raise ValueError("ConcatClips needs at least one dataset")
        self.datasets = datasets
        self.audio_len = datasets[0].audio_len
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> np.ndarray:
        k = int(np.searchsorted(self._offsets, idx, "right")) - 1
        return self.datasets[k][int(idx - self._offsets[k])]


class SyntheticMusicClips:
    """Deterministic synthetic music-like clips: a major triad with decaying
    harmonics on an equal-tempered root, percussive noise bursts on a beat
    grid, peak-normalised to 0.315; out of domain for the speech-like clips.
    Clip idx is the same array as the JAX package's."""

    def __init__(self, n: int = 256, audio_len: int = AUDIO_LEN, seed: int = 0):
        self.n = n
        self.audio_len = audio_len
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 2_000_003 + idx)
        t = np.arange(self.audio_len) / SAMPLE_RATE
        root = 110.0 * 2.0 ** (rng.integers(0, 25) / 12.0)  # A2..A4 chromatic
        x = np.zeros_like(t)
        for ratio in (1.0, 2 ** (4 / 12), 2 ** (7 / 12)):  # major triad
            f = root * ratio
            decay = np.exp(-t / (0.4 + 0.8 * rng.random()))
            for harm, amp in ((1, 0.2), (2, 0.08), (3, 0.04)):
                x += amp * decay * np.sin(2 * np.pi * f * harm * t + rng.random())
        beat = int(SAMPLE_RATE / (1.8 + 1.4 * rng.random()))
        for start in range(0, self.audio_len, beat):
            dur = min(800, self.audio_len - start)
            burst = rng.standard_normal(dur) * np.exp(-np.arange(dur) / 150.0)
            x[start : start + dur] += 0.15 * burst
        x = x + 0.005 * rng.standard_normal(self.audio_len)
        return (0.9 * x / max(np.abs(x).max(), 1e-6) * 0.35).astype(np.float32)

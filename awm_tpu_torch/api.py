"""Public embed/detect API (counterpart of awm_tpu/api.py).

Same signatures and result dicts as the JAX package: an N-second waveform
becomes (n_chunks, chunk_len) rows run in one device call per power-of-two
bucket of at most 512 chunks, and detection is reduced on the device, so
only per-sample probabilities and per-chunk summaries reach the host.

Precision policy (api.py:80-93 of the JAX package): compute_dtype=bf16, the
default, casts every fp32 variable, BN statistics and LSTM weights included,
to bf16 and feeds bf16 chunks; the LSTM keeps its fp32 accumulation and
state, and every reduction runs in fp32.  compute_dtype=torch.float32 is
the strict path: true fp32, with cuDNN and matmul TF32 off while it runs.
"""

from __future__ import annotations

import contextlib
import copy
import os
from math import comb
from typing import Dict, Optional

import numpy as np
import torch

from awm_tpu_torch.checkpoint import SHAPECAP_ARCH, SHAPECAP_NPZ, load_models
from awm_tpu_torch.config import AUDIO_LEN, SAMPLE_RATE
from awm_tpu_torch.dsp import lowpass_biquad
from awm_tpu_torch.ecc import PAYLOAD_BITS, ecc_decode, ecc_encode
from awm_tpu_torch.models import set_compute_dtype
from awm_tpu_torch.shaping import shape_delta
from awm_tpu_torch.utils.audio_io import load_mono_16k, save_wav
from awm_tpu_torch.utils.precision import no_tf32

_MAX_BUCKET = 512  # chunks per device call; longer files loop over megabatches


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, _MAX_BUCKET)


def _to_host(out, take: int):
    """Tensor / tuple / dict of tensors -> numpy, padding rows sliced off."""
    if isinstance(out, dict):
        return {k: _to_host(v, take) for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(_to_host(v, take) for v in out)
    return out[:take].cpu().numpy()


def _concat(outs):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple):
        return tuple(_concat([o[i] for o in outs]) for i in range(len(first)))
    return np.concatenate(outs)


class InferenceSession:
    """Generator and detector on one device, in the session's precision.

    gen / det are fp32 modules (awm_tpu_torch.models); the session keeps its
    own copies, cast to compute_dtype and moved to device, in eval mode.
    """

    def __init__(
        self,
        gen: torch.nn.Module,
        det: torch.nn.Module,
        *,
        message_bits: int = 16,
        sample_rate: int = SAMPLE_RATE,
        chunk_len: int = AUDIO_LEN,
        compute_dtype: torch.dtype = torch.bfloat16,
        shaping=None,
        device="cuda",
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.gen = copy.deepcopy(gen).to(device=self.device, dtype=compute_dtype).eval()
        self.det = copy.deepcopy(det).to(device=self.device, dtype=compute_dtype).eval()
        for net in (self.gen, self.det):  # the session's dtype, not a trainer's
            set_compute_dtype(net, None)
        self.message_bits = message_bits
        self.sample_rate = sample_rate
        self.chunk_len = chunk_len
        # main16 shaping at embed time (ref: py/main16.py:384-386): a
        # shaping-trained checkpoint shapes its served deltas, which makes
        # the limit_rms cap a hard guarantee on embed_chunks' output.
        self.shaping = shaping if (shaping is not None and shaping.enabled) else None

    @classmethod
    def from_npz(
        cls,
        params_npz: str = SHAPECAP_NPZ,
        arch_json: str = SHAPECAP_ARCH,
        *,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        chunk_len: int = AUDIO_LEN,
    ) -> "InferenceSession":
        """Session over a flattened-.npz checkpoint and its arch sidecar,
        adopting the recorded shaping chain (the shapecap assets by
        default)."""
        gen, det, model_cfg, shaping = load_models(params_npz, arch_json)
        return cls(gen, det, message_bits=model_cfg.message_bits, chunk_len=chunk_len,
                   compute_dtype=compute_dtype, shaping=shaping, device=device)

    @classmethod
    def from_state(cls, cfg, state, *, compute_dtype: torch.dtype = torch.bfloat16,
                   device=None) -> "InferenceSession":
        """Session over a TrainState's networks (copies), adopting the
        config's shaping chain when it is enabled (main16 eval parity).
        Runs on the networks' device unless another is given."""
        device = device or next(state.gen.parameters()).device
        return cls(state.gen, state.det, message_bits=cfg.message_bits,
                   sample_rate=cfg.sample_rate, chunk_len=cfg.audio_len,
                   compute_dtype=compute_dtype, shaping=cfg.shaping, device=device)

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        *,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        chunk_len: int = AUDIO_LEN,
    ) -> "InferenceSession":
        """Session over a checkpoint directory of the port (trainer.fit's
        ckpt_best / ckpt_latest): the architecture and shaping chain its
        awm_arch.json records, its weights restored strictly."""
        from awm_tpu_torch.checkpoint import configs_from_arch, read_arch, restore_params
        from awm_tpu_torch.models import build_models

        model_cfg, shaping = configs_from_arch(read_arch(path))
        gen, det = build_models(model_cfg)
        restore_params(path, gen, det)
        return cls(gen, det, message_bits=model_cfg.message_bits, chunk_len=chunk_len,
                   compute_dtype=compute_dtype, shaping=shaping, device=device)

    # -- device functions ----------------------------------------------------

    def _embed(self, chunks, msgs):
        delta = self.gen(chunks.to(self.compute_dtype), msgs).float()
        if self.shaping is not None:
            delta = shape_delta(delta, self.shaping, self.sample_rate)
        return delta

    def _detect(self, chunks):
        return self.det(chunks.to(self.compute_dtype)).float()

    def _detect_reduced(self, chunks, lengths):
        """Detector + on-device reductions: per-sample probs, per-chunk
        time-mean bit logits and vote fractions over the valid samples, and
        the mean detection probability."""
        logits = self.det(chunks.to(self.compute_dtype)).float()  # (N, T, 1+bits)
        probs = torch.sigmoid(logits[:, :, 0])
        t = chunks.shape[1]
        mask = (torch.arange(t, device=chunks.device)[None, :] < lengths[:, None]).float()
        denom = torch.clamp(lengths.float(), min=1.0)[:, None]
        bit_logits = logits[:, :, 1:]
        msg_logit_mean = (bit_logits * mask[:, :, None]).sum(dim=1) / denom
        votes = (bit_logits > 0).float()
        msg_vote_frac = (votes * mask[:, :, None]).sum(dim=1) / denom
        mean_prob = (probs * mask).sum(dim=1) / denom[:, 0]
        return probs, msg_logit_mean, msg_vote_frac, mean_prob

    def _embed_detect(self, chunks, msgs, lengths):
        """Fused embed+detect round trip on the device.  Like the JAX
        package's _embed_detect (api.py:133-151) it applies NO shaping:
        its deltas are the generator's own, unlike embed_chunks'."""
        delta = self.gen(chunks.to(self.compute_dtype), msgs).float()
        both = torch.cat([chunks + delta, chunks], dim=0)
        _, mlm, mvf, mp = self._detect_reduced(both, torch.cat([lengths, lengths]))
        n = chunks.shape[0]
        return {
            "wm_prob": mp[:n],
            "clean_prob": mp[n:],
            "msg_logit_mean": mlm[:n],
            "msg_vote_frac": mvf[:n],
            "delta_rms": torch.sqrt(delta.square().mean(dim=1)),
        }

    # -- batched chunk calls (bucket-padded) ---------------------------------

    def embed_chunks(self, chunks: np.ndarray, messages: np.ndarray) -> np.ndarray:
        """(N, L) float32 + (N,) int -> (N, L) delta (shaped when the
        session has a shaping chain)."""
        return self._run_bucketed(self._embed, [chunks, messages.astype(np.int64)])

    def detect_chunks(self, chunks: np.ndarray) -> np.ndarray:
        """(N, L) -> (N, L, 1 + bits) raw logits.  Prefer detect_summary for
        sweeps: raw logits are a 17 times larger host transfer."""
        return self._run_bucketed(self._detect, [chunks])

    def detect_summary(self, chunks, lengths: Optional[np.ndarray] = None):
        """(N, L) [+ per-chunk valid lengths] -> (probs (N, L),
        msg_logit_mean (N, bits), msg_vote_frac (N, bits), mean_prob (N,)).
        chunks may be a tensor already on the session's device (eval's
        attacked audio), which then makes no round trip through the host."""
        if lengths is None:
            lengths = np.full(chunks.shape[0], chunks.shape[1], np.int64)
        return self._run_bucketed(
            self._detect_reduced, [chunks, lengths.astype(np.int64)], pad_values=[0.0, 1]
        )

    def embed_detect(self, chunks: np.ndarray, messages: np.ndarray,
                     lengths: Optional[np.ndarray] = None):
        """Fused embed+detect sweep, summaries only (dict of per-chunk
        arrays): the path for corpus eval and benchmarking."""
        if lengths is None:
            lengths = np.full(chunks.shape[0], chunks.shape[1], np.int64)
        return self._run_bucketed(
            self._embed_detect,
            [chunks, messages.astype(np.int64), lengths.astype(np.int64)],
            pad_values=[0.0, 0, 1],
        )

    def _run_bucketed(self, fn, arrays, pad_values=None):
        """Run fn over row-aligned arrays (numpy, or torch tensors on any
        device) in power-of-two buckets, slicing the padding back off.
        Handles tensor / tuple / dict outputs."""
        n = arrays[0].shape[0]
        if pad_values is None:
            pad_values = [0] * len(arrays)
        precision = no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext()
        outs = []
        i = 0
        with torch.inference_mode(), precision:
            while i < n:
                take = min(_MAX_BUCKET, n - i)
                b = _bucket(take)
                ins = []
                for arr, pv in zip(arrays, pad_values):
                    a = arr[i : i + take]
                    if not torch.is_tensor(a):
                        a = torch.from_numpy(np.ascontiguousarray(a))
                    if take < b:
                        pad = torch.full((b - take,) + a.shape[1:], pv, dtype=a.dtype, device=a.device)
                        a = torch.cat([a, pad])
                    ins.append(a.to(self.device))
                outs.append(_to_host(fn(*ins), take))
                i += take
        return outs[0] if len(outs) == 1 else _concat(outs)


def _to_chunks(waveform: np.ndarray, chunk_len: int = AUDIO_LEN):
    """(T,) -> ((n_chunks, chunk_len), total_samples), tail zero-padded
    (ref: py/main14.py:753-757)."""
    total = waveform.shape[-1]
    n_chunks = max(1, -(-total // chunk_len))
    padded = np.zeros(n_chunks * chunk_len, dtype=np.float32)
    padded[:total] = waveform
    return padded.reshape(n_chunks, chunk_len), total


def watermark_array(
    waveform: np.ndarray,
    session: InferenceSession,
    *,
    message=None,
    seed: Optional[int] = None,
    ecc: bool = False,
) -> Dict:
    """Embed into a raw (T,) waveform.  A fresh random message per chunk
    (ref: py/main14.py:743) unless a fixed message (int) or a per-chunk
    message array is given.  ecc=True embeds the SECDED codewords of 11-bit
    payloads; the result then carries "payloads"."""
    chunks, total = _to_chunks(waveform, session.chunk_len)
    n = chunks.shape[0]
    rng = np.random.default_rng(seed)
    payloads = None
    if ecc:
        if message is None:
            payloads = rng.integers(0, 2**PAYLOAD_BITS, size=n, dtype=np.int64)
        elif np.ndim(message) > 0:
            payloads = np.asarray(message, dtype=np.int64)
        else:
            payloads = np.full(n, int(message), dtype=np.int64)
        message = np.asarray([ecc_encode(int(p)) for p in payloads], np.int64)
    if message is None:
        messages = rng.integers(0, 2**session.message_bits, size=n, dtype=np.int64)
    elif np.ndim(message) > 0:
        messages = np.asarray(message, dtype=np.int64)
        if messages.shape != (n,):
            raise ValueError(
                f"per-chunk messages must have shape ({n},) for this waveform, "
                f"got {messages.shape}"
            )
    else:
        messages = np.full(n, int(message), dtype=np.int64)
    deltas = session.embed_chunks(chunks, messages)
    delta = deltas.reshape(-1)[:total]
    out = {
        "watermarked_waveform": waveform[:total] + delta,
        "delta_waveform": delta,
        "original_waveform": waveform[:total],
        "messages": messages,
    }
    if payloads is not None:
        out["payloads"] = payloads
    return out


def detect_array(
    waveform: np.ndarray,
    session: InferenceSession,
    detection_threshold: float = 0.5,
    *,
    ecc: bool = False,
) -> Dict:
    """Detect on a raw (T,) waveform: per-sample probs over the valid
    samples, per-chunk time-mean bit logits averaged over chunks, bits =
    mean logit > 0 (ref: py/main14.py:875-929)."""
    chunks, total = _to_chunks(waveform, session.chunk_len)
    n, chunk_len = chunks.shape
    lengths = np.full(n, chunk_len, np.int64)
    if total % chunk_len:
        lengths[-1] = total % chunk_len  # the tail chunk's padding is masked
    probs, msg_logit_mean, _, _ = session.detect_summary(chunks, lengths)
    temporal_probs = probs.reshape(-1)[:total]
    mean_prob = float(temporal_probs.mean())
    msg_logits_mean = msg_logit_mean.mean(axis=0)
    is_wm = mean_prob > detection_threshold
    out = {
        "mean_probability": mean_prob,
        "is_watermarked": bool(is_wm),
        "temporal_probs": temporal_probs,
        "decision": "WATERMARKED" if is_wm else "NOT WATERMARKED",
        "predicted_message": (msg_logits_mean > 0).astype(int).tolist(),
        "message_confidence": (1.0 / (1.0 + np.exp(-msg_logits_mean))).tolist(),
    }
    if ecc:
        payload, corrected, ok = ecc_decode(out["predicted_message"])
        out["ecc"] = {"payload": payload, "corrected_bits": corrected, "ok": bool(ok)}
    return out


def _binom_sf(k: int, n: int) -> float:
    """Exact P(X >= k) for X ~ Binomial(n, 1/2): the null distribution of
    per-bit agreement on unwatermarked audio."""
    return sum(comb(n, j) for j in range(k, n + 1)) / float(2**n)


def verify_array(
    waveform: np.ndarray,
    session: InferenceSession,
    expected_message: int,
    detection_threshold: float = 0.5,
    alpha: float = 0.01,
    *,
    ecc: bool = False,
) -> Dict:
    """Authenticate a raw (T,) waveform against an EXPECTED message: per-bit
    agreement k/n, its exact binomial p-value under the null, the
    expected-sign logit margin, and AUTHENTIC when the watermark is detected
    AND the agreement is significant at alpha."""
    payload = None
    if ecc:
        payload = int(expected_message)
        expected_message = ecc_encode(payload)
    det = detect_array(waveform, session, detection_threshold)
    bits = session.message_bits
    expected = (int(expected_message) >> np.arange(bits)) & 1  # LSB first
    decoded = np.asarray(det["predicted_message"])
    agree = int((decoded == expected).sum())
    p_value = _binom_sf(agree, bits)
    conf = np.asarray(det["message_confidence"])
    logits = np.log(conf / (1.0 - conf + 1e-12) + 1e-12)
    margin = float((logits * np.where(expected == 1, 1.0, -1.0)).mean())
    authentic = bool(det["is_watermarked"] and p_value <= alpha)
    out_extra = {} if payload is None else {"expected_payload": payload}
    return {
        **out_extra,
        "mean_probability": det["mean_probability"],
        "is_watermarked": det["is_watermarked"],
        "expected_message": int(expected_message),
        "decoded_message": int((decoded.astype(np.int64) << np.arange(bits)).sum()),
        "bit_agreement": agree,
        "bit_agreement_frac": agree / bits,
        "p_value": p_value,
        "match_margin": margin,
        "alpha": alpha,
        "is_authentic": authentic,
        "decision": "AUTHENTIC" if authentic else "NOT AUTHENTIC",
    }


def verify_watermark(
    input_file: str,
    session: InferenceSession,
    expected_message: int,
    detection_threshold: float = 0.5,
    alpha: float = 0.01,
    *,
    ecc: bool = False,
) -> Dict:
    """File-level verify_array."""
    waveform = load_mono_16k(input_file, session.sample_rate)
    return verify_array(waveform, session, expected_message, detection_threshold, alpha, ecc=ecc)


def _si_snr_np(s: np.ndarray, s_hat: np.ndarray, eps: float = 1e-8) -> float:
    """Reference compute_si_snr on host arrays (ref: py/main14.py:650-659)."""
    s = s - s.mean()
    s_hat = s_hat - s_hat.mean()
    alpha = float((s * s_hat).sum() / ((s * s).sum() + eps))
    s_target = alpha * s
    e_noise = s_hat - s_target
    return float(10.0 * np.log10((s_target**2).sum() / ((e_noise**2).sum() + eps)))


def generate_watermarked_audio(
    input_file: str,
    session: InferenceSession,
    output_file: Optional[str] = None,
    *,
    message: Optional[int] = None,
    seed: Optional[int] = None,
    ecc: bool = False,
) -> Dict:
    """File-level embed, reference-compatible result dict
    (ref: py/main14.py:719-808)."""
    waveform = load_mono_16k(input_file, session.sample_rate)
    res = watermark_array(waveform, session, message=message, seed=seed, ecc=ecc)
    delta = res["delta_waveform"]
    wm = res["watermarked_waveform"]
    metrics = {
        "watermark_rms": float(np.sqrt((delta**2).mean())),
        "si_snr_db": _si_snr_np(waveform, wm),
        "power_ratio_db": float(10.0 * np.log10((waveform**2).mean() / (delta**2).mean())),
    }
    if output_file:
        save_wav(output_file, wm, session.sample_rate)
    return {
        "watermarked_waveform": wm,
        "delta_waveform": delta,
        "original_waveform": waveform,
        "messages": res["messages"],
        **({"payloads": res["payloads"]} if "payloads" in res else {}),
        "metrics": metrics,
    }


def detect_watermark(
    input_file: str,
    session: InferenceSession,
    detection_threshold: float = 0.5,
    visualize: bool = False,
    *,
    ecc: bool = False,
) -> Dict:
    """File-level detect (ref: py/main14.py:856-949).  visualize=True writes
    the reference's temporal-probability plot next to the input."""
    waveform = load_mono_16k(input_file, session.sample_rate)
    result = detect_array(waveform, session, detection_threshold, ecc=ecc)
    if visualize:
        _plot_detection(input_file, result, detection_threshold, session.sample_rate)
    return result


def _plot_detection(input_file, result, threshold, sample_rate):
    """Temporal-probability figure in the reference's output format (labels,
    colours and layout kept, so consumers of the PNG see the same artifact;
    ref: py/main14.py:931-947)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    probs = result["temporal_probs"]
    time_axis = np.linspace(0, len(probs) / sample_rate, len(probs))
    plt.figure(figsize=(12, 6))
    plt.plot(time_axis, probs, label="Detection Probability", color="blue", alpha=0.7)
    plt.axhline(y=threshold, color="red", linestyle="--", label=f"Threshold ({threshold})")
    plt.axhline(
        y=result["mean_probability"],
        color="green",
        linestyle="-.",
        label=f"Mean Probability ({result['mean_probability']:.4f})",
    )
    plt.xlabel("Time (seconds)")
    plt.ylabel("Watermark Detection Probability")
    plt.title(
        f"Watermark Detection Results for {os.path.basename(input_file)}\n"
        f"Decision: {result['decision']}"
    )
    plt.ylim(-0.05, 1.05)
    plt.legend()
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(os.path.splitext(input_file)[0] + "_detection.png")
    plt.close()


def run_inference_on_file(input_file: str, session: InferenceSession):
    """Embed + detect + metrics on one file; returns (watermarked,
    detection_prob, watermark_rms, si_snr_db) (ref: py/main14.py:662-686)."""
    res = generate_watermarked_audio(input_file, session)
    wm = res["watermarked_waveform"]
    det = detect_array(wm, session)
    return wm, det["mean_probability"], res["metrics"]["watermark_rms"], res["metrics"]["si_snr_db"]


def save_audio_quality(waveform: np.ndarray, output_path: str, sample_rate: int = SAMPLE_RATE,
                       *, device="cuda") -> None:
    """main15's quality save path: 7 kHz lowpass -> clamp -> int16 PCM WAV
    (ref: py/main15.py:850-867).  The biquad runs on `device` (its short-FIR
    form), the file write on the host."""
    x = torch.from_numpy(np.asarray(waveform, np.float32)).to(device)
    save_wav(output_path, lowpass_biquad(x, sample_rate, 7000.0).cpu().numpy(), sample_rate)

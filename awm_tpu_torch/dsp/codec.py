"""G.711 telephony-codec channel simulation: mu-law and A-law round trips
(counterpart of awm_tpu/dsp/codec.py:21-98).

Pure int32 tensor arithmetic, static shapes, bit-exact against CPython's
``audioop`` (the classic Sun G.711 code): tests/test_torch_dsp.py holds both
laws byte for byte over the whole int16 range.  Like quantize_int16 these are
channel attacks with zero gradient.
"""

from __future__ import annotations

import torch

_BIAS = 0x84  # G.711 mu-law bias (132)
_MU_CLIP = 8159
_SEG_UEND = (0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF)
_SEG_AEND = (0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF)


def _seg_number(mag: torch.Tensor, table) -> torch.Tensor:
    """Index of the first table entry >= mag (8 if none): G.711's search."""
    seg = torch.zeros_like(mag)
    for uend in table:
        seg = seg + (mag > uend).to(mag.dtype)
    return seg


def mulaw_encode(pcm16: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> 8-bit mu-law code (audioop.lin2ulaw, width 2, exact)."""
    p = torch.bitwise_right_shift(pcm16.to(torch.int32), 2)  # 14-bit, arithmetic
    neg = p < 0
    mask = torch.where(neg, 0x7F, 0xFF)
    mag = torch.clamp(torch.where(neg, -p, p), max=_MU_CLIP) + (_BIAS >> 2)
    seg = _seg_number(mag, _SEG_UEND)
    s = torch.clamp(seg, max=7)
    uval = torch.bitwise_left_shift(s, 4) | (torch.bitwise_right_shift(mag, s + 1) & 0xF)
    code = torch.where(seg >= 8, 0x7F ^ mask, uval ^ mask)
    return code.to(torch.uint8)


def mulaw_decode(code: torch.Tensor) -> torch.Tensor:
    """8-bit mu-law code -> int16 PCM (audioop.ulaw2lin, width 2, exact)."""
    u = (~code.to(torch.int32)) & 0xFF
    t = ((u & 0xF) << 3) + _BIAS
    t = torch.bitwise_left_shift(t, torch.bitwise_right_shift(u & 0x70, 4))
    out = torch.where((u & 0x80) != 0, _BIAS - t, t - _BIAS)
    return out.to(torch.int16)


def alaw_encode(pcm16: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> 8-bit A-law code (audioop.lin2alaw, width 2, exact)."""
    p = torch.bitwise_right_shift(pcm16.to(torch.int32), 3)  # 13-bit, arithmetic
    neg = p < 0
    mask = torch.where(neg, 0x55, 0xD5)
    mag = torch.where(neg, -p - 1, p)
    seg = _seg_number(mag, _SEG_AEND)
    s = torch.clamp(seg, max=7)
    shift = torch.where(s < 2, 1, s)
    aval = torch.bitwise_left_shift(s, 4) | (torch.bitwise_right_shift(mag, shift) & 0xF)
    code = torch.where(seg >= 8, 0x7F ^ mask, aval ^ mask)
    return code.to(torch.uint8)


def alaw_decode(code: torch.Tensor) -> torch.Tensor:
    """8-bit A-law code -> int16 PCM (audioop.alaw2lin, width 2, exact)."""
    a = (code.to(torch.int32) ^ 0x55) & 0xFF
    t = (a & 0xF) << 4
    seg = torch.bitwise_right_shift(a & 0x70, 4)
    t = torch.where(seg == 0, t + 8,
                    torch.bitwise_left_shift(t + 0x108, torch.clamp(seg - 1, min=0)))
    out = torch.where((a & 0x80) != 0, t, -t)
    return out.to(torch.int16)


def _roundtrip(x: torch.Tensor, enc, dec) -> torch.Tensor:
    pcm = torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(torch.int16)
    y = dec(enc(pcm)).to(torch.float32)
    return (y / y.new_full((), 32767.0)).to(x.dtype)  # a true quotient on the card too


def mulaw_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Float audio in (-1, 1) through an 8-bit G.711 mu-law channel."""
    return _roundtrip(x, mulaw_encode, mulaw_decode)


def alaw_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Float audio in (-1, 1) through an 8-bit G.711 A-law channel."""
    return _roundtrip(x, alaw_encode, alaw_decode)

"""Stride-3 hex tokenization on the device, for stride-regular serial logs.

Every shipped log is a short junk prefix (the 2-byte UTF-8 guillemet and a
separator) followed by a regular ``"XX "`` stride-3 token stream.  On the
device that stream tokenizes as a ``[M / 3, 3]`` view of the text and
elementwise uint8 arithmetic: no gather, no compaction, so the raw text is
the only host-to-device copy of the text path
(``pipeline/device.run_session_from_text``).

Correctness is never assumed.  ``tokenize_stride3`` also returns a
``regular`` flag, True iff every real token triple is (hex, hex,
whitespace).  Together with the host-side precondition of
``stride3_offset`` (no valid token before the body start, and the body
starts a token), the flag being True proves that the output equals the
reference tokenizer's (the argument is in ``tokenize_stride3``'s
docstring).  Callers fall back to the host tokenizer when the flag is
False or the offset scan fails: irregular streams are slower, never wrong.

The port of ``slam_process_tpu/ops/tokenize.py``.  The JAX package's
``[M / 384, 384]`` bf16 matmul deinterleave is a TPU lane-tiling layout and
is not copied; this is the plain elementwise form of its small-shape
branch, the same semantics.  It is plain PyTorch on the tensor's device (no
hand kernel: the JAX package computes it with XLA outside any Pallas
kernel).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np
import torch

# Non-whitespace runs; token validity per the reference regex: two hex
# digits, optionally 0x / 0X-prefixed.
_NONWS_RUN = re.compile(rb"[^ \t\r\n\x0b\x0c\x1c\x1d\x1e\x1f]+")
_VALID_TOKEN = re.compile(rb"^(?:0[xX])?[0-9a-fA-F]{2}$")

#: Padding byte of the text tensor: whitespace, so a final 2-hex token with
#: no trailing separator in the file still passes the (hex, hex, ws) check.
TEXT_PAD = 0x20


def stride3_offset(data: bytes, max_scan: int = 4096) -> Optional[int]:
    """The stride-3 body start: byte offset of the first valid token.

    Establishes the host-side precondition of the device tokenizer:
    ``data[:p]`` holds no valid token and ``p`` starts a non-whitespace
    run.  Only the leading ``max_scan`` bytes are scanned.  Returns None
    when no valid token starts in the scan window (junk-only heads, empty
    streams, a run the window cuts): callers use the host tokenizer then.
    """
    head = data[:max_scan]
    limit = len(head)
    for m in _NONWS_RUN.finditer(head):
        # A run cut by the scan window may continue past it; its in-window
        # prefix is not the real token: stop and take the fallback.
        if m.end() == limit and len(data) > limit:
            return None
        if _VALID_TOKEN.match(m.group()):
            return m.start()
    return None


def prepare_text(data: bytes, p: int, target: int) -> Tuple[np.ndarray, int]:
    """Host prep: the body from offset ``p``, padded with whitespace to
    ``target`` bytes (a multiple of 3, >= len(data) - p).  Returns
    (text [target] uint8, n_text)."""
    body = np.frombuffer(data, dtype=np.uint8)[p:]
    if target % 3 != 0 or target < len(body):
        raise ValueError(f"bad text bucket {target} for body of {len(body)}")
    out = np.full(target, TEXT_PAD, dtype=np.uint8)
    out[: len(body)] = body
    return out, len(body)


def text_bucket(n_body: int, quantum: int = 3 << 18) -> int:
    """A body length rounded up to a multiple-of-3 bucket: 3x the byte
    path's 256 KiB bucket (``pipeline/device.bucket_size``), so the padded
    token count equals the byte path's padded length."""
    if quantum % 3 != 0:
        raise ValueError("text bucket quantum must be a multiple of 3")
    return max(((n_body + quantum - 1) // quantum) * quantum, quantum)


def _ishex(c: torch.Tensor) -> torch.Tensor:
    # uint8 wraparound makes each range test one compare: '0'..'9' -> c - 48
    # in [0, 10); 'a'..'f' / 'A'..'F' -> (c | 0x20) - 97 in [0, 6).
    return ((c - ord("0")) < 10) | (((c | 0x20) - ord("a")) < 6)


def _hexval(c: torch.Tensor) -> torch.Tensor:
    # '0'..'9': the low nibble; letters: the low nibble + 9 ('A' = 0x41 -> 10).
    return (c & 0xF) + 9 * (c >> 6)


def _is_ws(c: torch.Tensor) -> torch.Tensor:
    return (c == 0x20) | ((c >= 0x09) & (c <= 0x0D)) | ((c >= 0x1C) & (c <= 0x1F))


def tokenize_stride3(text: torch.Tensor, n_text) -> Tuple[torch.Tensor, torch.Tensor,
                                                             torch.Tensor]:
    """Stride-3 tokenizer on ``text``'s device: text bytes -> byte values
    and the proof flag (``tokenize_stride3_jax``).

    ``text`` is [M] uint8 with M % 3 == 0, padded with whitespace
    (``TEXT_PAD``); ``n_text`` is the real body length: an int, or a 0-d
    int32 tensor on ``text``'s device (what a CUDA graph of the text path
    reads, so that one graph serves every length: JAX's program takes
    ``jnp.int32(n_text)`` too).  Returns ``(b [M // 3] uint8, n_tok int32,
    regular bool)``, the last two 0-d tensors on the device; ``b[k]`` is
    token k's value, 0 (an inert, non-flag byte) from ``n_tok`` on.

    Equivalence with the reference tokenizer (tests/test_torch_tokenize.py),
    with rem = n_text % 3:

    * rem == 0 or 2: every real body byte lies in a checked triple (the
      rem == 2 tail's missing separator is the whitespace padding).
      ``regular`` True means the body is exactly ``(hex hex ws) * n_tok``,
      so whitespace splitting yields exactly the n_tok two-hex-digit
      tokens: the reference accepts each and nothing else.
    * rem == 1: one real byte (the last) is unchecked; the byte before it
      was verified whitespace, so it is a lone 1-character token, which the
      reference regex rejects.  The outputs agree with it skipped.
    """
    if text.dtype != torch.uint8 or text.dim() != 1 or text.shape[0] % 3:
        raise ValueError(f"text must be [M] uint8 with M % 3 == 0, got "
                         f"{text.dtype}{list(text.shape)}")
    if isinstance(n_text, torch.Tensor):
        if n_text.dim() != 0 or n_text.dtype != torch.int32 or n_text.device != text.device:
            raise ValueError(f"n_text must be a 0-d int32 tensor on {text.device}, got "
                             f"{n_text.dtype}{list(n_text.shape)} on {n_text.device}")
    else:
        n_text = torch.tensor(int(n_text), dtype=torch.int32, device=text.device)
    t = text.view(-1, 3)
    c0, c1, c2 = t[:, 0], t[:, 1], t[:, 2]
    n_tok = torch.div(n_text + 1, 3, rounding_mode="floor")
    real = torch.arange(t.shape[0], dtype=torch.int32, device=text.device) < n_tok
    tok_ok = _ishex(c0) & _ishex(c1) & _is_ws(c2)
    regular = (tok_ok | ~real).all()
    b = (_hexval(c0) << 4) | _hexval(c1)
    return torch.where(real & tok_ok, b, 0), n_tok, regular


def tokenize_device(data: bytes, device=None) -> Tuple[np.ndarray, bool]:
    """Tokenize a raw log on ``device`` (None: CUDA): (bytes uint8,
    used_device).  The host numpy tokenizer runs instead where the stream
    is not stride-3 regular (one host read of the flag decides)."""
    from slam_process_tpu_torch.io.hexlog import tokenize_hex
    from slam_process_tpu_torch.pipeline.device import resolve_device

    dev = resolve_device(device)
    p = stride3_offset(data)
    if p is None:
        return tokenize_hex(data), False
    text, n_text = prepare_text(data, p, text_bucket(len(data) - p))
    b, n_tok, regular = tokenize_stride3(torch.from_numpy(text).to(dev), n_text)
    if not bool(regular):
        return tokenize_hex(data), False
    return b[: int(n_tok)].cpu().numpy(), True

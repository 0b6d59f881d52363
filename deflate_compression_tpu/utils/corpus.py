"""Seeded corpora for the tests, the benchmark and the chip smoke test.

Every generator is a pure function of (size, seed) and builds its bytes with
vectorized numpy, so hundreds of MiB take seconds. The shapes follow the
inputs the reference codec was exercised on:

  * text     — word-frequency text: a fixed vocabulary drawn with a Zipf law,
               English letter frequencies, punctuation and line breaks;
  * pixels   — 8-bit RGB scanlines of smooth gradients plus sensor noise;
  * random   — incompressible bytes (the stored-block path);
  * repeated — one random pattern tiled (deep, periodic LZ77 chains);
  * mixed    — BASELINE config 4's shape: text, then 64 KiB of random bytes,
               then a 64-byte pattern repeated 256 times, cycling.
"""
from __future__ import annotations

import numpy as np

# English letter frequencies (a..z), percent
_LETTER_P = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15,
                      0.77, 4.0, 2.4, 6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1,
                      2.8, 0.98, 2.4, 0.15, 2.0, 0.074])
_SEPS = [b" ", b" ", b" ", b" ", b" ", b" ", b" ", b" ", b" ", b" ",
         b", ", b". ", b".\n", b"\n", b"? ", b"! "]
_VOCAB = 6000
_WORDS_PER_CHUNK = 1 << 17


def _expand(buf: np.ndarray, off: np.ndarray, ln: np.ndarray,
            ids: np.ndarray) -> np.ndarray:
    """Concatenate pieces buf[off[i]:off[i]+ln[i]] for i in ids."""
    L = ln[ids]
    starts = np.cumsum(L) - L
    src = np.repeat(off[ids] - starts, L) + np.arange(int(L.sum()))
    return buf[src]


def text(size: int, seed: int = 0) -> bytes:
    """Word-frequency text of exactly `size` bytes."""
    rng = np.random.default_rng([seed, 1])
    lens = np.clip(rng.poisson(4.0, _VOCAB) + 1, 1, 16)
    letters = (rng.choice(26, int(lens.sum()), p=_LETTER_P / _LETTER_P.sum())
               + ord("a")).astype(np.uint8)
    sep_bytes = np.frombuffer(b"".join(_SEPS), np.uint8)
    buf = np.concatenate([letters, sep_bytes])
    ln = np.concatenate([lens, [len(s) for s in _SEPS]]).astype(np.int64)
    off = np.cumsum(ln) - ln
    # Zipf law over word ranks (exponent ~1, as in natural language)
    cdf = np.cumsum(1.0 / np.arange(1, _VOCAB + 1))
    cdf /= cdf[-1]
    parts, have = [], 0
    while have < size:
        words = np.searchsorted(cdf, rng.random(_WORDS_PER_CHUNK))
        seps = _VOCAB + rng.integers(0, len(_SEPS), _WORDS_PER_CHUNK)
        ids = np.stack([words, seps], axis=1).reshape(-1)
        piece = _expand(buf, off, ln, ids)
        parts.append(piece)
        have += piece.size
    return np.concatenate(parts)[:size].tobytes()


def pixels(size: int, seed: int = 0, width: int = 1024) -> bytes:
    """RGB scanlines (`width` pixels each) of smooth gradients plus noise."""
    rng = np.random.default_rng([seed, 2])
    n_px = (size + 2) // 3
    px = np.arange(n_px)
    x, y = px % width, px // width
    base = np.stack([0.11 * x + 40 * np.sin(y / 37.0),
                     0.07 * y + 30 * np.cos(x / 53.0),
                     0.05 * (x + y)], axis=1)
    noise = rng.normal(0.0, 2.0, base.shape)
    return (np.floor(base + noise).astype(np.int64) & 0xFF).astype(
        np.uint8).reshape(-1)[:size].tobytes()


def random(size: int, seed: int = 0) -> bytes:
    """Incompressible bytes."""
    return np.random.default_rng([seed, 3]).bytes(size)


def repeated(size: int, seed: int = 0, period: int = 64) -> bytes:
    """One random `period`-byte pattern tiled to `size` bytes."""
    pat = np.random.default_rng([seed, 4]).integers(0, 256, period,
                                                    dtype=np.uint8)
    return np.tile(pat, size // period + 1)[:size].tobytes()


def mixed(size: int, seed: int = 0, text_run: int = 57344) -> bytes:
    """BASELINE config 4's mixed text+binary shape: each cycle is `text_run`
    bytes of text, 64 KiB of random bytes and a 64-byte pattern repeated
    256 times."""
    cycle = text_run + 65536 + 64 * 256
    n = size // cycle + 1
    txt = np.frombuffer(text(n * text_run, seed), np.uint8).reshape(n, -1)
    rng = np.random.default_rng([seed, 5])
    rnd = rng.integers(0, 256, (n, 65536), dtype=np.uint8)
    pats = np.tile(rng.integers(0, 256, (n, 64), dtype=np.uint8), (1, 256))
    return np.concatenate([txt, rnd, pats], axis=1).reshape(-1)[:size].tobytes()

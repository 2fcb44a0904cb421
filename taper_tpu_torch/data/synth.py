"""Synthetic MNIST renderer: port of ``taper_tpu/data/synth.py``
(``synthesize_images_numpy``, ``synth.py:42-145``).

Renders classifiable 28x28 digits from labels alone, for machines with no
dataset: per-sample glyph scale, position, intensity and shear, two
distractor strokes, a 1-2-1 blur and uniform noise, from a per-sample
xorshift64* stream seeded by ``seed`` and the sample index.  Pure NumPy,
the same algorithm and draw order as the JAX package's, so both render
the same images (to float rounding).  The JAX package's threaded C++
renderer (``native/dataloader.cpp``) is not ported.
"""

from __future__ import annotations

import numpy as np

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_GOLD = np.uint64(0x9E3779B97F4A7C15)
_MULT = np.uint64(0x2545F4914F6CDD1D)

GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _xs_next(s: np.ndarray):
    """One xorshift64* step over a vector of states; returns (s, output)."""
    s = s ^ (s >> np.uint64(12))
    s = (s ^ (s << np.uint64(25))) & _M64
    s = s ^ (s >> np.uint64(27))
    return s, (s * _MULT) & _M64


def _uni(out: np.ndarray) -> np.ndarray:
    return (out >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


NOISE_AMP = 0.30
N_STROKES = 2


def synthesize_images_numpy(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    labels = np.asarray(labels, np.int64)
    n = len(labels)
    seeds = (np.uint64(seed) * np.uint64(1000003)
             + np.arange(n, dtype=np.uint64)) & _M64
    s = seeds ^ _GOLD
    s[s == np.uint64(0)] = _GOLD
    s, _ = _xs_next(s)                      # constructor warm-up
    s, raw = _xs_next(s)
    scale = 2 + (raw & np.uint64(1)).astype(np.int64)
    s, raw = _xs_next(s)
    gh, gw = 7 * scale, 5 * scale
    y0 = (_uni(raw) * (28 - gh + 1)).astype(np.int64)
    s, raw = _xs_next(s)
    # keep 2px of shear headroom on each side
    x0 = 2 + (_uni(raw) * (28 - gw - 4 + 1)).astype(np.int64)
    s, raw = _xs_next(s)
    intensity = (0.55 + 0.45 * _uni(raw)).astype(np.float32)
    s, raw = _xs_next(s)
    shear = _uni(raw) * 4.0 - 2.0           # total x drift over the glyph

    canvas = np.zeros((n, 28, 28), np.float32)
    glyph_arr = np.array(
        [[[c == "1" for c in row] for row in GLYPHS[d]] for d in range(10)],
        np.float32)  # [10, 7, 5]
    for sc in (2, 3):
        m = scale == sc
        if not np.any(m):
            continue
        idx = np.nonzero(m)[0]
        big = np.kron(glyph_arr, np.ones((1, sc, sc), np.float32))  # 10,7s,5s
        ghs, gws = 7 * sc, 5 * sc
        r = np.arange(ghs, dtype=np.float64)
        # per-row integer x offset: floor(shear * r / (gh-1) + 0.5)
        off = np.floor(shear[idx][:, None] * r / (ghs - 1)
                       + 0.5).astype(np.int64)              # [k, gh]
        rows = y0[idx][:, None] + np.arange(ghs)            # [k, gh]
        cols = (x0[idx][:, None, None] + off[:, :, None]
                + np.arange(gws))                           # [k, gh, gw]
        cols = np.clip(cols, 0, 27)
        canvas[idx[:, None, None], rows[:, :, None], cols] = \
            big[labels[idx]]

    # distractor strokes: short horizontal/vertical bars overlapping the
    # glyph region (max-composited so they read as clutter, not holes)
    rows28 = np.arange(28)
    for _stroke in range(N_STROKES):
        s, raw = _xs_next(s)
        orient = (raw & np.uint64(1)).astype(np.int64)      # 0=h, 1=v
        s, raw = _xs_next(s)
        pos = (_uni(raw) * 28).astype(np.int64)
        s, raw = _xs_next(s)
        start = (_uni(raw) * 20).astype(np.int64)
        s, raw = _xs_next(s)
        length = 4 + (_uni(raw) * 9).astype(np.int64)
        s, raw = _xs_next(s)
        val = (0.3 + 0.4 * _uni(raw)).astype(np.float32)
        span = ((rows28 >= start[:, None])
                & (rows28 < (start + length)[:, None]))     # [n, 28]
        stroke_val = np.where(span, val[:, None], 0.0).astype(np.float32)
        hi = orient == 0
        if np.any(hi):
            i = np.nonzero(hi)[0]
            canvas[i, pos[i], :] = np.maximum(canvas[i, pos[i], :],
                                              stroke_val[i])
        vi = orient == 1
        if np.any(vi):
            i = np.nonzero(vi)[0]
            canvas[i, :, pos[i]] = np.maximum(canvas[i, :, pos[i]],
                                              stroke_val[i])

    # separable 1-2-1 blur with zero-padded borders (vertical, horizontal)
    pad = np.pad(canvas, ((0, 0), (1, 1), (0, 0)))
    canvas = 0.25 * pad[:, :-2] + 0.5 * pad[:, 1:-1] + 0.25 * pad[:, 2:]
    pad = np.pad(canvas, ((0, 0), (0, 0), (1, 1)))
    canvas = 0.25 * pad[:, :, :-2] + 0.5 * pad[:, :, 1:-1] \
        + 0.25 * pad[:, :, 2:]

    # 784 noise draws per sample, row-major — same order as the C++ loop
    noise = np.empty((n, 784), np.float64)
    for i in range(784):
        s, raw = _xs_next(s)
        noise[:, i] = (_uni(raw) - 0.5) * NOISE_AMP
    out = (canvas.reshape(n, 784) * intensity[:, None]
           + noise.astype(np.float32))
    return np.clip(out, 0.0, 1.0).astype(np.float32)

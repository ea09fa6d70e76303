"""Lossless JPEG (SOF3, Huffman) — the scans of ``utils/_jpeg.py``'s lossless
frames, as libjpeg-turbo 3's ``jdlhuff.c``, ``jddiffct.c`` and
``jdlossls.c`` decode them.

Each sample is its prediction plus a Huffman-coded difference of category 0
to 16 (16 means 32768 and has no extra bits), reconstructed modulo 2^16,
shifted left by the point transform Pt (the scan's Al) and stored as an
8-bit sample (its low 8 bits). The predictor (the scan's Ss, 1 to 7) works
on the unshifted values: Ra (left), Rb (above), Rc (above left); 4 is
Ra + Rb − Rc, 5 Ra + (Rb − Rc) >> 1, 6 Rb + (Ra − Rc) >> 1, 7 (Ra + Rb) >> 1.
The first row of a scan, and of each restart interval, is predicted from its
left neighbour, its first sample from 2^(7 − Pt); the first sample of every
other row from the one above (T.81 H.1.2). libjpeg applies a restart's reset
to the first row of the iMCU row being decoded (a component's v_samp rows)
and refuses a restart interval that is not a whole number of MCU rows.
Where the data of an interval runs out, libjpeg reads zeros to the end of
the MCU row, then gives the interval's later rows zero differences, each
row predicted as a first row; a code that matches nothing reads as category
0 after 17 bits. Samples past a component's real size (an interleaved MCU's
padding) are decoded and dropped.

The differences are Huffman-decoded in one Python loop; the reconstruction
is vectorised: predictors 1 to 4 are linear modulo 2^16 (prefix sums along
rows, columns or both, or one NumPy step a row), 5 to 7 run as a wavefront
over anti-diagonals (one NumPy step for each, about H + W of them).
"""

from __future__ import annotations

import numpy as np


def _zero_code_value(table: list) -> int:
    """The difference a table gives on all-zero bits (libjpeg's reading past
    the data)."""
    tl, _, v = table[0]
    if tl > 0:
        return v
    if tl < 0:
        return 32768 if v == 16 else (-(1 << v) + 1 if v else 0)
    return 0


def _decode_interval(segment: bytes, tables: list, per_row: int, n_rows: int) -> tuple[list, int, bool]:
    """One restart interval's differences, ``per_row`` a row of MCUs (the
    MCU's samples in ``tables``' order) → (the differences, the index of the
    first row after the data ran out, else ``n_rows``; whether it ran out)."""
    from ._jpeg import _windows

    nbits = 8 * len(segment)
    W = _windows(segment + bytes(64))
    n_tab = len(tables)
    out = []
    append = out.append
    p = 0
    for row in range(n_rows):
        j = 0
        try:
            for j in range(per_row):
                t = tables[j % n_tab]
                tl, _, v = t[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if tl > 0:
                    p += tl
                elif tl < 0:
                    p -= tl
                    if v == 16:
                        v = 32768
                    elif v:
                        s = v
                        bits = (W[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                        p += s
                        v = bits - (1 << s) + 1 if bits < (1 << (s - 1)) else bits
                else:  # no code matches: libjpeg reads 17 bits and takes category 0
                    p += 17
                append(v)
        except IndexError:  # far past the data: the rest of the row decodes all-zero bits
            out.extend(_zero_code_value(tables[i % n_tab]) for i in range(j, per_row))
        if p > nbits:
            out.extend([0] * (per_row * (n_rows - row - 1)))
            return out, row + 1, True
    return out, n_rows, False


def decode_scan(frame: dict, scan: list, segments: list, restart: int, psv: int, pt: int):
    """One lossless scan: ``scan`` is (component, its Huffman table) in scan
    order; each component's reconstructed 8-bit samples, at its real size,
    go to ``c["samples"]``."""
    comps = [c for c, _ in scan]
    if len(comps) == 1:  # non-interleaved: one sample an MCU
        per_row, rows = comps[0]["w"], comps[0]["h_px"]
        tables = [scan[0][1]]
    else:  # an MCU: each component's v rows of h samples in turn
        per_row, rows = frame["mcux"], frame["mcuy"]
        tables = [t for c, t in scan for _ in range(c["v"] * c["h"])]
    per = len(tables)
    interval = restart // per_row if restart else rows
    diffs, reset = [], np.zeros(rows, bool)  # reset: an MCU row at which the predictors start over
    out = False  # libjpeg's insufficient_data, which an interval left unread (None) keeps
    for s, r0 in enumerate(range(0, rows, interval)):
        n_rows = min(interval, rows - r0)
        segment = segments[s] if s < len(segments) else None
        if segment is None and out:  # every row: zero differences, predicted as a first row
            vals, ran_out = [0] * (per_row * per * n_rows), 0
        else:
            vals, ran_out, out = _decode_interval(segment or b"", tables, per_row * per, n_rows)
        diffs.extend(vals)
        reset[r0] = True
        reset[r0 + ran_out:r0 + n_rows] = True
    d = np.asarray(diffs, np.int64).reshape(rows, per_row, per)
    start = 0
    for c in comps:
        if len(comps) == 1:
            plane = d[..., 0]
            imcu_reset = np.zeros(-(-rows // c["v"]), bool)
            np.logical_or.at(imcu_reset, np.arange(rows) // c["v"], reset)
        else:
            n = c["v"] * c["h"]
            plane = d[..., start:start + n].reshape(rows, per_row, c["v"], c["h"]).transpose(0, 2, 1, 3)
            plane = plane.reshape(rows * c["v"], per_row * c["h"])
            start += n
            imcu_reset = reset
        plane = plane[:c["h_px"], :c["w"]]
        first = np.zeros(c["h_px"], bool)
        first[::c["v"]] = imcu_reset[:len(first[::c["v"]])]
        c["samples"] = (undifference(plane, first, psv, pt) << pt & 0xFF).astype(np.uint8)


def undifference(d: np.ndarray, first: np.ndarray, psv: int, pt: int) -> np.ndarray:
    """(H, W) differences → samples modulo 2^16 (unshifted), rows where
    ``first`` is set predicted as a scan's first row."""
    d = d.astype(np.int64)
    h, w = d.shape
    first = first.copy()
    first[0] = True
    starts = np.flatnonzero(first)
    ends = np.append(starts[1:], h)
    col0 = np.empty(h, np.int64)
    for a, b in zip(starts, ends):  # the first column: the initial value, then predictor 2
        col0[a:b] = (1 << (7 - pt)) + np.cumsum(d[a:b, 0])
    rows_from_left = col0[:, None] + np.cumsum(d[:, 1:], axis=1)  # predictor 1 along each row
    v = np.concatenate([col0[:, None], rows_from_left], axis=1) & 0xFFFF
    if psv == 1:
        return v
    if psv in (2, 4):
        inc = d if psv == 2 else np.cumsum(d, axis=1)  # 4: a row's step from the one above is its prefix sum
        for a, b in zip(starts, ends):
            if b - a > 1:
                v[a + 1:b] = (v[a] + np.cumsum(inc[a + 1:b], axis=0)) & 0xFFFF
        return v
    if psv == 3:
        for y in range(1, h):
            if not first[y]:
                v[y, 1:] = (v[y - 1, :-1] + d[y, 1:]) & 0xFFFF
        return v
    return _wavefront(d, v, first, psv)


def _wavefront(d: np.ndarray, v: np.ndarray, first: np.ndarray, psv: int) -> np.ndarray:
    """Predictors 5-7 over anti-diagonals: in the skewed layout S[y, y + x] =
    v[y, x] a step t computes column t from columns t − 1 (Ra, Rb) and t − 2
    (Rc); first rows and the first column keep the values of ``v``."""
    h, w = d.shape
    yy, xx = np.mgrid[0:h, 0:w]
    S = np.zeros((h, h + w - 1), np.int64)
    D = np.zeros_like(S)
    S[yy, yy + xx] = v
    D[yy, yy + xx] = d
    keep = first[:, None] | (np.arange(h + w - 1)[None, :] <= np.arange(h)[:, None])  # first rows, x ≤ 0
    for t in range(2, h + w - 1):
        lo, hi = max(1, t - w + 1), min(h - 1, t - 1)
        if lo > hi:
            continue
        ra = S[lo:hi + 1, t - 1]
        rb = S[lo - 1:hi, t - 1]
        rc = S[lo - 1:hi, t - 2]
        if psv == 5:
            pred = ra + ((rb - rc) >> 1)
        elif psv == 6:
            pred = rb + ((ra - rc) >> 1)
        else:
            pred = (ra + rb) >> 1
        new = (pred + D[lo:hi + 1, t]) & 0xFFFF
        S[lo:hi + 1, t] = np.where(keep[lo:hi + 1, t], S[lo:hi + 1, t], new)
    return S[yy, yy + xx]

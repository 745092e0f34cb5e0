"""ASCII P3 PPM codec, byte-compatible with the reference writer.

The reference writes `P3\\n<w> <h>\\n255\\n` then one line per row with
pixels separated by two spaces and channels by one (Code/image.cpp:53-83),
and reads P3 with comment skipping and [0,255] clamping
(Code/image.cpp:86-133).  write_ppm here reproduces the writer's byte
layout exactly so golden files diff clean.

A C++ fast path (ray_tracying.native) accelerates parsing of large
files when the native extension is built; the pure-Python path is the
fallback and the semantics oracle.
"""

from __future__ import annotations

import numpy as np

try:
    from ray_tracying.native import ppm_native as _native
except Exception:  # pragma: no cover - native ext optional
    _native = None


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM file -> (H, W, 3) uint8.

    Raises ValueError on a non-P3 magic; values are clamped to [0,255]
    like the reference reader.
    """
    if _native is not None:
        out = _native.read_ppm(path)
        if out is not None:
            return out
    with open(path, "rb") as f:
        data = f.read()
    # Tokenize, dropping comment lines (# ... \n).
    tokens: list[bytes] = []
    for line in data.split(b"\n"):
        hash_idx = line.find(b"#")
        if hash_idx >= 0:
            line = line[:hash_idx]
        tokens.extend(line.split())
    if not tokens or tokens[0] != b"P3":
        raise ValueError(f"{path}: only P3 PPM format is supported")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int64)
    if vals.size != w * h * 3:
        raise ValueError(f"{path}: truncated pixel data")
    del maxval  # reference only warns when != 255 (Code/image.cpp:118-120)
    return np.clip(vals, 0, 255).astype(np.uint8).reshape(h, w, 3)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as ASCII P3, matching the reference's exact
    separators: "  " between pixels, " " between channels, newline per row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("write_ppm expects uint8")
    h, w, _ = img.shape
    if _native is not None and _native.write_ppm(path, img):
        return
    rows = []
    flat = img.reshape(h, w * 3)
    for y in range(h):
        row = flat[y]
        parts = []
        for x in range(w):
            parts.append(f"{row[3*x]} {row[3*x+1]} {row[3*x+2]}")
        rows.append("  ".join(parts))
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write("\n".join(rows))
        f.write("\n")

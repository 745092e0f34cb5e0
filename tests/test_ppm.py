"""PPM codec tests: roundtrip + byte-compatibility with the reference
writer (Code/image.cpp:53-83)."""

import os

import numpy as np
import pytest

from ray_tracying.io.ppm import read_ppm, write_ppm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "golden", "Output")


def test_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 7, 3), dtype=np.uint8)
    p = tmp_path / "x.ppm"
    write_ppm(str(p), img)
    back = read_ppm(str(p))
    np.testing.assert_array_equal(img, back)


def test_comment_skipping(tmp_path):
    p = tmp_path / "c.ppm"
    p.write_text("P3\n# a comment\n2 1\n255\n1 2 3  4 5 6\n")
    img = read_ppm(str(p))
    np.testing.assert_array_equal(img, [[[1, 2, 3], [4, 5, 6]]])


def test_rejects_non_p3(tmp_path):
    p = tmp_path / "b.ppm"
    p.write_text("P6\n1 1\n255\n")
    with pytest.raises(ValueError):
        read_ppm(str(p))


@pytest.mark.skipif(
    not os.path.exists(os.path.join(GOLD, "det_basic_s1.ppm")),
    reason="golden files not generated",
)
def test_byte_identical_to_reference_writer(tmp_path):
    """Reading a reference-written file and re-writing it must reproduce the
    exact bytes (same separators / row layout)."""
    src = os.path.join(GOLD, "det_basic_s1.ppm")
    img = read_ppm(src)
    out = tmp_path / "rewrite.ppm"
    write_ppm(str(out), img)
    assert out.read_bytes() == open(src, "rb").read()

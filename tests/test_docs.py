"""Record-keeping guards: speed claims in the README name their device,
and the old accelerator's records and switches are gone."""

import os
import re
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _readme():
    with open(os.path.join(REPO, "README.md")) as f:
        return f.read()


def test_readme_rates_name_their_card():
    """Every paragraph of the README that states a rate (rays/s, x faster)
    names the card it was measured on."""
    rate = re.compile(r"\d[\d.,]*\s*[MG]?\s*(rays?/s|Mrays/s|×|x faster)")
    card = re.compile(r"H100|H200|NVIDIA|GPU card|\bCPU\b")
    for para in _readme().split("\n\n"):
        if rate.search(para):
            assert card.search(para), f"rate without a card name: {para[:200]!r}"


def test_no_old_accelerator_records_or_switches():
    names = set(os.listdir(REPO))
    for pat in (r"BENCH_r\d+\.json", r"MULTICHIP_r\d+\.json",
                r"PROFILE_r\d+\.json", r"FWDBWD_r\d+\.json"):
        assert not any(re.fullmatch(pat, n) for n in names), pat
    for gone in ("SCALING.json", "PROGRESS.jsonl", "VERDICT.md", "ADVICE.md",
                 "BASELINE.md"):
        assert gone not in names
    # The pattern is assembled so this file does not match it.
    words = ["pallas\\.t" "pu", "plt" "pu", "RTT_" "PALLAS_INTERPRET",
             "RTT_" "DISABLE_PALLAS", "pallas_" "disabled"]
    out = subprocess.run(
        ["git", "grep", "-nE", "|".join(words), "--", "*.py", "*.toml"],
        cwd=REPO, capture_output=True, text=True,
    )
    if out.returncode == 128:  # not a git checkout
        return
    assert out.stdout == "", out.stdout


def test_package_imports_no_flax_or_orbax(tmp_path):
    """`import ray_tracying` and fit(checkpoint_dir=...) load neither."""
    code = (
        "import sys, jax, jax.numpy as jnp\n"
        "sys.path.insert(0, 'tests')\n"
        "import ray_tracying as rt\n"
        "from ray_tracying.diff.optimize import fit\n"
        "from test_diff import tiny_scene\n"
        "s = tiny_scene(res=(8, 6))\n"
        "fit(s, jnp.zeros((6, 8, 3)), ['lights.intensity'], steps=2,\n"
        f"    checkpoint_dir={str(tmp_path)!r}, checkpoint_every=1)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('flax', 'orbax')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    p = subprocess.run(["python", "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "clean" in p.stdout, p.stderr[-2000:]

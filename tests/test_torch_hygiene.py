"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the GPU, and without CUDA they raise instead of
running on the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ops import cuda_intersect as CI
from epsm_mitsuba3_torch.scenes import cornell_box

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "epsm_mitsuba3_torch"
FORBIDDEN = ("jax", "jaxlib", "epsm_mitsuba3_tpu")

_PROBE = """
import importlib, pkgutil, sys
import epsm_mitsuba3_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
print(sorted(m for m in sys.modules if m.split(".")[0] in %r))
""" % (FORBIDDEN,)


def test_fresh_import_loads_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    no jax* or epsm_mitsuba3_tpu* module in sys.modules."""
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_names_no_jax(path):
    text = (REPO / path).read_text()
    pattern = r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN)
    assert not re.search(pattern, text, re.M), path


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")


def test_load_dict_without_device_raises():
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.load_dict(cornell_box(res=8, spp=1))


def test_render_without_device_raises():
    _require_no_cuda()
    scene = mt.load_dict(cornell_box(res=8, spp=1), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.render(scene, spp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.render(scene, spp=1, device="cuda")


def test_cpu_calls_run_plain_versions_and_launch_nothing():
    before = dict(CI.launches)
    scene = mt.load_dict(cornell_box(res=8, spp=1), device="cpu")
    img = mt.render(scene, spp=1, device="cpu")
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert CI.launches == before
    assert CI._lib is None      # nothing was built or loaded

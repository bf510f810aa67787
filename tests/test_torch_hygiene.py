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


def test_epsm_entry_points_without_device_raise():
    """The EPSM slice's entry points: a manifold render, the matcher and
    the cornellbox experiment default to the GPU too."""
    _require_no_cuda()
    from epsm_mitsuba3_torch.app.exp import cornellbox
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    scene = mt.load_dict(cornell_box(res=8, spp=1), device="cpu")
    for kind in ("manifold", "manifold_caustic"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.render(scene, spp=1, integrator={"type": kind})
        img = mt.render(scene, spp=1, integrator={"type": kind},
                        device="cpu")
        assert img.shape == (8, 8, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        cornellbox.make(resolution=8, match_res=8)


def test_reparam_entry_points_without_device_raise():
    """``prb_reparam`` and ``prb_basic`` default to the GPU too; on the
    CPU the reparameterised backward's auxiliary rays run K1's plain
    version and build nothing."""
    _require_no_cuda()
    before = dict(CI.launches)
    scene = mt.load_dict(cornell_box(res=8, spp=1), device="cpu")
    for kind in ("prb_reparam", "prb_basic"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.render(scene, spp=1, integrator={"type": kind})
    refl = scene.bsdfs["reflectance"].clone().requires_grad_(True)
    img = mt.render(scene.with_leaves({"bsdfs.reflectance": refl}), spp=1,
                    device="cpu", integrator={"type": "prb_reparam",
                                              "reparam_rays": 2})
    (g,) = torch.autograd.grad(img.sum(), refl)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    assert CI.launches == before and CI._lib is None


def test_scene_file_entry_points_without_device_raise(tmp_path):
    """The scene-file slice's entry points default to the GPU too:
    ``load_file``, ``load_string``, the CLI and ``glassslab.make``."""
    _require_no_cuda()
    from epsm_mitsuba3_torch import cli
    from epsm_mitsuba3_torch.app.exp import glassslab
    from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml
    path = tmp_path / "box.xml"
    text = dict_to_xml(cornell_box(res=8, spp=1), str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.load_file(str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.load_string(text)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(path), "-o", str(tmp_path / "o.exr")])
    assert not (tmp_path / "o.exr").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        glassslab.make(resolution=8, match_res=8)
    assert mt.load_file(str(path), device="cpu").faces.shape == (12, 3)


def test_human_slice_entry_points_without_device_raise(tmp_path,
                                                       monkeypatch):
    """The human slice's entry points default to the GPU too:
    ``procedural_template``, ``load_npz``, ``human.make``,
    ``optim_human.run`` and ``run_experiments.main``; none falls back to
    the CPU or writes a log."""
    _require_no_cuda()
    import numpy as np
    from epsm_mitsuba3_torch.app import optim_human, run_experiments
    from epsm_mitsuba3_torch.app.exp import human
    from epsm_mitsuba3_torch.models import smpl
    m = smpl.procedural_template(device="cpu")
    path = str(tmp_path / "body.npz")
    np.savez(path, v_template=m.template.numpy(), f=m.faces,
             weights=m.weights.numpy(), J=m.joints.numpy())
    with pytest.raises(RuntimeError, match="CUDA"):
        smpl.procedural_template()
    with pytest.raises(RuntimeError, match="CUDA"):
        smpl.load_npz(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        human.make(resolution=8, match_res=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        human.make(resolution=8, match_res=8, smpl_npz=path)
    with pytest.raises(RuntimeError, match="CUDA"):
        optim_human.run(iters=1, resolution=8, match_res=8)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiments.main(["manifold", "human", "--small"])
    assert not (tmp_path / "results").exists()
    assert smpl.load_npz(path, device="cpu").template.shape == (2112, 3)


def test_forward_and_direct_entry_points_without_device_raise():
    """``render_forward`` and ``render`` with ``direct``,
    ``direct_reparam`` and ``emission_reparam`` default to the GPU too; on
    the CPU they run the plain versions and build nothing."""
    _require_no_cuda()
    before = dict(CI.launches)
    scene = mt.load_dict(cornell_box(res=8, spp=1, max_depth=2),
                         device="cpu")
    tangent = {"bsdfs.reflectance": torch.ones_like(scene.bsdfs["reflectance"])}
    for kind in ("prb", "prb_reparam"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.render_forward(scene, tangent, spp=1,
                              integrator={"type": kind})
        dimg = mt.render_forward(scene, tangent, spp=1, device="cpu",
                                 integrator={"type": kind,
                                             "reparam_rays": 2})
        assert float(dimg.abs().sum()) > 0
    for kind in ("direct", "direct_reparam", "emission_reparam"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.render(scene, spp=1, integrator={"type": kind})
        img = mt.render(scene, spp=1, device="cpu",
                        integrator={"type": kind, "reparam_rays": 2})
        assert img.shape == (8, 8, 3)
    assert CI.launches == before and CI._lib is None


def test_output_entry_points_without_device_raise():
    """``render`` with ``depth``, ``aov``, ``moment``, ``ptracer`` and the
    spectral types, and ``render_z_test``, default to the GPU too; on the
    CPU they run the plain versions and build nothing."""
    _require_no_cuda()
    from epsm_mitsuba3_torch.utils.image import render_z_test
    before = dict(CI.launches)
    scene = mt.load_dict(cornell_box(res=4, spp=1, max_depth=2),
                         device="cpu")
    for kind in ("depth", "aov", "moment", "ptracer", "spectral",
                 "spectral_mono", "spectral_spec"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.render(scene, spp=1, integrator={"type": kind})
        img = mt.render(scene, spp=1, device="cpu",
                        integrator={"type": kind, "max_depth": 2})
        assert img.shape[:2] == (4, 4) and bool(torch.isfinite(img).all())
    with pytest.raises(RuntimeError, match="CUDA"):
        render_z_test(scene, spp=2)
    mean, var = render_z_test(scene, spp=2, device="cpu")
    assert mean.shape == var.shape == (4, 4, 3)
    assert CI.launches == before and CI._lib is None

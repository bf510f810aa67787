"""The variant policy (``config.py``) in the port: under a ``*_double``
variant every float leaf of a loaded scene is float64 and the BVH and its
K2/K3 records float32; images and PRB gradients come out in float64; the
samplers' draws are the float32 variant's, cast; the CLI's ``-m`` sets
the variant; and one subprocess runs JAX's double variant
(``tests/test_double_variant.py``'s scene) against the port's.

Every test restores the float32 variant (the ``restore_variant``
fixture): the policy is global to the process, and the tests share
worker processes.

Tolerances: the double image within 2e-3 relative mean of the float32
one (JAX's own bar); against JAX's double image within
``assert_images_close``'s 1e-4 (the port's kernels answer in float32,
JAX's CPU brute force in float64, so t, u and v differ by ~1e-7
relative)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch import cli
from epsm_mitsuba3_torch.models import samplers as SMT
from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh
from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml

from test_torch_render import assert_images_close
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOUBLE = "cuda_ad_rgb_double"


@pytest.fixture(autouse=True)
def restore_variant():
    yield
    mt.set_variant("cuda_ad_rgb")
    assert mt.config.dtype == torch.float32


def test_set_variant_policy():
    for name, dtype in (("scalar_rgb", torch.float32),
                        ("llvm_ad_rgb_double", torch.float64),
                        (DOUBLE, torch.float64),
                        ("cuda_ad_rgb", torch.float32)):
        mt.set_variant(name)
        assert mt.variant() == name and mt.config.dtype == dtype


def _render(sc, integ="path"):
    return mt.render(sc, spp=4, seed=3, device="cpu",
                     integrator={"type": integ, "max_depth": 3})


def test_double_leaves_image_and_gradient():
    mt.set_variant(DOUBLE)
    sc = mt.load_dict(cornell_box(res=24, spp=4), device="cpu")
    leaves = sc.leaves()
    assert len(leaves) > 10
    for k, v in leaves.items():
        assert v.dtype == torch.float64, k
    img = _render(sc)
    assert img.dtype == torch.float64 and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.02
    r = sc.bsdfs["reflectance"].clone().requires_grad_(True)
    img2 = _render(sc.with_leaves({"bsdfs.reflectance": r}), "prb")
    g = torch.autograd.grad(img2.sum(), r)[0]
    assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
    assert abs(float(g.sum())) > 1e-6
    mt.set_variant("cuda_ad_rgb")
    img32 = _render(mt.load_dict(cornell_box(res=24, spp=4), device="cpu"))
    assert img32.dtype == torch.float32
    rel = float((img - img32).abs().mean() / img32.mean())
    assert rel < 2e-3, rel


def test_double_keeps_float64_precision():
    """Shading and film run in float64, not in float32 cast at the end:
    a change of 1e-8 to every reflectance (below float32's spacing at
    these values) moves the image by that much times its derivative.
    The central difference at 1e-8 agrees with the one at 1e-3 within
    1e-4 relative; a float32 computation anywhere on the way from the
    leaf to the film gives 0 or a quantised difference instead."""
    mt.set_variant(DOUBLE)
    sc = mt.load_dict(cornell_box(res=16, spp=2), device="cpu")
    r = sc.bsdfs["reflectance"]

    def fd(h):
        lo = _render(sc.with_leaves({"bsdfs.reflectance": r - h}))
        hi = _render(sc.with_leaves({"bsdfs.reflectance": r + h}))
        assert hi.dtype == torch.float64
        return float((hi - lo).sum()) / (2.0 * h)

    small, large = fd(1e-8), fd(1e-3)
    assert large > 1.0, large
    assert abs(small - large) < 1e-4 * large, (small, large)


def test_double_bvh_stays_float32():
    """A BVH scene (4,620 triangles): the tree, its records and the
    rays handed to the plain K2/K3 stay float32; set_vertices re-packs
    them from the float64 vertices; the image is float64 and agrees
    with the float32 variant's."""
    d = cornell_box_mesh(res=8, spp=2, max_depth=3, subdiv=48)
    mt.set_variant(DOUBLE)
    sc = mt.load_dict(d, device="cpu")
    assert sc.bvh is not None and sc.vertices.dtype == torch.float64
    for x in (sc.bvh.bmin, sc.bvh_nodes, sc.bvh_tris, sc.bvh_tris_k):
        assert x.dtype == torch.float32
    sc2 = sc.set_vertices(sc.vertices + 1e-3)
    assert sc2.bvh_nodes.dtype == torch.float32
    assert sc2.bvh.bmin.dtype == torch.float32
    img = mt.render(sc, spp=2, seed=0, device="cpu")
    mt.set_variant("cuda_ad_rgb")
    img32 = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=0,
                      device="cpu")
    assert img.dtype == torch.float64
    assert float((img - img32).abs().mean() / img32.mean()) < 2e-3


def test_draws_are_float32_cast():
    s32 = SMT.seed(7, 1000, kind="stratified", spp=4, device="cpu")
    mt.set_variant(DOUBLE)
    s64 = SMT.seed(7, 1000, kind="stratified", spp=4, device="cpu")
    for _ in range(3):
        s32, a = SMT._next_2d_f32(s32)
        s64, b = SMT.next_2d(s64)
        assert b.dtype == torch.float64
        assert torch.equal(b, a.to(torch.float64))
        s32, a = SMT._next_1d_f32(s32)
        s64, b = SMT.next_1d(s64)
        assert torch.equal(b, a.to(torch.float64))


def test_cli_mode_sets_the_variant(tmp_path):
    xml = str(tmp_path / "box.xml")
    dict_to_xml(cornell_box(res=8, spp=2), xml)
    out = str(tmp_path / "o.npy")
    assert cli.main([xml, "-o", out, "--spp", "2", "--device", "cpu",
                     "-m", "llvm_ad_rgb_double"]) == 0
    assert mt.variant() == "llvm_ad_rgb_double"
    assert mt.config.dtype == torch.float64
    img = np.load(out)
    ref = mt.render(mt.load_file(xml, device="cpu"), spp=2, device="cpu")
    assert ref.dtype == torch.float64
    np.testing.assert_allclose(img, ref.numpy()[..., :3], rtol=1e-6,
                               atol=1e-7)
    assert cli.main([xml, "-o", out, "--spp", "2", "--device", "cpu"]) == 0
    assert mt.config.dtype == torch.float32


_JAX_DOUBLE = r"""
import jax
jax.config.update('jax_platforms', 'cpu')
import sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import numpy as np
import epsm_mitsuba3_tpu as mi
from scenes import cornell_box
mi.set_variant('llvm_ad_rgb_double')
img = mi.render(mi.load_dict(cornell_box(res=16, spp=4)), spp=4, seed=3,
                integrator={'type': 'path', 'max_depth': 3})
assert img.dtype == np.float64
np.save(%(out)r, np.asarray(img))
"""


def test_double_image_matches_jax_double(tmp_path):
    out = str(tmp_path / "jax64.npy")
    script = _JAX_DOUBLE % {"repo": REPO, "tests": os.path.join(REPO, "tests"),
                            "out": out}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(out)
    mt.set_variant(DOUBLE)
    img = mt.render(mt.load_dict(cornell_box(res=16, spp=4), device="cpu"),
                    spp=4, seed=3, device="cpu",
                    integrator={"type": "path", "max_depth": 3})
    assert img.dtype == torch.float64 and ref.dtype == np.float64
    assert_images_close(img.numpy(), ref)

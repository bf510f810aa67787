"""``direct`` (``integrators/direct.py``) of the port against the JAX
package's; its gradient, exactly zero as the reference's; the loader's
three new integrator types from a dict and from XML; the port's
``single_quad_direct`` against the JAX package's ``tests/scenes.py``.

Tolerances: images by ``assert_images_close`` of
``tests/test_torch_render.py`` (mean |diff| <= 1e-4, 99 % of pixels
within 1e-4); ``direct`` against ``path`` at ``max_depth`` 2, means
within 5 %, the JAX package's ``tests/test_integrators.py:17-22``.
"""
import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax
from scenes import single_quad_direct as single_quad_direct_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.scenes import cornell_box, single_quad_direct
from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml

from test_torch_render import assert_images_close, port_scene_of
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP = 16, 4
DIRECT = ("direct", "direct_reparam", "emission_reparam")


def test_direct_image_matches_jax():
    """Two NEE and one BSDF sample a lane on the box, whose walls shadow
    each other."""
    sj = mi.load_dict(cornell_box_jax(res=RES, spp=SPP))
    integ = {"type": "direct", "emitter_samples": 2, "bsdf_samples": 1}
    ref = np.asarray(mi.render(sj, spp=SPP, seed=3, integrator=integ))
    img = mt.render(port_scene_of(sj), spp=SPP, seed=3, device="cpu",
                    integrator=integ).numpy()
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert_images_close(img, ref)


def test_direct_gradient_is_zero():
    """The reference detaches the scene: every leaf's gradient is exactly
    zero, and the call does not raise."""
    sc = mt.load_dict(cornell_box(res=8, spp=2), device="cpu")
    lv = {k: v.clone().requires_grad_(True) for k, v in sc.leaves().items()}
    img = mt.render(sc.with_leaves(lv), spp=2, device="cpu",
                    integrator={"type": "direct"})
    assert img.requires_grad and float(img.detach().mean()) > 0
    g = torch.autograd.grad((img ** 2).sum(), list(lv.values()))
    assert all(gk.shape == lv[k].shape and not gk.any()
               for k, gk in zip(lv, g))


def test_direct_mean_matches_path_on_the_quad():
    sc = mt.load_dict(single_quad_direct(res=RES, spp=64), device="cpu")
    img_d = mt.render(sc, spp=64, device="cpu", integrator={"type": "direct"})
    img_p = mt.render(sc, spp=64, device="cpu",
                      integrator={"type": "path", "max_depth": 2})
    assert float(img_p.mean()) > 0
    assert abs(float(img_d.mean() - img_p.mean())) < 0.05 * float(
        img_p.mean())


def test_single_quad_direct_equals_jax():
    """The port's scene dict loads to the JAX package's scene."""
    ref = port_scene_of(mi.load_dict(single_quad_direct_jax(res=8, spp=2)))
    st = mt.load_dict(single_quad_direct(res=8, spp=2), device="cpu")
    assert torch.equal(st.faces, ref.faces)
    assert list(st.leaves()) == list(ref.leaves())
    for k, v in st.leaves().items():
        assert torch.equal(v, ref.leaves()[k]), k


@pytest.mark.parametrize("kind", DIRECT)
def test_integrator_types_load_and_render(tmp_path, kind):
    """A scene naming ``kind`` loads from a dict and from XML (the loader
    refused it before) and renders on the CPU with it."""
    d = cornell_box(res=8, spp=2)
    d["integrator"] = {"type": kind, "reparam_rays": 2}
    text = dict_to_xml(d, str(tmp_path / "box.xml"))
    assert f'type="{kind}"' in text
    for sc in (mt.load_dict(d, device="cpu"),
               mt.load_file(str(tmp_path / "box.xml"), device="cpu")):
        assert dict(sc.static.integrator)["type"] == kind
        img = mt.render(sc, spp=2, device="cpu")
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
        assert float(img.mean()) > 0

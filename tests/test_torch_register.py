"""The six plugin registries of the port against the JAX package's: one
plugin of each kind, written once in ``jnp`` (the JAX package's own test
plugins, ``tests/test_register_*.py``) and once in torch here, renders
and PRB gradients against JAX's, and the JAX tests' checks on the port
(``test_custom_bsdf_chi2``, ``test_custom_point_matches_builtin``,
``test_register_sampler_unbiased``, ...).

Registries are global to the process, and the tests share worker
processes: each side registers through an idempotent helper, as JAX's
``_ensure_registered`` does.

Tolerances: images as ``assert_images_close`` (1e-4); gradients within
1e-4 of each one's largest entry; the flipped sensor's direction uses
``math.tan`` here and ``jnp.tan`` there, inside the same bar."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax
from test_register_bsdf import _register_once as _jax_phong
from test_register_emitter import _register_once as _jax_mypoint
from test_register_plugins import _ensure_registered as _jax_plugins

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import math as mm
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.models import emitters as ET
from epsm_mitsuba3_torch.models import samplers as SMT
from epsm_mitsuba3_torch.models import scene as SCT
from epsm_mitsuba3_torch.models import sensors as SNT
from epsm_mitsuba3_torch.models import textures as TXT
from epsm_mitsuba3_torch.models.records import BSDFSample, DirectionSample
from epsm_mitsuba3_torch.scenes import cornell_box
from epsm_mitsuba3_torch.utils.chi2 import ChiSquareTest, SphericalDomain

from test_torch_render import assert_images_close
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP = 16, 4
_EXP = 8.0


# -- the plugins, in torch -----------------------------------------------------

def phong_eval_pdf(p, wi, wo):
    r = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    cos_a = torch.clamp((r * wo).sum(-1), 0.0, 1.0)
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    lobe = (_EXP + 2.0) / (2.0 * math.pi) * cos_a ** _EXP
    val = p["reflectance"] * (lobe * torch.clamp(wo[..., 2], min=0.0))[
        ..., None]
    pdf = (_EXP + 1.0) / (2.0 * math.pi) * cos_a ** _EXP
    return torch.where(up[..., None], val, 0.0), torch.where(up, pdf, 0.0)


def phong_sample(p, wi, s1, s2):
    cos_a = s2[..., 0] ** (1.0 / (_EXP + 1.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = 2.0 * math.pi * s2[..., 1]
    r = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    s_, t_ = mm.coordinate_system(r)
    wo = (s_ * (sin_a * torch.cos(phi))[..., None]
          + t_ * (sin_a * torch.sin(phi))[..., None] + r * cos_a[..., None])
    val, pdf = phong_eval_pdf(p, wi, wo)
    ok = (pdf > 0) & (wi[..., 2] > 0)
    w = torch.where(ok[..., None],
                    val / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                    sampled_type=torch.full(pdf.shape,
                                            BT.BSDFFlags.GlossyReflection,
                                            dtype=torch.int32),
                    hf=torch.zeros_like(wo))
    return bs, w, ok


def mypoint_sample(row, ref_p, s2):
    dvec = row["position"] - ref_p
    dist2 = (dvec * dvec).sum(-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    d = dvec / dist[..., None]
    ds = DirectionSample(
        p=row["position"], n=-d, uv=s2, d=d, dist=dist,
        pdf=torch.ones_like(dist),
        delta=torch.ones(dist.shape, dtype=torch.bool),
        emitter_index=torch.zeros(dist.shape, dtype=torch.int32))
    return ds, row["intensity"] / torch.clamp(dist2, min=1e-20)[..., None]


def pyramid(props):
    s = float(props.get("size", 1.0))
    v = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
                  [0, 1.5 * s, 0]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [0, 1, 4], [1, 2, 4], [2, 3, 4],
                  [3, 0, 4]], np.int32)
    return {"vertices": v, "faces": f}


def flipped(sensor, pos01):
    aspect = sensor.width / sensor.height
    th = math.tan(math.radians(sensor.fov_x) * 0.5)
    u, v = 1.0 - pos01[..., 0], pos01[..., 1]
    d_cam = torch.stack([(1 - 2 * u) * th, (1 - 2 * v) * th / aspect,
                         torch.ones_like(u)], -1)
    d = d_cam @ sensor.to_world[:3, :3].T
    return sensor.to_world[:3, 3].expand(d.shape), d, None


def uv_gradient(tex, uv, pos):
    t = torch.clamp(uv[..., 0:1], 0.0, 1.0)
    return tex.color1 * t + tex.color0 * (1.0 - t)


def halfshift(sampler):
    s, x = SMT._next_1d_f32(sampler)
    return s, torch.remainder(x + 0.5, 1.0)


def ensure_registered():
    """Register the torch plugins once a process, and JAX's."""
    _jax_phong()
    _jax_mypoint()
    _jax_plugins()
    if "myphong" not in BT.KIND_NAMES:
        mt.register_bsdf("myphong", eval_pdf_fn=phong_eval_pdf,
                         sample_fn=phong_sample,
                         flags=BT.BSDFFlags.GlossyReflection
                         | BT.BSDFFlags.FrontSide)
    if "mypoint" not in ET.KIND_NAMES:
        mt.register_emitter("mypoint", sample_fn=mypoint_sample)
    if "pyramid" not in SCT._CUSTOM_SHAPE_FNS:
        mt.register_shape("pyramid", pyramid)
    if "flipped_perspective" not in SNT._CUSTOM_SENSOR_FNS:
        mt.register_sensor("flipped_perspective", flipped)
    if "uv_gradient" not in TXT._CUSTOM_TEXTURE_FNS:
        mt.register_texture("uv_gradient", uv_gradient)
    if "halfshift" not in SMT._CUSTOM_SAMPLER_FNS:
        mt.register_sampler("halfshift", halfshift)


@pytest.fixture(scope="module", autouse=True)
def registered():
    ensure_registered()


# -- scenes, built for each package -----------------------------------------

def _box(make, edit, res=RES, spp=SPP, depth=3):
    d = make(res=res, spp=spp, max_depth=depth)
    edit(d)
    return d


def _with_phong(d):
    d["back"]["bsdf"] = {"type": "myphong",
                         "reflectance": {"type": "rgb",
                                         "value": [0.8, 0.6, 0.2]}}


def _with_pyramid(T):
    def edit(d):
        d["pyr"] = {"type": "pyramid", "size": 0.6,
                    "to_world": T.translate([0, 0.0, 0]),
                    "bsdf": {"type": "diffuse",
                             "reflectance": {"type": "rgb", "value": 0.6}}}
    return edit


def _flipped(d):
    for k, v in list(d.items()):
        if isinstance(v, dict) and v.get("type") == "perspective":
            d[k] = {**v, "type": "flipped_perspective"}


def _uv_floor(d):
    d["floor"]["bsdf"] = {"type": "diffuse",
                          "reflectance": {"type": "uv_gradient",
                                          "color0": [0.0, 0.0, 0.0],
                                          "color1": [0.9, 0.9, 0.9]}}


def _halfshift(d):
    for v in d.values():
        if isinstance(v, dict) and v.get("type") == "perspective":
            v["sampler"] = {"type": "halfshift", "sample_count": SPP}


def _em_scene(T, light_type, res=RES):
    """JAX's ``tests/test_register_emitter.py`` ``_scene`` at ``res``, for
    either package's transforms."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {
            "type": "perspective", "fov": 40.0,
            "to_world": T.look_at(origin=[0, 0, 3], target=[0, 0, 0],
                                  up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": 32}},
        "wall": {"type": "rectangle", "to_world": T.scale([2, 2, 1]),
                 "bsdf": {"type": "diffuse",
                          "reflectance": {"type": "rgb",
                                          "value": [0.8, 0.6, 0.4]}}},
        "light": {"type": light_type, "position": [0.5, 0.5, 2.0],
                  "intensity": {"type": "rgb", "value": [4.0, 4.0, 4.0]}},
    }


def _three_plugins(T):
    """The box with the registered BSDF on the back wall, the registered
    texture on the floor and the registered point light beside the area
    light."""
    def edit(d):
        _with_phong(d)
        _uv_floor(d)
        d["bulb"] = {"type": "mypoint", "position": [0.0, 1.5, 0.5],
                     "intensity": {"type": "rgb", "value": [1.5] * 3}}
    return edit


CASES = {
    "bsdf, texture, emitter": lambda T: _three_plugins(T),
    "shape": _with_pyramid,
    "sensor": lambda T: _flipped,
    "sampler": lambda T: _halfshift,
}


def _pair(case):
    return (mi.load_dict(_box(cornell_box_jax,
                              CASES[case](mi.ScalarTransform4f))),
            mt.load_dict(_box(cornell_box, CASES[case](mt.ScalarTransform4f)),
                         device="cpu"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax(case):
    """Each plugin in a 16^2 render against JAX's: the registered BSDF,
    texture and light in one box, the shape, the sensor and the sampler
    each in another."""
    sj, st = _pair(case)
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0))
    img = mt.render(st, spp=SPP, seed=0, device="cpu").numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert_images_close(img, ref)


def test_prb_gradients_match_jax():
    """PRB gradients through three plugins in one scene: the registered
    BSDF's reflectance, the registered light's intensity (through its
    sample function) and the registered texture's colour, against
    ``jax.grad``."""
    sj = mi.load_dict(_box(cornell_box_jax,
                           _three_plugins(mi.ScalarTransform4f)))
    st = mt.load_dict(_box(cornell_box, _three_plugins(mt.ScalarTransform4f)),
                      device="cpu")
    tex = [i for i, t in enumerate(st.textures) if t.kind == "uv_gradient"]
    assert len(tex) == 1 and sj.textures[tex[0]].kind == "uv_gradient"
    i = tex[0]
    w = np.random.default_rng(6).normal(size=(RES, RES, 3)).astype(
        np.float32)
    integ = {"type": "prb", "max_depth": 3}

    def loss_j(r, e, c):
        texs = list(sj.textures)
        texs[i] = texs[i].replace(color1=c)
        s = sj.replace(bsdfs={**sj.bsdfs, "reflectance": r},
                       emitters={**sj.emitters, "intensity": e},
                       textures=tuple(texs))
        return jnp.sum(mi.render(s, spp=SPP, seed=3, integrator=integ) * w)

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(
        sj.bsdfs["reflectance"], sj.emitters["intensity"],
        sj.textures[i].color1)
    names = ("bsdfs.reflectance", "emitters.intensity",
             f"textures.{i}.color1")
    lv = {k: st.leaves()[k].clone().requires_grad_(True) for k in names}
    img = mt.render(st.with_leaves(lv), spp=SPP, seed=3, device="cpu",
                    integrator=integ)
    gt = torch.autograd.grad((img * torch.from_numpy(w)).sum(),
                             list(lv.values()))
    for k, a, b in zip(names, gt, gj):
        a, b = a.numpy(), np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0 and np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)


def test_kinds_flags_and_taken_names():
    kind = BT.KIND_NAMES["myphong"]
    assert kind >= BT._CUSTOM_KIND_BASE and ET.KIND_NAMES["mypoint"] >= 1000
    assert BT.KIND_FLAGS[kind] == (BT.BSDFFlags.GlossyReflection
                                   | BT.BSDFFlags.FrontSide)
    with pytest.raises(ValueError):
        mt.register_bsdf("myphong", eval_pdf_fn=phong_eval_pdf,
                         sample_fn=phong_sample)
    with pytest.raises(ValueError):
        mt.register_bsdf("diffuse", eval_pdf_fn=phong_eval_pdf,
                         sample_fn=phong_sample)
    with pytest.raises(ValueError):
        mt.register_emitter("point", sample_fn=mypoint_sample)
    with pytest.raises(ValueError):
        mt.register_shape("sphere", lambda p: None)
    with pytest.raises(ValueError):
        mt.register_sensor("perspective", flipped)
    with pytest.raises(ValueError):
        mt.register_texture("uv_gradient", uv_gradient)
    with pytest.raises(ValueError):
        mt.register_sampler("independent", halfshift)
    # the MIS contract: a light on a shape gives its pdf
    with pytest.raises(ValueError, match="pdf_fn"):
        mt.register_emitter("half_light", sample_fn=mypoint_sample,
                            eval_hit_fn=lambda row, wz, uv: row["radiance"])
    assert "half_light" not in ET.KIND_NAMES


# -- JAX's tests/test_register_*.py checks, on the port ----------------------

def test_custom_bsdf_chi2():
    wi0 = torch.tensor([0.3, -0.2, 0.933])
    wi0 = wi0 / wi0.norm()
    gen = torch.Generator().manual_seed(3)

    def params(n):
        return {"reflectance": torch.full((n, 3), 0.8)}

    def sample(n):
        bs, _, ok = phong_sample(params(n), wi0.expand(n, 3), None,
                                 torch.rand((n, 2), generator=gen))
        return bs.wo[ok]

    def pdf(dirs):
        wo = dirs.reshape(-1, 3)
        return phong_eval_pdf(params(wo.shape[0]), wi0.expand(wo.shape[0], 3),
                              wo)[1].reshape(dirs.shape[:-1])

    test = ChiSquareTest(SphericalDomain(), sample, pdf,
                         sample_count=200_000, res=21, ires=16, device="cpu")
    assert test.run(), test.messages


def test_custom_point_matches_builtin():
    T = mt.ScalarTransform4f
    img_c = mt.render(mt.load_dict(_em_scene(T, "mypoint"), device="cpu"),
                      seed=3, spp=8, device="cpu")
    img_b = mt.render(mt.load_dict(_em_scene(T, "point"), device="cpu"),
                      seed=3, spp=8, device="cpu")
    assert float(img_c.mean()) > 0.01
    torch.testing.assert_close(img_c, img_b, rtol=1e-4, atol=1e-5)


def test_custom_emitter_pick_probability():
    T = mt.ScalarTransform4f
    d = _em_scene(T, "mypoint")
    d["fill"] = {"type": "point", "position": [0.0, 0.0, 2.5],
                 "intensity": {"type": "rgb", "value": [1e-6] * 3}}
    img2 = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=64,
                     device="cpu")
    img1 = mt.render(mt.load_dict(_em_scene(T, "mypoint"), device="cpu"),
                     seed=5, spp=64, device="cpu")
    assert abs(float(img2.mean() - img1.mean())) / float(img1.mean()) < 0.05


def test_register_shape_renders():
    T = mt.ScalarTransform4f
    base = mt.render(mt.load_dict(cornell_box(res=RES, spp=8, max_depth=3),
                                  device="cpu"), spp=8, seed=0, device="cpu")
    st = mt.load_dict(_box(cornell_box, _with_pyramid(T), spp=8),
                      device="cpu")
    assert "pyr" in st.static.shape_names
    img = mt.render(st, spp=8, seed=0, device="cpu")
    assert float((img - base).abs().mean()) > 1e-3


def test_register_sensor_flips_image():
    d = cornell_box(res=24, spp=8, max_depth=2)
    img = mt.render(mt.load_dict(d, device="cpu"), spp=16, seed=0,
                    device="cpu").numpy()
    _flipped(d)
    flip = mt.render(mt.load_dict(d, device="cpu"), spp=16, seed=0,
                     device="cpu").numpy()

    def asym(im):
        w = im.shape[1]
        left, right = im[:, : w // 3], im[:, -w // 3:]
        return float((left[..., 0] - left[..., 1]).mean()
                     - (right[..., 0] - right[..., 1]).mean())

    a_fwd, a_flip = asym(img), asym(flip)
    assert a_fwd * a_flip < 0 and abs(a_flip) > 0.3 * abs(a_fwd)


def test_register_texture_drives_reflectance():
    st = mt.load_dict(_box(cornell_box, _uv_floor, res=24, spp=8, depth=2),
                      device="cpu")
    assert any(t.kind == "uv_gradient" for t in st.textures)
    img = mt.render(st, spp=16, seed=0, device="cpu").numpy()
    floor = img[-6:, :, :].mean(axis=(0, 2))
    assert abs(floor[-6:].mean() - floor[:6].mean()) > 0.02


def test_register_sampler_unbiased():
    d = cornell_box(res=RES, spp=8, max_depth=3)
    ref = np.mean([mt.render(mt.load_dict(d, device="cpu"), spp=16, seed=s,
                             device="cpu").numpy() for s in range(3)], 0)
    _halfshift(d)
    st = mt.load_dict(d, device="cpu")
    assert st.static.sampler_kind == "halfshift"
    img = np.mean([mt.render(st, spp=16, seed=s, device="cpu").numpy()
                   for s in range(3)], 0)
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.08

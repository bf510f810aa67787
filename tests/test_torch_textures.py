"""Textures on BSDFs, vertex colours and normal and bump maps, against
the JAX package:

- ``eval_select`` on a per-lane texture index over a bitmap, a
  checkerboard and a ``mesh_attribute`` (the hit's vertex colour), and
  the BSDFs' textured reflectance, against JAX's ``_apply_textures``;
- ``load_dict`` of every slot and wrapper (a bitmap, checkerboard or
  ``mesh_attribute`` reflectance, ``normalmap`` and ``bumpmap``, a
  ``twosided`` outside or inside them, a textured ``alpha``, a reference
  to a textured BSDF) against JAX's BSDF table, texture list, flags and
  vertex colours; the same scenes from XML (a ``<texture>`` nested in a
  ``<bsdf>``, the wrappers, ``<spectrum>`` values), parsed as JAX parses
  them, and written back by ``dict_to_xml``;
- ``compute_surface_interaction`` on a normal-mapped, vertex-coloured
  box against JAX's.

Tolerances: loader arrays and parsed dicts bit for bit; ``eval_select``
within 1e-6 (the bilinear weights' products round alike, XLA may fuse
them); the surface interaction's ``sh_n``, ``sh_s``, ``sh_t``, ``wi``,
``uv``, ``vcolor``, ``p`` and ``n`` within 1e-5, the FMA rule of
``ROADMAP.md`` queue 3 (XLA may contract the normal map's and the
frame's multiply-adds, PyTorch does not): on these rays the largest
difference is 1.2e-7 and no grazing lane needs leaving out.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
import epsm_mitsuba3_tpu.models.scene as scene_j
from epsm_mitsuba3_tpu.core import xmlparse as XJ
from epsm_mitsuba3_tpu.models import bsdf as BJ
from epsm_mitsuba3_tpu.models.records import Ray as RayJ
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import xmlparse as XT
from epsm_mitsuba3_torch.core.bitmap import write_image
from epsm_mitsuba3_torch.models import bsdf as BT
from epsm_mitsuba3_torch.models import textures as TT
from epsm_mitsuba3_torch.models.records import Ray as RayT
from epsm_mitsuba3_torch.utils import xmlwrite as WT

from test_torch_exp import _assert_scene_equal
from test_torch_intersect import _cornell_rays
from test_torch_render_emitters import plain
from test_torch_xml import _same
from torch_threads import one_torch_thread  # noqa: F401


def write_ply_colored(path, seed=5):
    """A 2 x 2 quad grid in the box's floor plane, with per-vertex colours
    (uchar) and uvs, as binary PLY."""
    r = np.random.default_rng(seed)
    g = np.linspace(-0.8, 0.8, 3, dtype=np.float32)
    x, z = np.meshgrid(g, g)
    v = np.stack([x.ravel(), np.full(9, 0.3, np.float32), z.ravel()], -1)
    uv = np.stack([(x.ravel() + 1) / 2, (z.ravel() + 1) / 2], -1)
    col = r.integers(0, 256, (9, 3)).astype(np.uint8)
    f = np.array([[0, 3, 1], [1, 3, 4], [1, 4, 2], [2, 4, 5], [3, 6, 4],
                  [4, 6, 7], [4, 7, 5], [5, 7, 8]], np.int32)
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 9\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float u\nproperty float v\nproperty uchar red\n"
            "property uchar green\nproperty uchar blue\n"
            "element face 8\nproperty list uchar int vertex_indices\n"
            "end_header\n")
    rows = np.zeros(9, [("p", "<f4", 3), ("uv", "<f4", 2), ("c", "u1", 3)])
    rows["p"], rows["uv"], rows["c"] = v, uv, col
    faces = np.zeros(8, [("n", "u1"), ("i", "<i4", 3)])
    faces["n"], faces["i"] = 3, f
    with open(path, "wb") as fh:
        fh.write(head.encode() + rows.tobytes() + faces.tobytes())


def texture_files(tmp):
    """A reflectance bitmap and a normal map, from a numpy seed."""
    r = np.random.default_rng(21)
    write_image(os.path.join(tmp, "albedo.exr"),
                r.random((24, 32, 3)).astype(np.float32))
    nrm = np.concatenate([0.5 + 0.35 * (r.random((16, 16, 2)) - 0.5),
                          0.8 + 0.2 * r.random((16, 16, 1))], -1)
    write_image(os.path.join(tmp, "normal.exr"), nrm.astype(np.float32))
    write_ply_colored(os.path.join(tmp, "tile.ply"))
    return {k: os.path.join(tmp, f) for k, f in (
        ("albedo", "albedo.exr"), ("normal", "normal.exr"),
        ("ply", "tile.ply"))}


def _bitmap(fn, **kw):
    return {"type": "bitmap", "filename": fn, **kw}


def case_bsdfs(files):
    """Each slot and wrapper the loader takes, as a BSDF dict."""
    diffuse = {"type": "diffuse", "reflectance": {"type": "rgb",
                                                  "value": [0.6, 0.5, 0.4]}}
    return {
        "bitmap": {"type": "diffuse", "reflectance": _bitmap(
            files["albedo"], uv_scale=[2.0, 3.0], uv_offset=0.25)},
        "checkerboard": {"type": "twosided", "bsdf": {
            "type": "diffuse", "reflectance": {
                "type": "checkerboard", "uv_scale": 8.0,
                "color0": [0.9, 0.1, 0.1], "color1": 0.2}}},
        "mesh_attribute": {"type": "diffuse", "reflectance": {
            "type": "mesh_attribute", "name": "vertex_color"}},
        "normalmap": {"type": "normalmap", "normalmap": _bitmap(
            files["normal"]), "bsdf": diffuse},
        "bumpmap": {"type": "bumpmap", "texture": {
            "type": "checkerboard", "color0": [0.6, 0.5, 0.9],
            "color1": [0.4, 0.5, 0.95]}, "nested": {
                "type": "twosided", "material": diffuse}},
        "normalmap textured": {"type": "normalmap", "normalmap": _bitmap(
            files["normal"]), "bsdf": {"type": "diffuse",
                                       "reflectance": _bitmap(
                                           files["albedo"])}},
        "twosided normalmap": {"type": "twosided", "bsdf": {
            "type": "normalmap", "normalmap": _bitmap(files["normal"]),
            "bsdf": diffuse}},
        "textured alpha": {"type": "roughconductor", "alpha": _bitmap(
            files["albedo"])},
        "conductor bitmap": {"type": "roughconductor", "alpha": 0.3,
                             "reflectance": _bitmap(files["albedo"])},
    }


def box_with(bsdf, files, res=8, spp=1, max_depth=3):
    """The JAX Cornell box with the back wall's BSDF ``bsdf``, a colored
    PLY tile on the floor with a ``mesh_attribute`` reflectance, and a
    reference to a textured stand-alone BSDF on the ceiling."""
    box = cornell_box_jax(res=res, spp=spp, max_depth=max_depth)
    d = {"type": "scene", "tex_bsdf": {
        "type": "diffuse", "id": "tiled", "reflectance": {
            "type": "checkerboard", "uv_scale": 4.0}}, **box}
    d["back"]["bsdf"] = bsdf
    d["ceiling"]["bsdf"] = {"type": "ref", "id": "tiled"}
    d["tile"] = {"type": "ply", "filename": files["ply"], "bsdf": {
        "type": "diffuse", "reflectance": {"type": "mesh_attribute",
                                           "name": "vertex_color"}}}
    return d


def assert_textures_equal(st, sj):
    assert [t.kind for t in st.textures] == [t.kind for t in sj.textures]
    for i, (a, b) in enumerate(zip(st.textures, sj.textures)):
        for k in TT.ARRAYS:
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), (i, k)
            if x is not None:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              f"textures.{i}.{k}")
    assert st.static.has_normal_maps == sj.static.has_normal_maps
    assert st.static.has_vertex_colors == sj.static.has_vertex_colors
    np.testing.assert_array_equal(st.vertex_colors.numpy(),
                                  np.asarray(sj.vertex_colors))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return texture_files(str(tmp_path_factory.mktemp("tex")))


CASES = ("bitmap", "checkerboard", "mesh_attribute", "normalmap", "bumpmap",
         "normalmap textured", "twosided normalmap", "textured alpha",
         "conductor bitmap")


@pytest.mark.parametrize("case", CASES)
def test_load_dict_rows_and_flags_equal_jax(case, files):
    """The BSDF table (every column the port keeps, ``reflectance_tex``,
    ``normal_tex`` and the SpatiallyVarying flag among them), the textures
    in JAX's order, the two static flags and the vertex colours."""
    d = box_with(case_bsdfs(files)[case], files)
    st = mt.load_dict(plain(d), device="cpu")
    sj = mi.load_dict(d)
    _assert_scene_equal(st, sj)
    assert_textures_equal(st, sj)
    back = int(st.shape_bsdf[st.static.shape_names.index("back")])
    row = {k: v[back].item() if v[back].numel() == 1 else v[back].tolist()
           for k, v in st.bsdfs.items()}
    textured = case in ("bitmap", "checkerboard", "mesh_attribute",
                        "normalmap textured", "conductor bitmap")
    assert (row["reflectance_tex"] >= 0) == textured
    assert bool(row["flags"] & BT.BSDFFlags.SpatiallyVarying) == textured
    # JAX reads only a normal or bump map that wraps the BSDF directly:
    # under twosided it is lost (ROADMAP.md queue 3)
    assert (row["normal_tex"] >= 0) == (case in (
        "normalmap", "bumpmap", "normalmap textured"))
    if case == "textured alpha":
        assert row["alpha"] == pytest.approx(0.1)
    assert st.static.has_vertex_colors
    assert st.vertex_colors.abs().max() > 0


def test_eval_select_with_vertex_colours_equals_jax(files):
    """A lane's reflectance texture (-1: the row's colour), the mesh
    attribute's lanes the vertex colour: the port's ``eval_select`` and
    ``bsdf._apply_textures`` against JAX's ``_apply_textures``."""
    sj = mi.load_dict(box_with(case_bsdfs(files)["bitmap"], files))
    st = mt.load_dict(plain(box_with(case_bsdfs(files)["bitmap"], files)),
                      device="cpu")
    r = np.random.default_rng(3)
    n = 4096
    nt = len(sj.textures)
    idx = r.integers(-1, nt, n).astype(np.int32)
    uv = r.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    vcol = r.random((n, 3)).astype(np.float32)
    fall = r.random((n, 3)).astype(np.float32)
    pj = {"reflectance_tex": jnp.asarray(idx), "reflectance": jnp.asarray(fall),
          "diffuse_reflectance": jnp.asarray(fall),
          "blend_weight_tex": jnp.full(n, -1, jnp.int32),
          "blend_weight": jnp.full(n, 0.5, jnp.float32)}
    ref = np.asarray(BJ._apply_textures(pj, jnp.asarray(uv), sj.textures,
                                        jnp.asarray(vcol))["reflectance"])
    args = (torch.from_numpy(idx), torch.from_numpy(uv),
            torch.from_numpy(fall), torch.from_numpy(vcol))
    got = TT.eval_select(st.textures, *args).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # by index, only the textures the BSDF slots name: equal values
    got = TT.eval_select(st.bsdf_textures(), *args).numpy()
    named = np.isin(idx, st.static.bsdf_textures) | (idx < 0)
    np.testing.assert_allclose(got[named], ref[named], rtol=0, atol=1e-6)
    kinds = [t.kind for t in st.textures]
    assert set(kinds) == {"bitmap", "checkerboard", "mesh_attribute"}
    ma = idx == kinds.index("mesh_attribute")
    np.testing.assert_array_equal(got[ma], vcol[ma])
    # the BSDF table's lookup on the lanes' slots
    slots = torch.from_numpy(r.integers(-1, len(st.bsdfs["kind"]), n))
    p = BT._apply_textures({"reflectance": st.bsdfs["reflectance"][
        slots.clamp(min=0)]}, st.bsdfs, slots, args[1], st.bsdf_textures(),
        args[3])
    pj = BJ.gather_params(sj.bsdfs, jnp.asarray(slots.numpy()))
    ref = BJ._apply_textures(pj, jnp.asarray(uv), sj.textures,
                             jnp.asarray(vcol))["reflectance"]
    np.testing.assert_allclose(p["reflectance"].numpy(), np.asarray(ref),
                               rtol=0, atol=1e-6)


XML_BOX = """<scene version="3.0.0">
    <sensor type="perspective">
        <transform name="to_world">
            <lookat origin="0, 1, 3.9" target="0, 1, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm"><integer name="width" value="8"/>
            <integer name="height" value="8"/></film>
    </sensor>
    <shape type="rectangle" id="wall">
        <bsdf type="normalmap">
            <texture type="bitmap" name="normalmap">
                <string name="filename" value="normal.exr"/>
            </texture>
            <bsdf type="diffuse">
                <texture type="bitmap" name="reflectance">
                    <string name="filename" value="albedo.exr"/>
                    <float name="uv_scale" value="2"/>
                </texture>
            </bsdf>
        </bsdf>
    </shape>
    <shape type="cube">
        <bsdf type="bumpmap">
            <texture type="checkerboard" name="bumpmap">
                <rgb name="color0" value="0.6, 0.5, 0.9"/>
            </texture>
            <bsdf type="twosided">
                <bsdf type="diffuse">
                    <spectrum name="reflectance"
                              value="400:0.1, 550:0.7, 700:0.3"/>
                </bsdf>
            </bsdf>
        </bsdf>
    </shape>
    <shape type="ply">
        <string name="filename" value="tile.ply"/>
        <bsdf type="diffuse">
            <texture type="mesh_attribute" name="reflectance">
                <string name="name" value="vertex_color"/>
            </texture>
        </bsdf>
    </shape>
    <shape type="rectangle">
        <emitter type="area">
            <spectrum name="radiance" value="400:4, 500:6, 600:5, 700:3"/>
        </emitter>
    </shape>
</scene>"""


def test_xml_forms_load_as_jax(files, monkeypatch):
    """The nested texture, the wrappers and ``<spectrum>`` values: the
    parsed dict equals JAX's, the loaded scene JAX's."""
    base = os.path.dirname(files["ply"])
    ref = {}
    monkeypatch.setattr(scene_j, "load_dict",
                        lambda d: ref.setdefault("d", d))
    XJ.load_string(XML_BOX, base_dir=base)
    monkeypatch.undo()
    got = XT.parse_string(XML_BOX, base_dir=base)
    _same(got, ref["d"])
    st = mt.load_dict(got, device="cpu")
    sj = mi.load_dict(ref["d"])
    _assert_scene_equal(st, sj)
    assert_textures_equal(st, sj)
    assert [t.kind for t in st.textures] == [
        "bitmap", "bitmap", "checkerboard", "mesh_attribute"]
    assert st.static.normal_textures == (0, 2)
    assert st.static.bsdf_textures == (1, 3)


def test_dict_to_xml_round_trips_textures_and_spectra(files, tmp_path):
    """A scene dict with every slot, wrapper and spectrum form written by
    the port's ``dict_to_xml`` and read back loads to the same scene."""
    d = plain(box_with(case_bsdfs(files)["normalmap textured"], files))
    d["left"]["bsdf"] = case_bsdfs(files)["bumpmap"]
    d["right"]["bsdf"]["reflectance"] = {
        "type": "irregular", "value": "420:0.2, 560:0.8, 680:0.4"}
    d["light"]["emitter"]["radiance"] = {
        "type": "regular", "wavelength_min": 400, "wavelength_max": 700,
        "values": [4.0, 6.0, 5.0], "scale": 2.0}
    d["floor"]["bsdf"]["reflectance"] = {
        "type": "irregular", "wavelengths": [400.0, 600.0],
        "values": [0.2, 0.6]}
    path = str(tmp_path / "tex.xml")
    WT.dict_to_xml(d, path)
    back = mt.load_file(path, device="cpu")
    st = mt.load_dict(d, device="cpu")
    for k, v in st.bsdfs.items():
        np.testing.assert_array_equal(back.bsdfs[k].numpy(), v.numpy(), k)
    np.testing.assert_allclose(back.emitters["radiance"].numpy(),
                               st.emitters["radiance"].numpy(), rtol=1e-6)
    assert [t.kind for t in back.textures] == [t.kind for t in st.textures]
    assert back.static.normal_textures == st.static.normal_textures


def test_surface_interaction_with_normal_map_and_vertex_colours(files):
    d = box_with(case_bsdfs(files)["normalmap"], files, res=24)
    d["left"]["bsdf"] = case_bsdfs(files)["bumpmap"]
    sj = mi.load_dict(d)
    st = mt.load_dict(plain(d), device="cpu")
    assert st.static.has_normal_maps and st.static.has_vertex_colors
    o, dd = _cornell_rays(sj)
    si_j = sj.ray_intersect(RayJ.make(jnp.asarray(o), jnp.asarray(dd)))
    si_t = st.ray_intersect(RayT.make(torch.from_numpy(o),
                                      torch.from_numpy(dd)))
    valid = np.asarray(si_j.valid)
    np.testing.assert_array_equal(si_t.valid.numpy(), valid)
    np.testing.assert_array_equal(si_t.bsdf_index.numpy(),
                                  np.asarray(si_j.bsdf_index))
    ntex = st.bsdfs["normal_tex"][si_t.bsdf_index.clamp(min=0)].numpy()
    mapped = valid & (ntex >= 0)
    assert mapped.sum() > 100
    # the perturbation moved the shading normal off the geometric one
    moved = np.abs(si_t.sh_n.numpy() - si_t.n.numpy()).max(-1)
    assert (moved[mapped] > 1e-3).mean() > 0.9
    for f in ("sh_n", "sh_s", "sh_t", "wi", "uv", "vcolor", "p", "n"):
        a = getattr(si_t, f).numpy()[valid]
        b = np.asarray(getattr(si_j, f))[valid]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)
    tile = st.static.shape_names.index("tile")
    on_tile = valid & (si_t.shape_index.numpy() == tile)
    assert on_tile.sum() > 10
    assert np.abs(si_t.vcolor.numpy()[on_tile]).max() > 0
    # a scene without either keeps the plain frame and no colour
    plain_si = mt.load_dict(plain(cornell_box_jax(res=8, spp=1)),
                            device="cpu").ray_intersect(
        RayT.make(torch.from_numpy(o), torch.from_numpy(dd)))
    assert plain_si.vcolor is None
    assert plain_si.detach().vcolor is None

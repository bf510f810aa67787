"""Scenes from files in the port against the JAX package.

``load_dict`` with ``obj``, ``ply`` and ``serialized`` shapes (placed by
rotations and non-uniform scales, with ``face_normals`` and
``flip_normals``), ``disk``, ``cylinder``, ``shapegroup``/``instance``,
``merge``, stand-alone BSDFs with ``ref``s and ``blackbody`` radiance:
every array equal to JAX's ``Scene`` bit for bit, the per-vertex
colours too; unported plugins raise with their name.  The
differentiable normals (``compute_vertex_normals``,
``refresh_smooth_normals``, ``scene_with_vertices``) against JAX's
within 1e-5, and their VJPs against ``jax.vjp`` within 1e-5 of the
largest entry (sums of up to six angle-weighted terms a vertex, in
another order); ``traverse`` and ``update()`` against JAX's.  Two
renders at 16^2 x 4 spp against JAX's, at the tolerance of
``tests/test_torch_render.py``: an XML scene of 84 triangles (K1's
plain version) and a PLY scene of 4,620 (a BVH, the plain K2/K3).
"""
import struct
import zlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.core import xmlparse as XJ
from epsm_mitsuba3_tpu.models.scene import traverse as traverse_j
from epsm_mitsuba3_tpu.ops import normals as NJ
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import xmlparse as XT
from epsm_mitsuba3_torch.models import mesh_io as MT
from epsm_mitsuba3_torch.ops import normals as NT
from epsm_mitsuba3_torch.ops.bvh import ARRAY_FIELDS as BVH_FIELDS
from epsm_mitsuba3_torch.scenes import bumpy_sphere, cornell_box
from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml

from test_torch_exp import _assert_scene_equal
from test_torch_render import assert_images_close, jax_arrays
from torch_threads import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 3


def _assert_same(st, sj):
    _assert_scene_equal(st, sj)
    np.testing.assert_array_equal(st.vertex_colors.numpy(),
                                  np.asarray(sj.vertex_colors))
    assert (st.bvh is None) == (sj.bvh is None)


# -- mesh files on disk -------------------------------------------------------

def write_ply(path, V, F, N=None, colors=None):
    """A binary little-endian PLY of float32 positions, optional normals
    and uchar colours, and int triangles."""
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if N is not None else [])
    head = ["ply", "format binary_little_endian 1.0",
            f"element vertex {len(V)}"]
    head += [f"property float {p}" for p in props]
    if colors is not None:
        head += [f"property uchar {c}" for c in ("red", "green", "blue")]
    head += [f"element face {len(F)}",
             "property list uchar int vertex_indices", "end_header"]
    cols = [("p", "<f4", (len(props),))]
    if colors is not None:
        cols.append(("c", "u1", (3,)))
    rows = np.zeros(len(V), np.dtype(cols))
    rows["p"] = V if N is None else np.concatenate([V, N], -1)
    if colors is not None:
        rows["c"] = colors
    tris = np.zeros(len(F), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    tris["n"], tris["i"] = 3, F
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(rows.tobytes())
        f.write(tris.tobytes())
    return str(path)


def write_obj(path, V, F, uv=None):
    with open(path, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in V)
        if uv is not None:
            f.writelines(f"vt {u} {v}\n" for u, v in uv)
            f.writelines(f"f {a}/{a} {b}/{b} {c}/{c}\n" for a, b, c in F + 1)
        else:
            f.writelines(f"f {a} {b} {c}\n" for a, b, c in F + 1)
    return str(path)


def write_serialized(path, meshes):
    """Mitsuba's serialized format, version 4, float32: one zlib stream a
    mesh (positions and normals), then the offset table."""
    blob, offsets = b"", []
    for i, (V, F, N) in enumerate(meshes):
        body = (struct.pack("<I", 0x0001) + f"m{i}".encode() + b"\x00"
                + struct.pack("<QQ", len(V), len(F))
                + V.astype("<f4").tobytes() + N.astype("<f4").tobytes()
                + F.astype("<u4").tobytes())
        offsets.append(len(blob))
        blob += struct.pack("<HH", 0x041C, 4) + zlib.compress(body)
    blob += struct.pack(f"<{len(offsets)}Q", *offsets)
    blob += struct.pack("<I", len(offsets))
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded meshes on disk: a bumpy sphere as OBJ (with uvs), as PLY
    (normals, colours) and as a two-mesh serialized file."""
    tmp = tmp_path_factory.mktemp("meshes")
    V, F = bumpy_sphere(subdiv=6, radius=0.3, center=(0.0, 0.0, 0.0))
    N = MT.compute_vertex_normals(V, F)
    rng = np.random.default_rng(3)
    colors = rng.integers(0, 256, size=(len(V), 3)).astype(np.uint8)
    V2, F2 = bumpy_sphere(subdiv=4, radius=0.2, center=(0.1, 0.0, 0.0))
    return {
        "obj": write_obj(tmp / "m.obj", V, F, uv=V[:, :2] * 0.5 + 0.5),
        "ply": write_ply(tmp / "m.ply", V, F, N, colors),
        "serialized": write_serialized(
            tmp / "m.serialized",
            [(V, F, N), (V2, F2, MT.compute_vertex_normals(V2, F2))]),
    }


def _box(pkg, res=8, spp=2):
    base = (cornell_box if pkg == "t" else cornell_box_jax)(res=res, spp=spp)
    return base, (mt.ScalarTransform4f if pkg == "t"
                  else mi.ScalarTransform4f)


def _shapes(T, files, case):
    """The scene elements of ``case``, placed with ``T``."""
    place = T.translate([0.1, 0.6, -0.2]).rotate([0, 1, 1], 30).scale(
        [1.0, 0.5, 1.5])
    if case == "obj":
        return {"m": {"type": "obj", "filename": files["obj"],
                      "to_world": place}}
    if case == "ply":
        return {"m": {"type": "ply", "filename": files["ply"],
                      "to_world": place},
                "f": {"type": "ply", "filename": files["ply"],
                      "face_normals": True},
                "g": {"type": "ply", "filename": files["ply"],
                      "flip_normals": True, "to_world": T.scale(0.5)}}
    if case == "serialized":
        return {"m": {"type": "serialized", "filename": files["serialized"],
                      "to_world": place},
                "n": {"type": "serialized", "filename": files["serialized"],
                      "shape_index": 1}}
    if case == "disk_cylinder":
        return {"d": {"type": "disk", "to_world": place},
                "c": {"type": "cylinder", "radius": 0.2, "to_world": place,
                      "flip_normals": True}}
    if case == "instances":
        return {"grp": {"type": "shapegroup", "id": "g",
                        "a": {"type": "cube",
                              "to_world": T.scale(0.1)},
                        "b": {"type": "obj", "filename": files["obj"]}},
                "i1": {"type": "instance", "r": {"type": "ref", "id": "g"},
                       "to_world": place},
                "i2": {"type": "instance", "shapegroup": "g",
                       "to_world": T.translate([0.3, 0.2, 0.0])}}
    if case == "merge_refs":
        return {"gold": {"type": "conductor", "id": "gold",
                         "eta": [0.2, 0.4, 1.4], "k": [3.9, 2.4, 1.8]},
                "glass": {"type": "twosided", "id": "wrap",
                          "bsdf": {"type": "diffuse", "reflectance": 0.3}},
                "mg": {"type": "merge",
                       "a": {"type": "disk", "bsdf": {"type": "ref",
                                                      "id": "gold"}},
                       "b": {"type": "cube", "to_world": T.scale(0.2),
                             "_ref0": {"type": "ref", "id": "wrap"}}},
                "lamp": {"type": "rectangle", "to_world": place,
                         "emitter": {"type": "area", "radiance": {
                             "type": "blackbody", "temperature": 3200.0,
                             "scale": 2e-6}}}}
    raise KeyError(case)


CASES = ("obj", "ply", "serialized", "disk_cylinder", "instances",
         "merge_refs")


@pytest.mark.parametrize("case", CASES)
def test_load_dict_equals_jax(files, case):
    dt, Tt = _box("t")
    dj, Tj = _box("j")
    dt.update(_shapes(Tt, files, case))
    dj.update(_shapes(Tj, files, case))
    st = mt.load_dict(dt, device="cpu")
    sj = mi.load_dict(dj)
    _assert_same(st, sj)
    if case == "ply":
        assert st.vertex_colors.abs().max() > 0


@pytest.mark.parametrize("element,name", [
    ({"type": "rectangle", "emitter": {"type": "my_plugin_light"}},
     "my_plugin_light"),
    ({"type": "rectangle", "emitter": {"type": "area", "radiance": {
        "type": "volume"}}}, "volume"),
    ({"type": "rectangle", "bsdf": {"type": "conductor",
                                    "specular_reflectance": {
                                        "type": "checkerboard"}}},
     "checkerboard"),
    ({"type": "rectangle", "bsdf": {"type": "dielectric",
                                    "specular_transmittance": {
                                        "type": "bitmap",
                                        "filename": "t.png"}}}, "bitmap"),
    ({"type": "rectangle", "interior": {"type": "homogeneous"}},
     "homogeneous"),
    ({"type": "rectangle", "bsdf": {"type": "circular"}}, "circular"),
    ({"type": "rectangle", "emitter": {"type": "area", "radiance": {
        "type": "spectrum", "filename": "d65.spd"}}}, "spectrum"),
    ({"type": "my_plugin_shape"}, "my_plugin_shape"),
    ({"type": "rectangle", "bsdf": {"type": "measured_polarized",
                                    "filename": "brdf.pbsdf"}},
     "measured_polarized"),
])
def test_unported_elements_raise(element, name):
    d, _ = _box("t")
    d["x"] = element
    with pytest.raises(NotImplementedError, match=name):
        mt.load_dict(d, device="cpu")


def test_unknown_references_raise():
    d, _ = _box("t")
    d["x"] = {"type": "rectangle", "bsdf": {"type": "ref", "id": "nope"}}
    with pytest.raises(KeyError, match="nope"):
        mt.load_dict(d, device="cpu")
    d["x"] = {"type": "instance", "shapegroup": "nope"}
    with pytest.raises(ValueError, match="nope"):
        mt.load_dict(d, device="cpu")


# -- differentiable normals ---------------------------------------------------

def _vjp_both(fn_t, fn_j, x, seed=0):
    """Values and the VJPs of a random cotangent, in both packages."""
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = fn_t(xt)
    ct = np.random.default_rng(seed).normal(size=tuple(yt.shape)).astype(
        np.float32)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(ct))
    yj, vjp = jax.vjp(fn_j, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(ct))
    return (yt.detach().numpy(), np.asarray(yj)), (gt.numpy(),
                                                   np.asarray(gj))


def _close_vjp(gt, gj):
    np.testing.assert_allclose(gt, gj, rtol=0,
                               atol=1e-5 * np.abs(gj).max())


def test_compute_vertex_normals_and_vjp_equal_jax():
    V, F = bumpy_sphere(subdiv=8)
    F = np.concatenate([F, [[0, 0, 1]]]).astype(np.int32)   # degenerate
    V = np.concatenate([V, [[5.0, 5.0, 5.0]]]).astype(np.float32)  # unused
    (yt, yj), (gt, gj) = _vjp_both(
        lambda v: NT.compute_vertex_normals(v, torch.from_numpy(F)),
        lambda v: NJ.compute_vertex_normals(v, jnp.asarray(F)), V)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
    assert np.all(yt[-1] == 0)
    _close_vjp(gt, gj)
    assert np.abs(gj).max() > 1e-2


@pytest.fixture(scope="module")
def ply_scenes(files):
    """The box with the PLY sphere (normals) and the serialized one."""
    dt, Tt = _box("t")
    dj, Tj = _box("j")
    dt.update(_shapes(Tt, files, "serialized"))
    dj.update(_shapes(Tj, files, "serialized"))
    return mt.load_dict(dt, device="cpu"), mi.load_dict(dj)


@pytest.mark.parametrize("masked", [False, True])
def test_refresh_smooth_normals_and_vjp_equal_jax(ply_scenes, masked):
    """Moved vertices: the smooth rows recomputed (the walls' stored
    normals are smooth too, the flipped orientation kept), masked to
    shape ``m`` or not."""
    st, sj = ply_scenes
    idx = list(st.static.shape_names).index("m")
    s, c = st.static.vertex_ranges[idx]
    rows = np.zeros(st.vertices.shape[0], bool)
    rows[s:s + c] = True
    v0 = st.vertices.numpy()
    shift = (np.random.default_rng(1).normal(size=v0.shape) * 0.02).astype(
        np.float32)

    def port(v):
        return NT.refresh_smooth_normals(
            replace(st, vertices=v),
            torch.from_numpy(rows) if masked else None).normals

    def ref(v):
        return NJ.refresh_smooth_normals(
            sj.replace(vertices=v),
            jnp.asarray(rows) if masked else None).normals

    (yt, yj), (gt, gj) = _vjp_both(port, ref, v0 + shift)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
    _close_vjp(gt, gj)
    if masked:
        np.testing.assert_array_equal(yt[~rows], st.normals.numpy()[~rows])


def test_scene_with_vertices_refits_and_equals_jax(bvh_scenes):
    """A BVH scene: new positions, their normals (1e-5 of JAX's), the
    tree refit and the K2/K3 records re-packed, as ``set_vertices``
    gives them."""
    st, sj = bvh_scenes
    v = st.vertices * 1.01 + 0.003
    sc = NT.scene_with_vertices(st, v)
    ref = NJ.scene_with_vertices(sj, jnp.asarray(v.numpy()))
    np.testing.assert_allclose(sc.normals.numpy(), np.asarray(ref.normals),
                               rtol=0, atol=1e-5)
    fresh = st.set_vertices(v)
    for k in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(sc.bvh, k).numpy(),
                                      np.asarray(getattr(ref.bvh, k)), k)
    assert torch.equal(sc.bvh_nodes, fresh.bvh_nodes)
    assert torch.equal(sc.bvh_tris_k, fresh.bvh_tris_k)


# -- traverse -----------------------------------------------------------------

def test_traverse_update_equals_jax(ply_scenes):
    st, sj = ply_scenes
    pt, pj = mt.traverse(st), traverse_j(sj)
    assert pt.keys() == pj.keys()
    assert "light.emitter.radiance.value" in pt and "x.alpha" not in pt
    m_s, m_c = st.static.vertex_ranges[st.static.shape_names.index("m")]
    n_s, n_c = st.static.vertex_ranges[st.static.shape_names.index("n")]
    rng = np.random.default_rng(4)
    vm = st.vertices.numpy()[m_s:m_s + m_c] + rng.normal(
        size=(m_c, 3)).astype(np.float32) * 0.01
    vn = st.vertices.numpy()[n_s:n_s + n_c] + 0.05
    nn = rng.normal(size=(n_c, 3)).astype(np.float32)
    writes = {"m.vertex_positions": vm, "n.vertex_positions": vn,
              "n.vertex_normals": nn,
              "floor.bsdf.reflectance.value": [0.1, 0.2, 0.3],
              "m.bsdf.alpha": 0.3,
              "light.emitter.radiance.value": [5.0, 6.0, 7.0],
              "sensor[0].to_world": np.eye(4, dtype=np.float32) + 0.01}
    for k, v in writes.items():
        pt[k] = torch.tensor(np.asarray(v, np.float32))
        pj[k] = jnp.asarray(np.asarray(v, np.float32))
    assert torch.equal(pt["m.bsdf.alpha"], torch.tensor(0.3))
    ut, uj = pt.update(), pj.update()
    assert pt.scene is ut and pt._pending == {}
    ref = jax_arrays(uj)
    for k in ("vertices", "uvs", "faces"):
        np.testing.assert_array_equal(getattr(ut, k).numpy(), ref[k], k)
    np.testing.assert_allclose(ut.normals.numpy(), ref["normals"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(ut.normals[n_s:n_s + n_c].numpy(), nn)
    for k, v in ut.bsdfs.items():
        np.testing.assert_array_equal(
            v.numpy(), ref[f"bsdfs.{k}"].astype(v.numpy().dtype), k)
    np.testing.assert_array_equal(ut.emitters["radiance"].numpy(),
                                  ref["emitters.radiance"])
    np.testing.assert_array_equal(ut.sensors[0].to_world.numpy(),
                                  ref["sensors.0.to_world"])
    moved = (ut.normals - st.normals).abs().amax(-1) > 0
    assert bool(moved[m_s:m_s + m_c].any())
    assert not bool(moved[:m_s].any())


def test_update_is_differentiable(ply_scenes):
    """autograd reaches the tensors written into the parameters, the
    positions through the refreshed normals too."""
    st, _ = ply_scenes
    p = mt.traverse(st)
    v = p["m.vertex_positions"].clone().requires_grad_(True)
    r = torch.tensor([0.4, 0.5, 0.6], requires_grad=True)
    p["m.vertex_positions"] = v * 1.0
    p.update({"floor.bsdf.reflectance.value": r})
    sc = p.scene
    w = torch.linspace(0.5, 1.5, sc.normals.numel()).reshape(
        sc.normals.shape)
    gn, gr = torch.autograd.grad((sc.normals * w).sum()
                                 + sc.bsdfs["reflectance"].sum(), (v, r))
    assert gn.abs().max() > 0 and torch.equal(gr, torch.ones(3))


def test_update_refits_the_bvh(bvh_scenes):
    st, _ = bvh_scenes
    p = mt.traverse(st)
    p["blob.vertex_positions"] = p["blob.vertex_positions"] + 0.05
    sc = p.update()
    fresh = sc.set_vertices(sc.vertices.clone())
    assert torch.equal(sc.bvh_nodes, fresh.bvh_nodes)
    assert not torch.equal(sc.bvh_nodes, st.bvh_nodes)


# -- renders of loaded scenes -------------------------------------------------

@pytest.fixture(scope="module")
def xml_scenes(tmp_path_factory, files):
    """The Cornell box written by ``dict_to_xml`` with the OBJ sphere
    named relative to the XML (84 triangles)."""
    tmp = tmp_path_factory.mktemp("xml")
    d = cornell_box(res=RES, spp=SPP, max_depth=DEPTH)
    d["ball"] = {"type": "obj", "filename": "m.obj",
                 "to_world": mt.ScalarTransform4f.translate([0.2, 0.5, 0.1]),
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "rgb", "value": [0.6, 0.5, 0.3]}}}
    dict_to_xml(d, str(tmp / "scene.xml"))
    (tmp / "m.obj").write_bytes(open(files["obj"], "rb").read())
    path = str(tmp / "scene.xml")
    return XT.load_file(path, device="cpu"), XJ.load_file(path)


@pytest.fixture(scope="module")
def bvh_scenes(tmp_path_factory):
    """The box with a bumpy sphere of 4,608 triangles (vertex normals) as
    a binary PLY: 4,620 triangles in all, so both packages build a
    BVH."""
    tmp = tmp_path_factory.mktemp("ply")
    V, F = bumpy_sphere(subdiv=48)
    path = write_ply(tmp / "blob.ply", V, F, MT.compute_vertex_normals(V, F))
    dt = cornell_box(res=RES, spp=SPP, max_depth=DEPTH)
    dj = cornell_box_jax(res=RES, spp=SPP, max_depth=DEPTH)
    for d in (dt, dj):
        d["blob"] = {"type": "ply", "filename": path, "bsdf": {
            "type": "diffuse", "reflectance": {"type": "rgb",
                                               "value": [0.55, 0.45, 0.3]}}}
    return mt.load_dict(dt, device="cpu"), mi.load_dict(dj)


@pytest.mark.parametrize("case", ["xml_scenes", "bvh_scenes"])
def test_loaded_scene_renders_as_jax(request, case):
    st, sj = request.getfixturevalue(case)
    _assert_same(st, sj)
    if case == "bvh_scenes":
        assert st.faces.shape[0] == 4620 and st.bvh is not None
        for k in BVH_FIELDS:
            np.testing.assert_array_equal(getattr(st.bvh, k).numpy(),
                                          np.asarray(getattr(sj.bvh, k)), k)
    else:
        assert st.faces.shape[0] == 84 and st.bvh is None
    img = mt.render(st, spp=SPP, seed=0, device="cpu").numpy()
    ref = np.asarray(mi.render(sj, spp=SPP, seed=0))
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
    assert_images_close(img, ref)

"""The port's experiment configs (``app/exp``) against the JAX package's:
each ``make`` at a small size builds the scene JAX's ``load_dict`` builds
(vertices, faces, normals, every BSDF column, bit for bit), with the same
budgets and thetas, and ``apply`` gives the same scene at the initial and
the target theta; ``shadow``'s ``apply`` moves its spheres with one
``set_vertices``; the branches that load files raise; and three
iterations of ``run("manifold_caustic")`` on ``glossyball``, whose theta
has two leaves (a translation and the roughness), track JAX's with both
packages' matcher answering one fixed OT gradient (``tests/
test_torch_optim.py`` gives the reason), within 1e-3 of theta's largest
entry.
"""
import importlib

import numpy as np
import pytest
import torch

import epsm_mitsuba3_tpu.app.optim as optim_j

from epsm_mitsuba3_torch.app import optim as optim_t
from epsm_mitsuba3_torch.models import scene as scene_t
from epsm_mitsuba3_torch.models.scene import GEOMETRY_FIELDS

from test_torch_render import jax_arrays
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(resolution=16, spp=2, match_res=8)
CONFIGS = {"egg": {}, "glossyball": {}, "highlight": {},
           "shadow": {"n_objects": 16}, "bunny": {}, "bathroom": {},
           "bedroom": {}, "glassslab": {}}
BUDGETS = ("it", "spp", "resolution", "thres", "max_depth", "match_res")


def _modules(name):
    return (importlib.import_module(f"epsm_mitsuba3_tpu.app.exp.{name}"),
            importlib.import_module(f"epsm_mitsuba3_torch.app.exp.{name}"))


def _assert_scene_equal(st, sj, normals_atol=0.0):
    ref = jax_arrays(sj)
    for k in GEOMETRY_FIELDS:
        if k == "normals" and normals_atol:
            np.testing.assert_allclose(st.normals.numpy(), ref[k], rtol=0,
                                       atol=normals_atol, err_msg=k)
            continue
        np.testing.assert_array_equal(getattr(st, k).numpy(), ref[k], k)
    for k, v in st.bsdfs.items():
        np.testing.assert_array_equal(
            v.numpy(), ref[f"bsdfs.{k}"].astype(v.numpy().dtype), k)
    for k, v in st.emitters.items():
        np.testing.assert_array_equal(v.numpy(), ref[f"emitters.{k}"], k)
    for i, s in enumerate(st.sensors):
        np.testing.assert_array_equal(s.to_world.numpy(),
                                      ref[f"sensors.{i}.to_world"])
        assert (s.width, s.height, s.fov_x) == (
            sj.sensors[i].width, sj.sensors[i].height, sj.sensors[i].fov_x)
    for f in ("shape_names", "vertex_ranges", "bsdf_kinds", "spp",
              "emitter_kinds"):
        assert getattr(st.static, f) == getattr(sj.static, f), f
    assert dict(st.static.integrator) == dict(sj.static.integrator)
    if sj.bvh is not None:
        assert st.bvh is not None and st.bvh_nodes is not None


@pytest.fixture(scope="module", params=list(CONFIGS))
def made(request):
    name = request.param
    mod_j, mod_t = _modules(name)
    kw = dict(SMALL, **CONFIGS[name])
    return name, mod_j.make(**kw), mod_t.make(device="cpu", **kw)


def test_make_matches_jax(made):
    name, ej, et = made
    _assert_scene_equal(et["scene"], ej["scene"])
    for k in BUDGETS:
        assert et[k] == ej[k], k
    for which in ("init_theta", "target_theta"):
        assert set(et[which]) == set(ej[which])
        for k, v in et[which].items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(ej[which][k]), k)
    assert et["output"](et["init_theta"]) == ej["output"](ej["init_theta"])


@pytest.mark.parametrize("which", ["init_theta", "target_theta"])
def test_apply_matches_jax(made, which):
    """``apply`` at a theta: the moved vertices (and glossyball's clamped
    roughness) equal JAX's bit for bit, and a BVH scene's records are
    re-packed from them.  glassslab's renormalised normals: within 2 ulp
    of 1 (XLA's rsqrt and PyTorch's 1/sqrt round apart)."""
    name, ej, et = made
    sj = ej["apply"](ej["scene"], ej[which])
    st = et["apply"](et["scene"], et[which])
    _assert_scene_equal(st, sj, 2.4e-7 if name == "glassslab" else 0.0)
    if st.bvh is not None:
        fresh = st.set_vertices(st.vertices.clone())
        assert torch.equal(fresh.bvh_nodes, st.bvh_nodes)


def test_apply_is_differentiable(made):
    """Every theta leaf reaches the scene: the gradient of a weighted sum
    of the moved vertices and the roughness column is finite and non-zero
    for each leaf."""
    name, _, et = made
    theta = {k: v.clone().requires_grad_(True)
             for k, v in et["init_theta"].items()}
    sc = et["apply"](et["scene"], theta)
    w = torch.linspace(0.5, 1.5, sc.vertices.numel()).reshape(
        sc.vertices.shape)
    loss = ((sc.vertices * w).sum() + (sc.normals * w).sum()
            + sc.bsdfs["alpha"].sum())
    grads = torch.autograd.grad(loss, list(theta.values()))
    for k, g in zip(theta, grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0, (name, k)


def test_shadow_apply_refits_once(monkeypatch):
    """``shadow``'s apply moves all its spheres with one set_vertices (one
    refit and one re-pack of the tree), as the reference does."""
    from epsm_mitsuba3_torch.app.exp import shadow
    exp = shadow.make(device="cpu", n_objects=9, **SMALL)
    calls = []
    orig = scene_t.Scene.set_vertices

    def counted(self, v):
        calls.append(v.shape)
        return orig(self, v)

    monkeypatch.setattr(scene_t.Scene, "set_vertices", counted)
    sc = exp["apply"](exp["scene"], exp["init_theta"])
    assert len(calls) == 1
    moved = (sc.vertices - exp["scene"].vertices).abs().amax(-1) > 0
    s, c = exp["scene"].static.vertex_ranges[2]      # ball0
    assert bool(moved[s:s + c].all()) and not bool(moved[:s].any())


def test_file_branches_raise(tmp_path):
    """The reference's file-loading branches load the file they are
    given: a truncated PLY or a missing scene raises, naming it, rather
    than build a stand-in."""
    from epsm_mitsuba3_torch.app.exp import bathroom, bedroom, bunny
    ply = tmp_path / "bunny.ply"
    ply.write_text("ply\n")
    with pytest.raises(ValueError, match="bunny.ply"):
        bunny.make(device="cpu", mesh_path=str(ply), **SMALL)
    for mod in (bathroom, bedroom):
        with pytest.raises(FileNotFoundError, match="scene.xml"):
            mod.make(device="cpu", scene_path="scene.xml", **SMALL)


def _room_xml(path, n_obj):
    """A room for bathroom/bedroom's ``scene_path``: the Cornell box, its
    light, and ``n_obj`` cubes named obj0... (by their ids)."""
    from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
    from epsm_mitsuba3_torch.scenes import cornell_box
    from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml
    d = cornell_box(res=SMALL["resolution"], spp=SMALL["spp"])
    for i in range(n_obj):
        d[f"obj{i}"] = {"type": "cube", "id": f"obj{i}",
                        "to_world": T.translate([-0.6 + 0.17 * i, 0.1,
                                                 0.1 * (i % 3)]).scale(0.08)}
    dict_to_xml(d, str(path))
    return str(path)


@pytest.mark.parametrize("name", ["bunny", "bathroom", "bedroom"])
def test_file_branches_match_jax(tmp_path, name):
    """bunny with a PLY (a bumpy sphere with normals) and bathroom /
    bedroom with an XML room: ``make`` builds JAX's scene, budgets and
    thetas, and ``apply`` moves the named shapes as JAX's does."""
    from epsm_mitsuba3_torch.models import mesh_io
    from epsm_mitsuba3_torch.scenes import bumpy_sphere
    from test_torch_scene_files import write_ply
    mod_j, mod_t = _modules(name)
    if name == "bunny":
        V, F = bumpy_sphere(subdiv=10, radius=0.4, center=(0.0, 0.0, 0.0))
        kw = {"mesh_path": write_ply(tmp_path / "bunny.ply", V, F,
                                     mesh_io.compute_vertex_normals(V, F))}
    else:
        kw = {"scene_path": _room_xml(tmp_path / "room.xml",
                                      8 if name == "bathroom" else 2)}
    ej, et = mod_j.make(**SMALL, **kw), mod_t.make(device="cpu", **SMALL,
                                                    **kw)
    _assert_scene_equal(et["scene"], ej["scene"])
    if name == "bunny":
        assert et["scene"].faces.shape[0] == 10 + 2 + 200   # walls, light
    for k in BUDGETS:
        assert et[k] == ej[k], k
    for k, v in et["init_theta"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(ej["init_theta"][k]), k)
    _assert_scene_equal(et["apply"](et["scene"], et["init_theta"]),
                        ej["apply"](ej["scene"], ej["init_theta"]))


GLOSSY = dict(resolution=16, spp=2, match_res=16)


@pytest.fixture
def fixed_glossy_matchers(monkeypatch):
    """Both packages' Matcher answering every call with one seeded OT
    gradient (16^2, 5)."""
    import jax.numpy as jnp
    field = (np.random.default_rng(8).normal(size=(16 * 16, 5)) * 0.05
             ).astype(np.float32)

    class FixedJ:
        def __init__(self, res, **_):
            pass

        def match_Sinkhorn(self, render_rgb, gt_rgb):
            return jnp.asarray(field)

    class FixedT(FixedJ):
        def match_Sinkhorn(self, render_rgb, gt_rgb):
            return torch.from_numpy(field.copy())

    monkeypatch.setattr(optim_j, "Matcher", FixedJ)
    monkeypatch.setattr(optim_t, "Matcher", FixedT)


def test_run_glossyball_tracks_jax(fixed_glossy_matchers):
    """``run`` with a theta of two leaves, the translation (2,) and the
    roughness (): three manifold_caustic iterations on glossyball at 16^2
    x 2 spp, depth 2, Adam at lr 0.05; the roughness stays clamped in
    apply and moves."""
    mod_j, mod_t = _modules("glossyball")
    exp_j = mod_j.make(it=3, **GLOSSY)
    exp_t = mod_t.make(it=3, device="cpu", **GLOSSY)
    exp_j["gt_spp"] = exp_t["gt_spp"] = 4
    _, hist_j = optim_j.run("manifold_caustic", exp_j, verbose=False,
                            adam_lr=0.05)
    losses = []
    _, hist_t = optim_t.run("manifold_caustic", exp_t, adam_lr=0.05,
                            log=lambda it, loss, theta: losses.append(loss))

    def flat(h):
        return np.asarray([np.concatenate([np.ravel(x[k]) for k in
                                           ("trans", "alpha")]) for x in h])

    th_j, th_t = flat(hist_j), flat(hist_t)
    assert th_t.shape == th_j.shape == (3, 3)
    assert np.isfinite(losses).all()
    for it in range(3):
        np.testing.assert_allclose(th_t[it], th_j[it], rtol=0,
                                   atol=1e-3 * np.abs(th_j[it]).max(),
                                   err_msg=f"iteration {it}")
    assert np.abs(th_t[-1] - np.float32([0.3, 0.1, 0.4])).min() > 0.01


SLAB = dict(resolution=32, spp=4, match_res=32)


@pytest.fixture(scope="module")
def slab_runs():
    """Three ``run("manifold_caustic")`` iterations of glassslab at 32^2 x
    4 spp (depth 4, the published), ground truth 4 spp, Adam at lr 0.01,
    in both packages, both matchers answering one seeded OT gradient
    (32^2, 5); each iteration's gradient is kept.  One pass an
    iteration: the first iteration's gradient is one manifold_caustic
    pass's."""
    field = (np.random.default_rng(21).normal(size=(32 * 32, 5)) * 0.05
             ).astype(np.float32)
    import jax.numpy as jnp
    mod_j, mod_t = _modules("glassslab")
    exp_j = mod_j.make(it=3, **SLAB)
    exp_t = mod_t.make(it=3, device="cpu", **SLAB)
    exp_j["gt_spp"] = exp_t["gt_spp"] = 4
    grads = {"j": [], "t": []}

    class FixedJ:
        def __init__(self, res, **_):
            pass

        def match_Sinkhorn(self, render_rgb, gt_rgb):
            return jnp.asarray(field)

    class FixedT(FixedJ):
        def match_Sinkhorn(self, render_rgb, gt_rgb):
            return torch.from_numpy(field.copy())

    def keep(cls, key):
        step = cls.step

        def recorded(self, g):
            grads[key].append(np.asarray(g["normal_field"]).copy())
            return step(self, g)
        return recorded

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(optim_j, "Matcher", FixedJ)
        mp.setattr(optim_t, "Matcher", FixedT)
        mp.setattr(optim_j.Adam, "step", keep(optim_j.Adam, "j"))
        mp.setattr(optim_t.Adam, "step", keep(optim_t.Adam, "t"))
        _, hist_j = optim_j.run("manifold_caustic", exp_j, verbose=False)
        _, hist_t = optim_t.run("manifold_caustic", exp_t)
    finally:
        mp.undo()
    return ([h["normal_field"] for h in hist_j],
            [h["normal_field"] for h in hist_t], grads,
            np.asarray(exp_j["init_theta"]["normal_field"]))


def test_glassslab_gradient_matches_jax(slab_runs):
    """One manifold_caustic pass's normal_field gradient (289, 2): within
    1e-3 relative L2 of JAX's, and non-zero."""
    _, _, grads, _ = slab_runs
    gj, gt = grads["j"][0], grads["t"][0]
    assert np.isfinite(gt).all() and np.abs(gj).max() > 0
    err = np.linalg.norm(gt - gj) / np.linalg.norm(gj)
    assert err <= 1e-3, err


def test_run_glassslab_tracks_jax(slab_runs):
    """Three iterations: theta (the normal field) within 1e-3 of its
    largest entry of JAX's after each, and moved."""
    th_j, th_t, _, init = slab_runs
    assert len(th_t) == len(th_j) == 3
    for it in range(3):
        np.testing.assert_allclose(th_t[it], th_j[it], rtol=0,
                                   atol=1e-3 * np.abs(th_j[it]).max(),
                                   err_msg=f"iteration {it}")
    assert np.abs(th_t[-1] - init).max() > 1e-3

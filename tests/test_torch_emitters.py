"""The port's emitters and what they read, against the JAX package's on
the same inputs made from a numpy seed: the sphere, hemisphere and cone
warps, ``distr`` and ``distr2d``, the bitmap and checkerboard textures,
and for each of the eight emitter kinds ``sample_direction``,
``pdf_direction``, ``eval_hit`` and ``eval_env`` on the same table
(loaded by both packages from one scene dict), points and samples.

Tolerances, each with its reason:

- integer and boolean outputs (picked emitter, texel, delta, the
  dispatch): equal, but for the envmap lanes below;
- floats: rtol 1e-5, atol 1e-6.  Both packages run the same operations
  in the same order (JAX called op by op, not under jit), but their
  ``sin``, ``cos``, ``atan2`` and ``acos`` are other implementations,
  a few ulp apart;
- far lights put their point 1e5 away: ``ds.p`` within 1e-5 relative of
  that distance;
- the spot's weight within 1e-5 of its largest entry: its falloff
  divides the cosine's rounding by the beam and cutoff cosines'
  difference (0.08 here), which lanes at the cone's edge show relative
  to their small weight;
- the envmap's texel choice: JAX sums its row and column CDFs with XLA's
  ``cumsum``, the port with PyTorch's, and the two orders can round an
  entry 1 ulp apart; a lane whose uniform falls on such an entry picks
  the neighbouring texel.  Such lanes are counted (at most 0.1 %) and the
  rest held as above.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from epsm_mitsuba3_tpu.core import distr as DJ
from epsm_mitsuba3_tpu.core import distr2d as D2J
from epsm_mitsuba3_tpu.core import warp as WJ
from epsm_mitsuba3_tpu.models import emitters as EJ
from epsm_mitsuba3_tpu.models import textures as TJ

from epsm_mitsuba3_torch.core import distr as DT
from epsm_mitsuba3_torch.core import distr2d as D2T
from epsm_mitsuba3_torch.core import warp as WT
from epsm_mitsuba3_torch.core.bitmap import write_image
from epsm_mitsuba3_torch.models import emitters as ET
from epsm_mitsuba3_torch.models import textures as TT

from test_torch_render import port_scene_of

N = 8192
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, ref, name, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, name)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# warps, distr, distr2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sphere", "hemisphere", "cone"])
def test_warps_match_jax(name):
    r = np.random.default_rng(1)
    s = r.random((N, 2)).astype(np.float32)
    s[:4] = [[0, 0], [1 - 2 ** -24, 1 - 2 ** -24], [0.5, 0.5], [0, 1]]
    if name == "cone":
        cc = r.uniform(-0.5, 0.99, N).astype(np.float32)
        got = WT.square_to_uniform_cone(_t(s), _t(cc))
        ref = WJ.square_to_uniform_cone(jnp.asarray(s), jnp.asarray(cc))
        _close(WT.square_to_uniform_cone_pdf(_t(cc)),
               WJ.square_to_uniform_cone_pdf(jnp.asarray(cc)), "pdf")
    else:
        got = getattr(WT, f"square_to_uniform_{name}")(_t(s))
        ref = getattr(WJ, f"square_to_uniform_{name}")(jnp.asarray(s))
        _close(getattr(WT, f"square_to_uniform_{name}_pdf")(got),
               getattr(WJ, f"square_to_uniform_{name}_pdf")(ref), "pdf")
    _close(got, ref, name)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-6)


def test_distr_matches_jax():
    """``build_cdf`` within the cumsum's rounding; ``sample_discrete``
    (shared and batched CDF) and ``sample_reuse`` fed JAX's CDF: equal."""
    r = np.random.default_rng(2)
    pmf = r.random((64, 40)).astype(np.float32)
    pmf[:, 5:9] = 0.0                    # empty bins
    pmf[3] = 0.0                         # an all-zero row
    cdf_j, tot_j = DJ.build_cdf(jnp.asarray(pmf))
    cdf_t, tot_t = DT.build_cdf(_t(pmf))
    _close(cdf_t, cdf_j, "cdf", rtol=2e-7, atol=2e-7)
    _close(tot_t, tot_j, "total", rtol=2e-7)
    cdf = np.asarray(cdf_j)
    u = r.random(64).astype(np.float32)
    u[:3] = [0.0, cdf[0, 10], 1 - 2 ** -24]     # on an entry, the ends
    for c, uu in ((cdf[0], u), (cdf, u)):
        idx_j, pmf_j = DJ.sample_discrete(jnp.asarray(c), jnp.asarray(uu))
        idx_t, pmf_t = DT.sample_discrete(_t(c), _t(uu))
        _close(idx_t, idx_j, "index")
        _close(pmf_t, pmf_j, "pmf", rtol=0, atol=0)
        i_j, p_j, r_j = DJ.sample_reuse(jnp.asarray(c), jnp.asarray(uu))
        i_t, p_t, r_t = DT.sample_reuse(_t(c), _t(uu))
        _close(i_t, i_j, "reuse index")
        _close(r_t, r_j, "reused u", rtol=0, atol=0)


def _flip_lanes(table):
    """Lanes whose uniform lies within 2 ulp of an entry of ``table``
    (any row): where two cumsum orders can pick neighbouring bins."""
    flat = np.sort(np.asarray(table).reshape(-1))

    def near(u):
        i = np.clip(np.searchsorted(flat, u), 1, len(flat) - 1)
        gap = np.minimum(np.abs(flat[i] - u), np.abs(flat[i - 1] - u))
        return gap <= 2 * np.spacing(np.maximum(np.abs(u), 1e-30))
    return near


@pytest.mark.parametrize("cls", ["Marginal2D", "Hierarchical2D"])
def test_distr2d_matches_jax(cls):
    r = np.random.default_rng(3)
    w = (r.random((24, 48)) ** 3).astype(np.float32)
    w[5] = 0.0                                   # a row of zero weight
    s = r.random((N, 2)).astype(np.float32)
    dj = getattr(D2J, cls)(jnp.asarray(w))
    dt = getattr(D2T, cls)(_t(w))
    _close(dt.row_cdf, dj.row_cdf, "row cdf", rtol=1e-6, atol=1e-7)
    _close(dt.col_cdf, dj.col_cdf, "col cdf", rtol=1e-6, atol=1e-7)
    uv_j, pdf_j = dj.sample(jnp.asarray(s))
    uv_t, pdf_t = dt.sample(_t(s))
    same = np.all(uv_t.numpy() == np.asarray(uv_j), axis=-1)
    assert (~same).mean() <= 1e-3, (~same).sum()
    _close(uv_t[same], np.asarray(uv_j)[same], "uv", rtol=0, atol=0)
    _close(pdf_t[same], np.asarray(pdf_j)[same], "pdf", rtol=1e-6)
    _close(dt.pdf(uv_t), dj.pdf(jnp.asarray(uv_t.numpy())), "pdf(uv)",
           rtol=1e-6)


def test_bisection_equals_compare_sum():
    """``bisect_rows`` (the port's column search) against the reference's
    compare-sum over each lane's gathered row: equal counts, on rows with
    plateaus, zeros, an all-equal row, a width that is no power of two,
    and uniforms that fall on entries, at 0 and near 1."""
    r = np.random.default_rng(4)
    for w in (1, 2, 7, 64, 1000):
        raw = np.floor(r.random((33, w)) * 4) / 4      # repeats and zeros
        raw[0] = 0.0
        raw[1] = 1.0
        tab = np.cumsum(raw, 1).astype(np.float32)
        tab /= np.maximum(tab[:, -1:], 1e-30)
        rows = r.integers(0, 33, 4096)
        u = r.random(4096).astype(np.float32)
        u[:2048] = tab[rows[:2048], r.integers(0, w, 2048)]   # on entries
        u[2048:2052] = [0.0, 1.0, 1 - 2 ** -24, 0.5]
        ref = np.sum(tab[rows] <= u[:, None], -1)
        got = D2T.bisect_rows(_t(tab), _t(rows), _t(u)).numpy()
        np.testing.assert_array_equal(got, ref, f"width {w}")


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------

def _uv(r, n=N):
    """uv inside, outside and on the edges of the unit square (the wrap
    and the floor-mod of negative texel indices)."""
    uv = r.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    uv[:6] = [[0, 0], [1, 1], [-0.0, 0.5], [0.999999, 0.5], [-1e-7, 0.3],
              [0.5, -2.0]]
    return uv


def _textures(r):
    data = r.random((9, 13, 3)).astype(np.float32)
    return {
        "bitmap": (TJ.bitmap(data), TT.bitmap(data, device="cpu")),
        "bitmap uv": (TJ.bitmap(data, (2.0, 0.5), (0.25, -0.5)),
                      TT.bitmap(data, (2.0, 0.5), (0.25, -0.5),
                                device="cpu")),
        "checkerboard": (TJ.checkerboard([1, 0.1, 0.1], [0.1, 0.1, 1],
                                         (4.0, 3.0), (0.5, 0.0)),
                         TT.checkerboard([1, 0.1, 0.1], [0.1, 0.1, 1],
                                         (4.0, 3.0), (0.5, 0.0),
                                         device="cpu"))}


@pytest.mark.parametrize("name", ["bitmap", "bitmap uv", "checkerboard"])
def test_eval_one_matches_jax(name):
    r = np.random.default_rng(5)
    tj, tt = _textures(r)[name]
    uv = _uv(r)
    _close(TT.eval_one(tt, _t(uv)), TJ.eval_one(tj, jnp.asarray(uv)), name)


def test_eval_select_matches_jax():
    """Per-lane texture index, -1 taking the fallback."""
    r = np.random.default_rng(6)
    texs = list(_textures(r).values())
    uv = _uv(r)
    idx = r.integers(-1, 3, N).astype(np.int32)
    fb = r.random((N, 3)).astype(np.float32)
    ref = TJ.eval_select([a for a, _ in texs], jnp.asarray(idx),
                         jnp.asarray(uv), jnp.asarray(fb))
    got = TT.eval_select([b for _, b in texs], _t(idx), _t(uv), _t(fb))
    _close(got, ref, "eval_select")


def test_unported_textures_raise():
    """The volume texture, and a kind no one registered
    (``register_texture`` adds kinds), raise by name."""
    with pytest.raises(NotImplementedError, match="volume"):
        TT.volume3d(np.zeros((2, 2, 2, 3)), np.eye(4))
    with pytest.raises(NotImplementedError, match="never_registered"):
        TT.eval_one(TT.Texture(kind="never_registered"),
                    torch.zeros((1, 2)))


# ---------------------------------------------------------------------------
# the eight emitter kinds on one table
# ---------------------------------------------------------------------------

KINDS = ("area", "point", "constant", "envmap", "directional", "spot",
         "projector", "directionalarea")


def all_kinds_scene(tmp, envmap_hw=(16, 32)):
    """The Cornell box with its area light, a directionalarea panel and
    one light of every other kind (two projectors: a bitmap and a
    checkerboard), all made from a numpy seed; the envmap and the
    projector's bitmap are EXR files in ``tmp``."""
    from scenes import cornell_box
    r = np.random.default_rng(7)
    env = (r.random((*envmap_hw, 3)) ** 4 * 4).astype(np.float32)
    write_image(os.path.join(tmp, "env.exr"), env)
    slide = r.random((8, 12, 3)).astype(np.float32)
    write_image(os.path.join(tmp, "slide.exr"), slide)
    T = mi.ScalarTransform4f
    d = cornell_box(res=16, spp=4, max_depth=4)
    d.update({
        "panel": {"type": "rectangle",
                  "to_world": T.translate([0.6, 1.2, -0.9]).scale(0.2),
                  "emitter": {"type": "directionalarea",
                              "radiance": [4.0, 3.0, 2.0]}},
        "bulb": {"type": "point", "position": [0.2, 1.5, 0.3],
                 "intensity": {"type": "rgb", "value": [3.0, 2.0, 1.0]}},
        "sky": {"type": "constant", "radiance": 0.3},
        "env": {"type": "envmap", "filename": os.path.join(tmp, "env.exr"),
                "scale": 0.7},
        "sun": {"type": "directional", "direction": [0.1, -0.5, -1.0],
                "irradiance": [2.0, 1.8, 1.5]},
        "spot": {"type": "spot", "to_world": T.look_at(
            origin=[0, 1.8, 0.2], target=[0, 0, 0], up=[0, 0, 1]),
            "intensity": 5.0, "cutoff_angle": 30.0, "beam_width": 20.0},
        "slide": {"type": "projector", "to_world": T.look_at(
            origin=[0, 1, 2.5], target=[0, 1, -1], up=[0, 1, 0]),
            "fov": 40.0, "scale": 10.0, "irradiance": {
                "type": "bitmap", "filename": os.path.join(tmp, "slide.exr")}},
        "checker": {"type": "projector", "to_world": T.look_at(
            origin=[-0.5, 1.5, 1.0], target=[0, 0.5, -1], up=[0, 1, 0]),
            "fov": 30.0, "irradiance": {
                "type": "checkerboard", "color0": [1.0, 0.1, 0.1],
                "color1": [0.1, 0.1, 1.0], "uv_scale": 4.0}},
    })
    return d


def _jax_args(sj):
    return (sj.vertices, sj.faces, sj.em_faces)


def _port_args(st):
    return (st.vertices, st.faces, st.em_faces)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    sj = mi.load_dict(all_kinds_scene(str(tmp_path_factory.mktemp("em"))))
    st = port_scene_of(sj)
    assert st.static.emitter_kinds == tuple(range(8))
    return sj, st


@pytest.fixture(scope="module")
def lanes():
    r = np.random.default_rng(8)
    p = np.stack([r.uniform(-0.9, 0.9, N), r.uniform(0.05, 1.95, N),
                  r.uniform(-0.9, 0.9, N)], -1).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, -1], [1e-4, 1, 0]]   # poles
    d[:4] /= np.linalg.norm(d[:4], axis=-1, keepdims=True)
    return dict(p=p, s2=r.random((N, 2)).astype(np.float32), d=d,
                active=r.random(N) < 0.8,
                idx=r.integers(-1, 9, N).astype(np.int32),   # 9 lights
                wz=r.uniform(-1, 1, N).astype(np.float32))


@pytest.fixture(scope="module")
def sampled(scenes, lanes):
    sj, st = scenes
    ds_j, w_j = EJ.sample_direction(
        sj.emitters, sj.static.emitter_kinds, jnp.asarray(lanes["p"]),
        jnp.asarray(lanes["s2"]), *_jax_args(sj), sj.textures,
        sj.static.env_texture)
    ds_t, w_t = ET.sample_direction(
        st.emitters, st.static.emitter_kinds, _t(lanes["p"]),
        _t(lanes["s2"]), *_port_args(st), st.textures,
        st.static.env_texture)
    return ds_j, w_j, ds_t, w_t


def _kind_lanes(st, ds_emitter_index, name):
    kind = st.emitters["kind"].numpy()[np.asarray(ds_emitter_index)]
    return kind == ET.KIND_NAMES[name]


def _envmap_flips(sj, lanes, em_idx):
    """The envmap lanes whose sample falls within 2 ulp of a row or
    column CDF entry, rescaled as ``sample_direction`` rescales u0."""
    tex = sj.textures[sj.static.env_texture]
    wgt = np.asarray(EJ.envmap_weights(tex))
    row = np.cumsum(wgt.sum(1))
    col = np.cumsum(wgt, 1)
    n_em = len(np.asarray(sj.emitters["kind"]))
    u0 = np.clip(lanes["s2"][:, 0] * n_em - em_idx, 0, 1 - 1e-7)
    return (_flip_lanes(row / row[-1])(lanes["s2"][:, 1])
            | _flip_lanes(col / col[:, -1:])(u0.astype(np.float32)))


@pytest.mark.parametrize("name", KINDS)
def test_sample_direction_matches_jax(scenes, lanes, sampled, name):
    """Every field of the direction sample and the weight, on the lanes
    that picked a light of kind ``name``."""
    sj, st = scenes
    ds_j, w_j, ds_t, w_t = sampled
    _close(ds_t.emitter_index, ds_j.emitter_index, "emitter_index")
    k = _kind_lanes(st, ds_j.emitter_index, name)
    assert k.sum() > 100, k.sum()
    if name == "envmap":
        flips = _envmap_flips(sj, lanes, np.asarray(ds_j.emitter_index))
        same = np.all(ds_t.uv.numpy() == np.asarray(ds_j.uv), -1)
        assert np.all(same[k] | flips[k]), (~same[k]).sum()
        assert (~same[k]).sum() <= max(1, 1e-3 * k.sum())
        k = k & same
    far = name in ("constant", "envmap", "directional")
    for f in ("n", "uv", "d", "dist", "pdf", "delta"):
        _close(getattr(ds_t, f)[k], np.asarray(getattr(ds_j, f))[k],
               f"{name} {f}")
    _close(ds_t.p[k], np.asarray(ds_j.p)[k], f"{name} p",
           atol=1e-5 * ET._WORLD_RADIUS if far else ATOL)
    w_ref = np.asarray(w_j)[k]
    _close(w_t[k], w_ref, f"{name} weight",
           atol=1e-5 * np.abs(w_ref).max() if name == "spot" else ATOL)
    if name in ("point", "spot", "projector", "directional"):
        assert ds_t.delta[k].all()
    if far:
        np.testing.assert_array_equal(ds_t.dist[k].numpy(), 1e5)


@pytest.mark.parametrize("name", KINDS)
def test_pdf_direction_matches_jax(scenes, lanes, sampled, name):
    """The MIS pdf of JAX's own samples (the hit being the sampled point,
    as a BSDF ray that found the light), lanes of kind ``name``; delta
    lights give 0."""
    sj, st = scenes
    ds_j = sampled[0]
    args = {k: np.asarray(getattr(ds_j, k))
            for k in ("d", "emitter_index", "p", "n")}
    act = lanes["active"]
    ref = EJ.pdf_direction(
        sj.emitters, sj.static.emitter_kinds, jnp.asarray(lanes["p"]),
        jnp.asarray(args["d"]), jnp.asarray(args["emitter_index"]),
        jnp.asarray(args["p"]), jnp.asarray(args["n"]), *_jax_args(sj),
        jnp.asarray(act), sj.textures, sj.static.env_texture)
    got = ET.pdf_direction(
        st.emitters, st.static.emitter_kinds, _t(lanes["p"]),
        _t(args["d"]), _t(args["emitter_index"]), _t(args["p"]),
        _t(args["n"]), *_port_args(st), _t(act), st.textures,
        st.static.env_texture)
    k = _kind_lanes(st, args["emitter_index"], name)
    _close(got[k], np.asarray(ref)[k], name)
    if name in ("point", "spot", "projector", "directional"):
        assert (got[k] == 0).all()
    else:
        assert (got[k & act] > 0).any()


def test_eval_hit_and_eval_env_match_jax(scenes, lanes):
    """``eval_hit`` at every row (-1: none), both sides; ``eval_env`` of
    the constant and the envmap together, on directions with the poles,
    some lanes inactive."""
    sj, st = scenes
    ref = EJ.eval_hit(sj.emitters, jnp.asarray(lanes["idx"]),
                      jnp.asarray(lanes["wz"]))
    got = ET.eval_hit(st.emitters, _t(lanes["idx"]), _t(lanes["wz"]),
                      kinds_present=st.static.emitter_kinds)
    _close(got, ref, "eval_hit")
    lit = got.numpy().any(-1)
    kinds = st.emitters["kind"].numpy()[np.maximum(lanes["idx"], 0)]
    assert lit.any() and np.all(np.isin(kinds[lit], (0, 7)))
    ref = EJ.eval_env(sj.emitters, sj.static.emitter_kinds,
                      jnp.asarray(lanes["d"]), jnp.asarray(lanes["active"]),
                      sj.textures, sj.static.env_texture)
    got = ET.eval_env(st.emitters, st.static.emitter_kinds,
                      _t(lanes["d"]), _t(lanes["active"]), st.textures,
                      st.static.env_texture)
    _close(got, ref, "eval_env")
    assert (got.numpy()[~lanes["active"]] == 0).all()


def test_envmap_weights_and_pdf_match_jax(scenes, lanes):
    sj, st = scenes
    tj = sj.textures[sj.static.env_texture]
    tt = st.textures[st.static.env_texture]
    _close(ET.envmap_weights(tt), EJ.envmap_weights(tj), "weights")
    _close(ET.envmap_pdf_direction(tt, _t(lanes["d"])),
           EJ.envmap_pdf_direction(tj, jnp.asarray(lanes["d"])), "pdf")
    _close(ET._dir_to_latlong_uv(_t(lanes["d"])),
           EJ._dir_to_latlong_uv(jnp.asarray(lanes["d"])), "latlong uv")


def test_envmap_sampler_bisection_equals_compare_sum(tmp_path):
    """The port's envmap sampler at a 64 x 128 map against the
    reference's compare-sum column search run on the port's own CDFs:
    the same texel on every lane."""
    sj = mi.load_dict(all_kinds_scene(str(tmp_path), envmap_hw=(64, 128)))
    st = port_scene_of(sj)
    tex = st.textures[st.static.env_texture]
    r = np.random.default_rng(9)
    s2 = _t(r.random((N, 2)).astype(np.float32))
    em_idx = torch.full((N,), st.emitters["kind"].tolist().index(
        ET.KIND_ENVMAP), dtype=torch.int32)
    row = {k: v[em_idx.long()] for k, v in st.emitters.items()}
    ds, _ = ET._envmap_sample(row, torch.zeros(N, 3), s2, em_idx, tex)
    wgt = ET.envmap_weights(tex)
    h, w = wgt.shape
    row_cdf = torch.cumsum(wgt.sum(1), 0)
    row_cdf = row_cdf / row_cdf[-1]
    col = torch.cumsum(wgt, 1)
    col = col / col[:, -1:]
    y = torch.clamp(torch.searchsorted(row_cdf, s2[:, 1].contiguous(),
                                       right=True), 0, h - 1)
    x = torch.clamp((col[y] <= s2[:, :1]).sum(-1), 0, w - 1)
    np.testing.assert_array_equal(
        ds.uv.numpy(), torch.stack([(x + 0.5) / w, (y + 0.5) / h],
                                   -1).numpy())


def test_check_kinds_refuses_plugin_kinds():
    """The eight kinds pass; a kind no ``register_emitter`` call gave
    raises."""
    ET.check_kinds(tuple(range(8)))
    with pytest.raises(NotImplementedError, match="unknown"):
        ET.check_kinds((0, 999_999))

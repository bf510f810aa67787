"""The reference-free EPSM oracle of ``tests/test_epsm_oracle.py`` run
against the port: a from-scratch numpy specular tracer and a from-scratch
numpy debiased Sinkhorn divergence give the objective S(render(theta),
target) by finite differences, and the port's ``manifold`` integrator
with its ``Matcher`` (the gradient of sum(img5 * g5), as ``app/optim.py``
takes it) must reproduce its sign and scale.  The numpy legs are that
file's own, imported unchanged; the port's scene is built by its own
loader.

Tolerances, as the oracle's: the framework primal's mean within 0.02 of
the numpy tracer's; the gradient of the right sign and within
0.5 |fd| + 2 (se_fd + se_ad) of the finite difference, EPSM's estimator
being itself first order (the OT envelope and the constraint solve).
"""
import numpy as np
import torch

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
from epsm_mitsuba3_torch.ops.sinkhorn import Matcher

import test_epsm_oracle as oracle
from torch_threads import one_torch_thread  # noqa: F401


def _port_scene():
    """The oracle's mirror scene (``_framework_scene``) for the port."""
    return mt.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "fov": oracle.FOV,
                   "to_world": T.look_at(origin=list(oracle.CAM_O),
                                         target=list(oracle.CAM_T),
                                         up=(0, 1, 0)),
                   "film": {"type": "hdrfilm", "width": oracle.RES,
                            "height": oracle.RES,
                            "rfilter": {"type": "box"}}},
        "mirror": {"type": "rectangle", "bsdf": {"type": "conductor"}},
        "light": {"type": "rectangle",
                  "to_world": T.translate([0.0, 1.0, 3.2])
                  .rotate([1, 0, 0], 180).scale(0.6),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb",
                                           "value": oracle.LE}}},
    }, device="cpu")


def test_manifold_gradient_vs_independent_fd():
    RES = oracle.RES
    scene0 = _port_scene()
    li = list(scene0.static.shape_names).index("light")
    s, c = scene0.static.vertex_ranges[li]

    # sanity: the port's primal and the numpy tracer see the same spot
    img_fw = mt.render(scene0, spp=64, seed=3, device="cpu",
                       integrator={"type": "path", "max_depth": 3}).numpy()
    img_np = oracle._np_render(0.0, 64, np.random.default_rng(3))
    assert abs(img_fw.mean() - img_np.mean()) < 0.02, \
        (img_fw.mean(), img_np.mean())

    theta0, eps = 0.25, 0.05
    target5 = np.concatenate(
        [np.clip(oracle._np_render(0.0, 256, np.random.default_rng(0)),
                 0, 1), oracle._pos_grid()], -1)
    fds = []
    for sd in range(4):
        lp = oracle._np_loss(theta0 + eps, target5, 128, 100 + sd)
        lm = oracle._np_loss(theta0 - eps, target5, 128, 100 + sd)
        fds.append((lp - lm) / (2 * eps))
    fd = float(np.mean(fds))
    fd_se = float(np.std(fds) / np.sqrt(len(fds)))

    matcher = Matcher(RES, device="cpu")
    gt_low = torch.tensor(target5[:, :3], dtype=torch.float32)

    def grad(seed):
        theta = torch.tensor(theta0, requires_grad=True)
        shift = torch.stack([theta, torch.tensor(0.0), torch.tensor(0.0)])
        v = scene0.vertices.clone()
        v[s:s + c] = v[s:s + c] + shift[None, :]
        img = mt.render(scene0.set_vertices(v), spp=16, seed=seed,
                        integrator={"type": "manifold", "max_depth": 3},
                        device="cpu")
        with torch.no_grad():
            g5 = matcher.match_Sinkhorn(img[..., :3].reshape(-1, 3),
                                        gt_low).reshape(RES, RES, 5)
        # the matcher returns grad * n (matcher.py:60); the numpy loss is
        # the raw divergence
        loss = torch.sum(img * g5) / (RES * RES)
        (g,) = torch.autograd.grad(loss, theta)
        return float(g)

    gs = [grad(sd) for sd in range(4)]
    ad = float(np.mean(gs))
    ad_se = float(np.std(gs) / np.sqrt(len(gs)))

    assert np.isfinite(ad) and np.isfinite(fd)
    assert np.sign(ad) == np.sign(fd), (ad, fd)
    tol = 0.5 * abs(fd) + 2.0 * (fd_se + ad_se)
    assert abs(ad - fd) < tol, (ad, fd, fd_se, ad_se)

"""The port's PRB gradients through the camera side against ``jax.grad``
of the JAX package's ``render``: the Cornell box (face normals on the
walls) at 16^2 x 4 spp, depth 2, with a gaussian film and the
multijitter sampler (the thin lens with a tent film and the stratified
sampler is ``tests/test_torch_prb_thinlens.py``).

The film's adjoint runs through ``splat_coalesced`` with the weight
channel detached (``ad/prb.py:93-101``), and the fused replay must draw
the stratified kinds' samples in the forward's order of dimensions: a
replay that drew one more or one fewer dimension would scramble other
strata and move the gradients far beyond the tolerance.

Tolerance: each gradient within 1e-4 of its largest entry, as in
``tests/test_torch_prb.py``; the loss within 1e-5 relative.
"""
import numpy as np
import torch

import jax.numpy as jnp

import epsm_mitsuba3_tpu as mi
from scenes import cornell_box as cornell_box_jax

import epsm_mitsuba3_torch as mt

from test_torch_prb import WALLS, _assert_grad_close, _weights
from test_torch_render import jax_leaf_grads, port_scene_of
from test_torch_render_filters import camera_dict
from torch_threads import one_torch_thread  # noqa: F401

SPP, DEPTH = 4, 2
NAMES = ("vertices", "bsdfs.reflectance", "emitters.radiance")


def gradients_match_jax(rfilter, sampler, sensor=None):
    """sum(image * W) and its gradients w.r.t. NAMES, in both packages."""
    d = camera_dict(cornell_box_jax, rfilter, sampler, DEPTH, sensor)
    for k in WALLS:
        d[k]["face_normals"] = True
    sj = mi.load_dict(d)
    W = _weights(2)
    loss_j, g = jax_leaf_grads(
        sj, lambda s: jnp.sum(mi.render(s, spp=SPP, seed=0) * W), NAMES)
    st = port_scene_of(sj)
    lv = {k: v.clone().requires_grad_(True)
          for k, v in st.leaves().items() if k in NAMES}
    img = mt.render(st.with_leaves(lv), spp=SPP, seed=0, device="cpu")
    loss = (img * torch.from_numpy(W)).sum()
    got = torch.autograd.grad(loss, list(lv.values()))
    got = dict(zip(lv, (x.numpy() for x in got)))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5)
    for k in g:
        _assert_grad_close(got[k], g[k], k)


def test_gaussian_multijitter_gradients_match_jax():
    gradients_match_jax("gaussian", "multijitter")

"""Kernel K1 on the card against its plain version, at small and ragged
shapes.  These tests need CUDA and nvcc; without a card they skip.

Run them on a GPU machine (the suite's conftest imports JAX, which the
port does not need):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.ops import cuda_intersect as CI
from epsm_mitsuba3_torch.ops import intersect as I
from epsm_mitsuba3_torch.scenes import cornell_box

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soup(n_tris, n_rays, seed):
    r = np.random.default_rng(seed)
    verts = r.uniform(-1, 1, (3 * n_tris, 3)).astype(np.float32)
    faces = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    o = r.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = r.uniform(-0.8, 0.8, (n_rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(r.random(n_rays) < 0.3, r.uniform(0.5, 4, n_rays),
                    np.inf).astype(np.float32)
    maxt[r.random(n_rays) < 0.1] = 0.0
    tri = CI.pack_tris(torch.from_numpy(verts), torch.from_numpy(faces))
    return tri, torch.from_numpy(o), torch.from_numpy(d), \
        torch.from_numpy(maxt)


@pytest.mark.parametrize("n_tris,n_rays", [
    (1, 1), (12, 37), (255, 4133), (257, 4133), (600, 1000), (4096, 700)])
def test_k1_kernel_equals_plain(cuda, n_tris, n_rays):
    """Built with --fmad=false in the plain version's operation order:
    hits, indices and t/u/v equal the plain version on the same card."""
    args_cpu = _soup(n_tris, n_rays, n_tris)
    args = [x.to(cuda) for x in args_cpu]
    before = dict(CI.launches)
    t, prim, u, v = CI.closest_hit(*args)
    occ = CI.any_hit(*args)
    torch.cuda.synchronize()
    assert CI.launches["mt_closest_hit"] == before["mt_closest_hit"] + 1
    assert CI.launches["mt_any_hit"] == before["mt_any_hit"] + 1
    t_p, prim_p, u_p, v_p = I.ray_intersect_brute(*args)
    assert torch.equal(prim, prim_p)
    assert torch.equal(occ, prim_p >= 0)
    assert torch.equal(occ, I.ray_test_brute(*args))
    for a, b in ((t, t_p), (u, u_p), (v, v_p)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # and the CPU plain version agrees on the hits
    t_c, prim_c, _, _ = CI.closest_hit(*args_cpu)
    assert (prim.cpu() == prim_c).float().mean() >= 0.9999


def test_k1_rejects_mixed_devices(cuda):
    tri, o, d, maxt = _soup(4, 8, 0)
    with pytest.raises(ValueError):
        CI.closest_hit(tri.to(cuda), o, d, maxt)


def test_render_cuda_matches_cpu(cuda):
    """The RNG is bit-exact on both devices: a small render agrees."""
    d = cornell_box(res=16, spp=2, max_depth=4)
    img_c = mt.render(mt.load_dict(d, device=cuda), spp=2, seed=0)
    img_h = mt.render(mt.load_dict(d, device="cpu"), spp=2, seed=0,
                      device="cpu")
    diff = (img_c.cpu() - img_h).abs()
    assert float(diff.mean()) <= 1e-3 * float(img_h.mean())
    assert float((diff.amax(-1) <= 1e-3).float().mean()) >= 0.99

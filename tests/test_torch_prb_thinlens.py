"""The port's PRB gradients through a thin lens with a tent film and the
stratified sampler against ``jax.grad`` of the JAX package's ``render``
(``gradients_match_jax`` of ``tests/test_torch_prb_camera.py``).  The
lens draws its aperture sample after the pixel jitter, so the forward
and the replay start the bounces two dimensions further on.

Tolerance: each gradient within 1e-4 of its largest entry, the loss
within 1e-5 relative.
"""
from test_torch_prb_camera import gradients_match_jax
from torch_threads import one_torch_thread  # noqa: F401


def test_thinlens_tent_stratified_gradients_match_jax():
    gradients_match_jax("tent", "stratified",
                        {"type": "thinlens", "aperture_radius": 0.05,
                         "focus_distance": 3.9})

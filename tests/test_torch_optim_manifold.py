"""The port's ``run`` against the JAX package's on the ``cornellbox``
light-ring experiment at 32^2 x 4 spp, depth 3, for 3 iterations each:
``manifold``, and ``manifold_caustic_hybrid`` at ``thres`` 2, so that the
switch to PRB's loss and the Adam reset at ``thres`` run.  As in
``tests/test_torch_optim.py`` (its helpers and fixtures), both packages'
Sinkhorn matcher answers with one fixed OT gradient, and theta is held
within 1e-3 of its largest entry at each iteration; that file's docstring
gives the reason.
"""
import pytest

from test_torch_optim import (  # noqa: F401  (fixtures)
    _assert_tracks, _cornellbox_runs, fixed_matchers, ot_field)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("method,thres", [("manifold", 10 ** 9),
                                          ("manifold_caustic_hybrid", 2)])
def test_run_manifold_methods_track_jax(fixed_matchers, method, thres):
    th_j, th_t, losses = _cornellbox_runs(method, 3, thres, max_depth=3)
    _assert_tracks(th_j, th_t, losses, 3)

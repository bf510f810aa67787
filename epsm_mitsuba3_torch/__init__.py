"""epsm_mitsuba3_torch — the PyTorch/CUDA port of ``epsm_mitsuba3_tpu``.

The JAX package beside this one is the reference; every module here has a
counterpart of the same name there.  This package imports ``torch`` and
``numpy`` only.  Its entry points run on the GPU unless the caller passes
``device="cpu"``, which runs every hand-written kernel's plain PyTorch
version instead.

    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    scene = mt.load_dict(cornell_box(res=512, spp=64, max_depth=6))
    img = mt.render(scene, spp=64, spp_chunk=4)        # (H, W, 3) on cuda
"""

from .core.transform import ScalarTransform4f  # noqa: F401
from .models.scene import Scene, load_dict, scene_from_arrays  # noqa: F401
from .models.records import Ray, RayFlags  # noqa: F401
from .ad.render import render  # noqa: F401

__version__ = "0.1.0"

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

    scene = mt.load_file("scene.xml")                  # XML + mesh files
    params = mt.traverse(scene)
    params["blob.vertex_positions"] = params["blob.vertex_positions"] + 0.1
    scene = params.update()
    mt.write_image("out.exr", mt.render(scene))

``render`` runs the integrator types ``path``, ``prb``, ``prb_basic``,
``prb_reparam``, ``manifold``, ``manifold_caustic``, ``direct``,
``direct_reparam``, ``emission_reparam``, ``depth``, ``aov``, ``moment``,
``ptracer``, ``spectral``, ``spectral_mono`` and ``spectral_spec``, and
any given to ``register_integrator``.  ``utils/image.py`` (the Z-test
over ``moment``), ``utils/denoiser.py`` and ``utils/tonemap.py`` consume
their outputs.
"""

from .core.bitmap import Bitmap, read_image, write_image  # noqa: F401
from .core.transform import ScalarTransform4f  # noqa: F401
from .core.xmlparse import load_file, load_string  # noqa: F401
from .models.scene import (Scene, SceneParameters, load_dict,  # noqa: F401
                           scene_from_arrays, traverse)
from .ops.normals import (compute_vertex_normals,  # noqa: F401
                          scene_with_vertices)
from .models.records import Ray, RayFlags  # noqa: F401
from .ad.render import (register_integrator, render,  # noqa: F401
                        render_forward)

__version__ = "0.1.0"

"""The port's command-line renderer against the JAX package's.

``cli.main`` on an XML scene (a diffuse rectangle lit by a small area
light, its albedo given by ``-D``), on the CPU, with ``--spp``,
``--integrator``, ``--depth``, ``-s`` and ``-m``: the EXR it writes must
equal JAX's CLI image within the render tolerance of
``tests/test_torch_render.py`` and, read back, the port's own render of
the scene bit for bit.  (JAX's own CLI test lights its scene with a
``constant`` emitter, which the port does not have.)
"""
import numpy as np
import pytest

from epsm_mitsuba3_tpu import cli as CJ
from epsm_mitsuba3_tpu.core.bitmap import read_image as read_j

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch import cli as CT

from test_torch_render import assert_images_close

XML = """<scene version="3.0.0">
  <default name="res" value="8"/>
  <integrator type="path"><integer name="max_depth" value="2"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, -1, 4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="$res"/><integer name="height" value="$res"/>
      <rfilter type="box"/>
    </film>
    <sampler type="independent">
      <integer name="sample_count" value="2"/>
    </sampler>
  </sensor>
  <shape type="rectangle">
    <bsdf type="diffuse"><rgb name="reflectance" value="$albedo"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world">
      <scale value="0.4"/><rotate x="1" angle="150"/>
      <translate y="1.2" z="1.0"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="8, 7, 6"/></emitter>
  </shape>
</scene>"""

ARGS = ["--spp", "4", "-D", "albedo=0.6, 0.5, 0.4", "-D", "res=16",
        "--integrator", "path", "--depth", "3", "-s", "0", "--seed", "2"]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    scene = tmp / "s.xml"
    scene.write_text(XML)
    out_t, out_j = tmp / "t.exr", tmp / "j.exr"
    assert CT.main([str(scene), "-o", str(out_t), *ARGS, "-m", "cuda_ad_rgb",
                    "--device", "cpu"]) == 0
    assert CJ.main([str(scene), "-o", str(out_j), *ARGS]) == 0
    return str(scene), mt.read_image(str(out_t)).data, \
        read_j(str(out_j)).data


def test_cli_image_equals_jax(images):
    _, img_t, img_j = images
    assert img_t.shape == (16, 16, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0.01
    assert_images_close(img_t, img_j)


def test_cli_image_is_the_render(images):
    """The EXR holds ``render``'s float32 output unchanged."""
    path, img_t, _ = images
    sc = mt.load_file(path, {"albedo": "0.6, 0.5, 0.4", "res": "16"},
                      device="cpu")
    ref = mt.render(sc, spp=4, seed=2, device="cpu",
                    integrator={"type": "path", "max_depth": 3}).numpy()
    np.testing.assert_array_equal(img_t, ref)


def test_cli_writes_pfm_and_refuses_unknown_formats(images, tmp_path):
    path, img_t, _ = images
    out = tmp_path / "o.pfm"
    assert CT.main([path, "-o", str(out), *ARGS, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(mt.read_image(str(out)).data, img_t)
    with pytest.raises(ValueError, match="format"):
        CT.main([path, "-o", str(tmp_path / "o.tiff"), *ARGS,
                 "--device", "cpu"])

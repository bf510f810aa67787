"""The port's XML scene parser and writer against the JAX package's.

The XML texts of ``tests/test_xml.py`` (a full scene, ``$`` substitution,
``load_file``, the transform chain, the legacy and uv upgrades) and more
(``<include>``, ``<ref>``, ``<alias>``, every transform op and value tag,
mesh files named relative to the XML) are parsed by both packages: the
dicts must be equal, recursively, arrays exactly.  The scenes the port
renders must load to JAX's ``Scene`` fields exactly (the emitter kinds
too: an envmap named by ``filename``, point, spot, directional and
constant lights with ``<point>``, ``<vector>`` and ``<transform>``, a
projector with a checkerboard, and the uv legacy scene's checkerboard
reflectance); the others (a texture where only a colour is read, a
volume texture, an emitter plugin's kind) raise ``NotImplementedError``
with the plugin's name.  ``dict_to_xml`` writes
JAX's text and round-trips through ``load_string``.
"""
import numpy as np
import pytest

import epsm_mitsuba3_tpu.models.scene as scene_j
from epsm_mitsuba3_tpu.core import xmlparse as XJ
from epsm_mitsuba3_tpu.utils import xmlwrite as WJ
from scenes import cornell_box as cornell_box_jax
from test_xml import XML

import epsm_mitsuba3_torch as mt
from epsm_mitsuba3_torch.core import xmlparse as XT
from epsm_mitsuba3_torch.scenes import cornell_box
from epsm_mitsuba3_torch.utils import xmlwrite as WT

from test_torch_exp import _assert_scene_equal

LEGACY = """
<scene version="0.5.0">
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookAt origin="0,0,4" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="16"/>
      <integer name="height" value="16"/>
    </film>
  </sensor>
  <shape type="rectangle">
    <bsdf type="diffuse">
      <rgb name="diffuseReflectance" value="0.7 0.2 0.2"/>
    </bsdf>
  </shape>
  <emitter type="constant">
    <rgb name="radiance" value="0.6"/>
  </emitter>
</scene>"""

UV_LEGACY = """
<scene version="0.5.0">
  <shape type="rectangle">
    <bsdf type="diffuse">
      <texture name="reflectance" type="checkerboard">
        <float name="uscale" value="2"/>
        <float name="vscale" value="3"/>
        <float name="uoffset" value="0.25"/>
        <float name="voffset" value="0.5"/>
      </texture>
    </bsdf>
  </shape>
</scene>"""

#: every transform op and value tag, refs to stand-alone BSDFs, an alias
#: and a twosided wrapper with an id
REFS = """
<scene version="3.0.0">
    <default name="w" value="12"/>
    <integrator type="path"><integer name="max_depth" value="$depth"/>
    </integrator>
    <sensor type="perspective">
        <float name="fov" value="35"/>
        <transform name="to_world">
            <lookat origin="0, 1.5, 5" target="0, 0.8, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="$w"/>
            <integer name="height" value="10"/>
            <rfilter type="box"/>
        </film>
        <sampler type="independent">
            <integer name="sample_count" value="3"/>
        </sampler>
    </sensor>
    <bsdf type="twosided" id="paint">
        <bsdf type="diffuse">
            <rgb name="reflectance" value="0.2, 0.5, 0.3"/>
        </bsdf>
    </bsdf>
    <bsdf type="conductor" id="metal">
        <rgb name="eta" value="0.2 0.9 1.1"/>
        <rgb name="k" value="3.9, 2.4, 2.2"/>
    </bsdf>
    <alias id="metal" as="chrome"/>
    <shape type="cube">
        <transform name="to_world">
            <scale value="0.3"/>
            <rotate y="1" angle="25"/>
            <translate x="-0.4" y="0.3"/>
        </transform>
        <ref id="paint"/>
    </shape>
    <shape type="sphere">
        <float name="radius" value="0.25"/>
        <point name="center" x="0.4" y="0.3" z="0.1"/>
        <integer name="subdiv" value="6"/>
        <boolean name="flip_normals" value="false"/>
        <ref name="bsdf" id="metal"/>
    </shape>
    <shape type="rectangle" id="floor">
        <transform name="to_world">
            <matrix value="2 0 0 0  0 0 2 0  0 -2 0 0  0 0 0 1"/>
        </transform>
        <bsdf type="diffuse"><spectrum name="reflectance" value="0.5"/>
        </bsdf>
    </shape>
    <shape type="disk">
        <transform name="to_world">
            <matrix value="0.2 0 0  0 0.2 0  0 0 0.2"/>
            <translate value="0 0.9 -0.5"/>
            <scale x="1" y="2" z="1"/>
        </transform>
        <bsdf type="dielectric"><float name="int_ior" value="1.33"/></bsdf>
    </shape>
    <shape type="rectangle">
        <transform name="to_world">
            <rotate x="1" angle="90"/>
            <scale value="0.2"/>
            <translate y="1.9"/>
        </transform>
        <emitter type="area">
            <rgb name="radiance" value="12"/>
        </emitter>
    </shape>
</scene>
"""

#: a light of every shapeless kind beside a rectangle, each placed by a
#: value tag or a transform; the envmap's file is written by the test
EMITTERS = """
<scene version="3.0.0">
    <sensor type="perspective">
        <transform name="to_world">
            <lookat origin="0, 1, 4" target="0, 1, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
        </film>
    </sensor>
    <shape type="rectangle">
        <transform name="to_world"><rotate x="1" angle="-90"/></transform>
    </shape>
    <emitter type="envmap">
        <string name="filename" value="sky.exr"/>
        <float name="scale" value="0.5"/>
    </emitter>
    <emitter type="constant">
        <rgb name="radiance" value="0.1, 0.2, 0.3"/>
    </emitter>
    <emitter type="point">
        <point name="position" x="0.5" y="2" z="-0.25"/>
        <rgb name="intensity" value="4"/>
    </emitter>
    <emitter type="spot">
        <transform name="to_world">
            <lookat origin="0, 2, 1" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <float name="cutoff_angle" value="25"/>
        <float name="beam_width" value="12"/>
        <spectrum name="intensity" value="6"/>
    </emitter>
    <emitter type="directional">
        <vector name="direction" x="0.3" y="-1" z="-0.2"/>
        <rgb name="irradiance" value="2, 1.5, 1"/>
    </emitter>
    <emitter type="directional">
        <transform name="to_world"><rotate x="1" angle="120"/></transform>
    </emitter>
    <emitter type="projector">
        <transform name="to_world">
            <lookat origin="0, 3, 0" target="0, 0, 0" up="0, 0, 1"/>
        </transform>
        <float name="fov" value="35"/>
        <texture name="irradiance" type="checkerboard">
            <rgb name="color0" value="1, 0, 0"/>
            <float name="uscale" value="3"/>
        </texture>
    </emitter>
</scene>"""

#: a volume texture on an emitter, an emitter plugin's kind
VOLUME_TEX = """
<scene version="3.0.0">
    <shape type="rectangle">
        <emitter type="area">
            <texture name="radiance" type="volume"/>
        </emitter>
    </shape>
</scene>"""

#: a texture where the port reads only a colour
TEX_ELSEWHERE = """
<scene version="3.0.0">
    <shape type="rectangle">
        <bsdf type="conductor">
            <texture name="specular_reflectance" type="checkerboard"/>
        </bsdf>
    </shape>
</scene>"""

PLUGIN_EMITTER = """
<scene version="3.0.0">
    <shape type="rectangle">
        <emitter type="my_plugin_light"/>
    </shape>
</scene>"""

#: value tags that no loaded scene above carries
VALUES = """
<bsdf type="roughconductor" id="b">
    <float name="alpha" value="0.2"/>
    <string name="distribution" value="ggx"/>
    <vector name="axis" value="0, 0, 1"/>
    <spectrum name="eta" value="400:1.2, 500:1.3, 600:1.4"/>
    <string name="filename" value="tables/eta.spd"/>
    <texture type="checkerboard" name="alpha_tex"/>
</bsdf>
"""


def _same(a, b, path="d"):
    """Recursive equality of two parsed dicts, across packages."""
    if hasattr(a, "matrix") or hasattr(b, "matrix"):
        np.testing.assert_array_equal(np.asarray(a.matrix),
                                      np.asarray(b.matrix), path)
        assert np.asarray(a.matrix).dtype == np.asarray(b.matrix).dtype
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, path)
        return
    assert type(a) is type(b) and a == b, (path, a, b)


def _jax_dict(monkeypatch, fn, *args, **kw):
    """The dict JAX's ``load_string``/``load_file`` hands to load_dict."""
    got = {}
    monkeypatch.setattr(scene_j, "load_dict",
                        lambda d: got.setdefault("d", d))
    fn(*args, **kw)
    monkeypatch.undo()
    return got["d"]


TEXTS = {"full": XML, "legacy": LEGACY, "uv_legacy": UV_LEGACY,
         "refs": REFS, "emitters": EMITTERS, "volume_tex": VOLUME_TEX,
         "tex_elsewhere": TEX_ELSEWHERE, "plugin_emitter": PLUGIN_EMITTER}
PARAMS = {"refs": {"depth": "3"}}


@pytest.mark.parametrize("name", list(TEXTS))
def test_parse_equals_jax(monkeypatch, name):
    text, params = TEXTS[name], PARAMS.get(name)
    ref = _jax_dict(monkeypatch, XJ.load_string, text, params)
    _same(XT.parse_string(text, params), ref)


def test_plugin_root_equals_jax(tmp_path):
    """A root that is no <scene> gives that plugin's dict in both, file
    names joined to the base directory."""
    got = XT.load_string(VALUES, base_dir=str(tmp_path))
    _same(got, XJ.load_string(VALUES, base_dir=str(tmp_path)))
    assert got["filename"] == str(tmp_path / "tables" / "eta.spd")
    assert got["eta"]["type"] == "irregular"


@pytest.mark.parametrize("name", ["full", "refs", "legacy", "uv_legacy"])
def test_load_string_equals_jax(name):
    text, params = TEXTS[name], PARAMS.get(name)
    st = XT.load_string(text, params, device="cpu")
    sj = XJ.load_string(text, params)
    _assert_scene_equal(st, sj)
    np.testing.assert_array_equal(st.vertex_colors.numpy(),
                                  np.asarray(sj.vertex_colors))


def test_parameter_substitution():
    st = XT.load_string(XML, parameters={"spp": "8"}, device="cpu")
    assert st.static.spp == XJ.load_string(
        XML, parameters={"spp": "8"}).static.spp == 8
    assert XT.load_string(XML, device="cpu").static.spp == 4
    for load in (XT.parse_string, XJ.load_string):
        with pytest.raises(ValueError, match=r"\$depth"):
            load(REFS)


def test_transform_chain_matches_dict_loader():
    """Each op applies after the ones before it: rotate then scale in the
    XML is ``scale @ rotate`` in a dict (``tests/test_xml.py``)."""
    st = XT.load_string(XML, device="cpu")
    T = mt.ScalarTransform4f
    sd = mt.load_dict({"type": "scene",
                       "floor": {"type": "rectangle",
                                 "to_world": T.scale(2.0).rotate([1, 0, 0],
                                                                 -90)},
                       "light": {"type": "rectangle", "emitter": {
                           "type": "area"}}}, device="cpu")
    s, c = st.static.vertex_ranges[0]
    np.testing.assert_allclose(st.vertices[s:s + c].numpy(),
                               sd.vertices[:c].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,plugin", [("volume_tex", "volume"),
                                         ("tex_elsewhere", "checkerboard"),
                                         ("plugin_emitter",
                                          "my_plugin_light")])
def test_unported_plugins_raise(name, plugin):
    """A texture where only a colour is read (a conductor's specular
    reflectance), a volume texture and an emitter plugin's kind: the port
    names them and raises."""
    with pytest.raises(NotImplementedError, match=plugin):
        XT.load_string(TEXTS[name], device="cpu")


def test_emitter_scene_loads_as_jax(tmp_path):
    """Every shapeless kind from XML, the envmap's file named relative to
    the XML's directory: the parsed dict and the loaded scene (the whole
    emitter table, the textures, the envmap's index) equal JAX's."""
    from epsm_mitsuba3_torch.core.bitmap import write_image
    r = np.random.default_rng(14)
    write_image(str(tmp_path / "sky.exr"),
                r.random((8, 16, 3)).astype(np.float32))
    base = str(tmp_path)
    d = XT.parse_string(EMITTERS, base_dir=base)
    assert d["_elem2"]["filename"] == str(tmp_path / "sky.exr")
    st = XT.load_string(EMITTERS, base_dir=base, device="cpu")
    sj = XJ.load_string(EMITTERS, base_dir=base)
    _assert_scene_equal(st, sj)
    assert st.static.emitter_kinds == (1, 2, 3, 4, 5, 6)
    assert st.static.env_texture == sj.static.env_texture == 0
    assert [t.kind for t in st.textures] == ["bitmap", "checkerboard"]
    for a, b in zip(st.textures, sj.textures):
        for k in ("data", "color0", "color1", "uv_scale", "uv_offset"):
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)), k)


def test_legacy_upgrade_renames():
    d = XT.parse_string(LEGACY)
    kids = [v for v in d.values() if isinstance(v, dict)]
    sensor = next(v for v in kids if v["type"] == "perspective")
    assert "to_world" in sensor
    shape = next(v for v in kids if v["type"] == "rectangle")
    assert shape["bsdf"]["reflectance"]["value"] == [0.7, 0.2, 0.2]
    tex = XT.parse_string(UV_LEGACY)["_elem0"]["bsdf"]["reflectance"]
    assert (tex["uv_scale_x"], tex["uv_scale_y"], tex["uv_offset_x"],
            tex["uv_offset_y"]) == (2.0, 3.0, 0.25, 0.5)


def _write_files(tmp_path):
    """An OBJ, an included XML and the scene that names both relative to
    its own directory."""
    (tmp_path / "meshes").mkdir()
    (tmp_path / "meshes" / "tri.obj").write_text(
        "v -0.5 0 -0.5\nv 0.5 0 -0.5\nv 0 0 0.5\nv 0 0.6 0\n"
        "vt 0 0\nvt 1 0\nvt 0.5 1\nvn 0 1 0\n"
        "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 4/3/1 2/2/1\nf -1/3/1 -2/2/1 -4/1/1\n")
    (tmp_path / "parts").mkdir()
    (tmp_path / "parts" / "light.xml").write_text("""
<scene version="3.0.0">
    <shape type="rectangle" id="lamp">
        <transform name="to_world">
            <rotate x="1" angle="90"/><scale value="0.3"/>
            <translate y="2"/>
        </transform>
        <emitter type="area"><rgb name="radiance" value="9 8 7"/></emitter>
    </shape>
</scene>""")
    (tmp_path / "scene.xml").write_text(XML.replace(
        "</scene>", """
    <include filename="parts/light.xml"/>
    <shape type="obj" id="tri">
        <string name="filename" value="meshes/tri.obj"/>
        <transform name="to_world"><translate y="0.5"/></transform>
        <ref id="white"/>
    </shape>
</scene>"""))
    return str(tmp_path / "scene.xml")


def test_load_file_equals_jax(tmp_path, monkeypatch):
    """``load_file`` from another working directory: the OBJ and the
    included XML are found next to the scene."""
    path = _write_files(tmp_path)
    monkeypatch.chdir(tmp_path / "meshes")
    d = XT.parse_string(open(path).read(), base_dir=str(tmp_path))
    _same(d, _jax_dict(monkeypatch, XJ.load_file, path))
    st = XT.load_file(path, device="cpu")
    sj = XJ.load_file(path)
    _assert_scene_equal(st, sj)
    assert st.static.shape_names[-2:] == ("lamp", "tri")


def test_dict_to_xml_writes_jax_text_and_round_trips(tmp_path):
    """The writer's text is JAX's for the same scene; read back (with
    ``$spp`` substituted) it loads to ``load_dict``'s arrays."""
    text = WT.dict_to_xml(cornell_box(res=8, spp=3),
                          str(tmp_path / "box.xml"))
    assert text == WJ.dict_to_xml(cornell_box_jax(res=8, spp=3))
    assert (tmp_path / "box.xml").read_text() == text
    text = text.replace('<integer name="sample_count" value="3"/>',
                        '<integer name="sample_count" value="$spp"/>')
    st = XT.load_string(text, {"spp": "5"}, device="cpu")
    sd = mt.load_dict(cornell_box(res=8, spp=5), device="cpu")
    for k in ("vertices", "normals", "uvs", "faces", "face_shape"):
        assert np.array_equal(getattr(st, k).numpy(), getattr(sd, k).numpy())
    for k, v in sd.bsdfs.items():
        assert np.array_equal(st.bsdfs[k].numpy(), v.numpy()), k
    assert st.static.spp == 5
    with pytest.raises(ValueError, match="scene"):
        WT.dict_to_xml({"type": "diffuse"})

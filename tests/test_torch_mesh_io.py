"""The port's mesh-file loaders against the JAX package's ``mesh_io``.

Seeded meshes are written as OBJ (positions only; with texture
coordinates; with normals; with both, quads and n-gons; negative
indices), PLY (ASCII and binary little endian, with normals, texture
coordinates and colours, triangles and polygons) and Mitsuba's
serialized format (two meshes and the offset table, float32 and
float64).  Every array must equal JAX's exactly.  The OBJ parser the
port builds from ``native/meshio.cpp`` must equal its plain Python
version, and a failed build or a refused file raises instead of falling
back to the other parser.
"""
import struct
import zlib

import numpy as np
import pytest

from epsm_mitsuba3_tpu.models import mesh_io as MJ

from epsm_mitsuba3_torch.models import mesh_io as MT
from epsm_mitsuba3_torch.ops import _native

KEYS = ("vertices", "faces", "normals", "uvs", "colors")


def _assert_mesh_equal(got, ref):
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k in got:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], k)


def _mesh(seed, nv=40, nf=50):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nv, 3)).astype(np.float32),
            rng.integers(0, nv, size=(nf, 3)).astype(np.int32),
            rng.normal(size=(nv, 3)).astype(np.float32),
            rng.uniform(size=(nv, 2)).astype(np.float32),
            rng.integers(0, 256, size=(nv, 3)).astype(np.uint8))


# -- OBJ ----------------------------------------------------------------------

def _write_obj(path, kind, seed=0):
    """An OBJ of ``kind``: "v" (positions, triangles), "vt", "vn", "all"
    (quads and pentagons over independent v/vt/vn index spaces) or
    "negative" (relative indices mixed with absolute ones)."""
    rng = np.random.default_rng(seed)
    V, _, N, T, _ = _mesh(seed)
    n_n, n_t = 25, 30
    lines = ["# seeded test mesh", "o part"]
    lines += [f"v {x} {y} {z}" for x, y, z in V]
    if kind in ("vt", "all", "negative"):
        lines += [f"vt {u} {v}" for u, v in T[:n_t]]
    if kind in ("vn", "all", "negative"):
        lines += [f"vn {x} {y} {z}" for x, y, z in N[:n_n]]
    for i in range(60):
        n = 3 if kind in ("v", "vt", "vn") else 3 + i % 3
        toks = []
        for _ in range(n):
            p = int(rng.integers(1, len(V) + 1))
            t = int(rng.integers(1, n_t + 1))
            q = int(rng.integers(1, n_n + 1))
            if kind == "negative" and rng.random() < 0.5:
                p, t, q = p - len(V) - 1, t - n_t - 1, q - n_n - 1
            toks.append({"v": f"{p}", "vt": f"{p}/{t}", "vn": f"{p}//{q}"}
                        .get(kind, f"{p}/{t}/{q}"))
        lines.append("f " + " ".join(toks))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


OBJ_KINDS = ("v", "vt", "vn", "all", "negative")


@pytest.mark.parametrize("kind", OBJ_KINDS)
def test_obj_equals_jax(tmp_path, kind):
    """The port's default (native) OBJ parser gives JAX's arrays."""
    path = _write_obj(tmp_path / f"{kind}.obj", kind)
    _assert_mesh_equal(MT.load_obj(path), MJ.load_obj(path))
    _assert_mesh_equal(MT.load_mesh_file(path), MJ.load_mesh_file(path))


@pytest.mark.parametrize("kind", OBJ_KINDS)
def test_obj_native_equals_numpy(tmp_path, kind):
    path = _write_obj(tmp_path / f"{kind}.obj", kind, seed=3)
    _assert_mesh_equal(MT.load_obj(path, parser="numpy"),
                       MT.load_obj(path, parser="native"))


@pytest.mark.parametrize("kind", ("v", "vt", "vn", "all"))
def test_obj_unflipped_equals_jax_python_parser(tmp_path, kind):
    """``flip_tex_coords=False`` (the plain parser in both packages)."""
    path = _write_obj(tmp_path / f"{kind}.obj", kind, seed=5)
    _assert_mesh_equal(MT.load_obj(path, flip_tex_coords=False,
                                   parser="numpy"),
                       MJ.load_obj(path, flip_tex_coords=False))
    with pytest.raises(ValueError, match="flips"):
        MT.load_obj(path, flip_tex_coords=False)


def test_obj_negative_indices_geometry(tmp_path):
    """JAX's Python parser keys a vertex by its token's text, the native
    parsers by the indices it resolves to: on a file that names one
    vertex both ways the port has fewer duplicates, and the same
    triangles."""
    path = _write_obj(tmp_path / "neg.obj", "negative", seed=7)
    got = MT.load_obj(path, flip_tex_coords=False, parser="numpy")
    ref = MJ.load_obj(path, flip_tex_coords=False)
    assert len(got["vertices"]) < len(ref["vertices"])
    for k in ("vertices", "normals", "uvs"):
        np.testing.assert_array_equal(got[k][got["faces"]],
                                      ref[k][ref["faces"]], k)


def test_obj_refused_file_raises(tmp_path):
    """A face index past the records, or a token that is no number: the
    native parser refuses the file and the load raises (no fallback)."""
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 4\n")
    with pytest.raises(ValueError, match="refused"):
        MT.load_obj(str(bad))
    with pytest.raises(ValueError, match="out of range"):
        MT.load_obj(str(bad), parser="numpy")
    bad.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x\n")
    with pytest.raises(ValueError, match="refused"):
        MT.load_mesh_file(str(bad))
    with pytest.raises(FileNotFoundError):
        MT.load_obj(str(tmp_path / "missing.obj"))


def test_obj_native_build_failure_raises(tmp_path, monkeypatch):
    """Without the native library the OBJ load raises: it never slips to
    the Python parser."""
    path = _write_obj(tmp_path / "a.obj", "all")

    def no_build(spec):
        raise RuntimeError("g++ failed on meshio.cpp")

    monkeypatch.setattr(MT, "_lib", None)
    monkeypatch.setattr(MT._native, "load", no_build)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        MT.load_mesh_file(path)


def test_native_library_is_built_from_source(tmp_path):
    """``native/meshio.cpp`` is built into the port's ``_build/``; the
    committed ``native/libepsm_native.so`` is never loaded."""
    MT.load_obj(_write_obj(tmp_path / "a.obj", "v"))
    assert MT.SPEC.path.parent == _native.BUILD_DIR and MT.SPEC.path.exists()
    assert "libepsm_native" not in MT._lib._name
    with pytest.raises(ValueError, match="parser"):
        MT.load_obj(str(tmp_path / "a.obj"), parser="fast")


# -- PLY ----------------------------------------------------------------------

def _write_ply(path, binary, polygons, seed=1):
    """A PLY with positions, normals, (u, v), uchar colours and an extra
    float property; faces as triangles or as polygons of 3 to 5."""
    V, F, N, T, C = _mesh(seed)
    rng = np.random.default_rng(seed + 100)
    faces = [list(f) for f in F]
    if polygons:
        faces = [list(rng.integers(0, len(V), size=3 + i % 3))
                 for i in range(len(F))]
    head = ["ply", f"format {'binary_little_endian' if binary else 'ascii'}"
            " 1.0", "comment seeded", f"element vertex {len(V)}"]
    head += [f"property float {c}" for c in ("x", "y", "z", "nx", "ny", "nz",
                                              "u", "v", "quality")]
    head += [f"property uchar {c}" for c in ("red", "green", "blue")]
    head += [f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    q = rng.uniform(size=len(V)).astype(np.float32)
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if binary:
            vdt = np.dtype([(f"f{i}", "<f4") for i in range(9)]
                           + [(f"c{i}", "u1") for i in range(3)])
            rows = np.zeros(len(V), vdt)
            for i, col in enumerate((*V.T, *N.T, *T.T, q)):
                rows[f"f{i}"] = col
            for i in range(3):
                rows[f"c{i}"] = C[:, i]
            f.write(rows.tobytes())
            for face in faces:
                f.write(struct.pack("<B", len(face)))
                f.write(np.asarray(face, "<i4").tobytes())
        else:
            for i in range(len(V)):
                vals = [*V[i], *N[i], *T[i], q[i]]
                f.write((" ".join(str(x) for x in vals) + " "
                         + " ".join(str(int(c)) for c in C[i]) + "\n")
                        .encode())
            for face in faces:
                f.write((f"{len(face)} " + " ".join(str(int(x))
                                                    for x in face)
                         + "\n").encode())
    return str(path)


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("polygons", [False, True],
                         ids=["triangles", "polygons"])
def test_ply_equals_jax(tmp_path, binary, polygons):
    path = _write_ply(tmp_path / "m.ply", binary, polygons)
    got = MT.load_ply(path)
    assert set(got) == set(KEYS)
    _assert_mesh_equal(got, MJ.load_ply(path))
    _assert_mesh_equal(MT.load_mesh_file(path), MJ.load_mesh_file(path))


def test_ply_refusals(tmp_path):
    """A format other than ASCII or binary little endian, and a header
    without its end, raise."""
    path = _write_ply(tmp_path / "m.ply", True, False)
    data = open(path, "rb").read()
    big = tmp_path / "big.ply"
    big.write_bytes(data.replace(b"binary_little_endian",
                                 b"binary_big_endian"))
    with pytest.raises(ValueError, match="binary_big_endian"):
        MT.load_ply(str(big))
    cut = tmp_path / "cut.ply"
    cut.write_bytes(data[:data.index(b"end_header")])
    with pytest.raises(ValueError, match="end_header"):
        MT.load_ply(str(cut))
    not_ply = tmp_path / "x.ply"
    not_ply.write_text("obj\n")
    with pytest.raises(ValueError, match="not a PLY"):
        MT.load_ply(str(not_ply))


# -- serialized ---------------------------------------------------------------

def _serialized_body(seed, double, flags_extra):
    V, F, N, T, C = _mesh(seed, nv=20 + seed, nf=30)
    ft = "<f8" if double else "<f4"
    flags = 0x0001 | 0x0002 | flags_extra | (0x2000 if double else 0)
    body = (struct.pack("<I", flags) + f"mesh{seed}".encode() + b"\x00"
            + struct.pack("<QQ", len(V), len(F))
            + V.astype(ft).tobytes() + N.astype(ft).tobytes()
            + T.astype(ft).tobytes())
    if flags & 0x0008:
        body += (C / 255.0).astype(ft).tobytes()
    return body + F.astype("<u4").tobytes()


def _write_serialized(path, double):
    """Two meshes, each its own zlib stream after magic and version,
    then the u64 offset table and the count (format version 4)."""
    blob, offsets = b"", []
    for seed, extra in ((0, 0x0008), (1, 0)):
        offsets.append(len(blob))
        blob += (struct.pack("<HH", 0x041C, 4)
                 + zlib.compress(_serialized_body(seed, double, extra)))
    blob += struct.pack(f"<{len(offsets)}Q", *offsets)
    blob += struct.pack("<I", len(offsets))
    path.write_bytes(blob)
    return str(path)


@pytest.mark.parametrize("double", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("shape_index", [0, 1])
def test_serialized_equals_jax(tmp_path, double, shape_index):
    path = _write_serialized(tmp_path / "m.serialized", double)
    got = MT.load_serialized(path, shape_index)
    assert got["vertices"].shape == (20 + shape_index, 3)
    _assert_mesh_equal(got, MJ.load_serialized(path, shape_index))
    _assert_mesh_equal(MT.load_mesh_file(path, shape_index),
                       MJ.load_mesh_file(path, shape_index))
    with pytest.raises(ValueError, match="shape_index"):
        MT.load_serialized(path, 2)


def test_unknown_extension_raises(tmp_path):
    with pytest.raises(ValueError, match="Unsupported"):
        MT.load_mesh_file(str(tmp_path / "m.stl"))


def test_numpy_vertex_normals_equal_jax():
    V, F, *_ = _mesh(9)
    np.testing.assert_array_equal(MT.compute_vertex_normals(V, F),
                                  MJ.compute_vertex_normals(V, F))

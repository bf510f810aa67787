"""Mesh files: OBJ, PLY and Mitsuba's serialized format (counterpart of
``models/mesh_io.py``, the reference's src/shapes/{obj,ply,serialized}.cpp).

Parsing runs on the host and gives numpy arrays: float32 ``vertices``
(V, 3), int32 ``faces`` (F, 3) and, where the file has them, ``normals``
(V, 3), ``uvs`` (V, 2) and (PLY) ``colors`` (V, 3).

OBJ is parsed by ``native/meshio.cpp`` (``epsm_obj_parse``), compiled
from the checkout with ``g++`` into ``epsm_mitsuba3_torch/_build/`` at
first use (``ops/_native.py``).  ``load_obj(..., parser="numpy")`` is
its plain Python version, which gives the same arrays; the parser is
always the one the caller names: a failed build, a missing compiler or
a file the native parser refuses raises, and nothing falls back to the
other parser.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from ..ops import _native

SPEC = _native.Spec(name="meshio",
                    source=_native.REPO / "native" / "meshio.cpp",
                    compiler="g++", flags=_native.GXX_FLAGS)
PARSERS = ("native", "numpy")

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _native.load(SPEC)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.epsm_obj_parse.restype = ctypes.c_void_p
        lib.epsm_obj_parse.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.epsm_obj_copy.argtypes = [ctypes.c_void_p, f32p, f32p, f32p,
                                      ctypes.POINTER(ctypes.c_int32)]
        lib.epsm_obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _load_obj_native(path: str) -> dict:
    lib = _load()
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    hn, hu = ctypes.c_int32(), ctypes.c_int32()
    h = lib.epsm_obj_parse(os.fsencode(path), ctypes.byref(nv),
                           ctypes.byref(nf), ctypes.byref(hn),
                           ctypes.byref(hu))
    if not h:
        raise ValueError(f"{path}: the OBJ parser refused the file (a "
                         "face token that is not a number, or an index "
                         "out of range)")
    try:
        pos = np.empty((nv.value, 3), np.float32)
        nrm = np.empty((nv.value, 3), np.float32)
        uv = np.empty((nv.value, 2), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.epsm_obj_copy(h, pos.ctypes.data_as(f32p),
                          nrm.ctypes.data_as(f32p), uv.ctypes.data_as(f32p),
                          faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.epsm_obj_free(h)
    out = {"vertices": pos, "faces": faces}
    if hn.value:
        out["normals"] = nrm
    if hu.value:
        out["uvs"] = uv
    return out


def _floats(text: str, n: int):
    """The first ``n`` numbers of ``text`` as float32, 0 for each one
    missing (``strtof`` stops at the first token that is no number)."""
    out = []
    for tok in text.split()[:n]:
        try:
            out.append(np.float32(tok))
        except ValueError:
            break
    return out + [np.float32(0.0)] * (n - len(out))


def _load_obj_numpy(path: str, flip_tex_coords: bool) -> dict:
    """The native parser's semantics in Python: a vertex is one distinct
    (position, texcoord, normal) index triple, negative indices count
    back from the records read so far, a polygon becomes a fan, and the
    flip is ``1 - v`` in float32."""
    positions, normals, texcoords = [], [], []
    vert_map = {}
    out_pos, out_nrm, out_uv, faces = [], [], [], []
    zero3 = [np.float32(0.0)] * 3
    one = np.float32(1.0)

    def index(tok: str, n: int, what: str) -> int:
        i = int(tok)
        i = i - 1 if i > 0 else n + i
        if not 0 <= i < n:
            raise ValueError(f"{path}: {what} index {tok} out of range")
        return i

    def resolve(token: str) -> int:
        parts = token.split("/")
        try:
            pi = index(parts[0], len(positions), "position")
            ti = (index(parts[1], len(texcoords), "texcoord")
                  if len(parts) > 1 and parts[1] else -1)
            ni = (index(parts[2], len(normals), "normal")
                  if len(parts) > 2 and parts[2] else -1)
        except ValueError as e:
            raise ValueError(f"{path}: face token {token!r}: {e}") from None
        key = (pi, ti, ni)
        if key not in vert_map:
            vert_map[key] = len(out_pos)
            out_pos.append(positions[pi])
            out_nrm.append(normals[ni] if ni >= 0 else None)
            if ti >= 0:
                u, v = texcoords[ti]
                out_uv.append((u, one - v) if flip_tex_coords else (u, v))
            else:
                out_uv.append(None)
        return vert_map[key]

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.lstrip(" \t\r")
            if line[:2] in ("v ", "v\t"):
                positions.append(_floats(line[2:], 3))
            elif line.startswith("vn"):
                normals.append(_floats(line[3:], 3))
            elif line.startswith("vt"):
                texcoords.append(_floats(line[3:], 2))
            elif line[:2] in ("f ", "f\t"):
                idx = [resolve(t) for t in line[2:].split("#")[0].split()]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))

    result = {"vertices": np.asarray(out_pos, np.float32).reshape(-1, 3),
              "faces": np.asarray(faces, np.int32).reshape(-1, 3)}
    if any(n is not None for n in out_nrm):
        result["normals"] = np.asarray(
            [zero3 if n is None else n for n in out_nrm], np.float32)
    if any(u is not None for u in out_uv):
        result["uvs"] = np.asarray(
            [zero3[:2] if u is None else u for u in out_uv], np.float32)
    return result


def load_obj(path: str, flip_tex_coords: bool = True,
             parser: str = "native") -> dict:
    """Wavefront OBJ: polygons triangulated as fans, the v/vt/vn index
    spaces resolved per vertex (obj.cpp:176-280).  ``parser``: "native"
    (``native/meshio.cpp``, which always flips the texture's v) or
    "numpy" (its plain version)."""
    if parser not in PARSERS:
        raise ValueError(f"parser '{parser}': one of {PARSERS}")
    if parser == "native":
        if not flip_tex_coords:
            raise ValueError("the native OBJ parser flips v; use "
                             "parser='numpy' for flip_tex_coords=False")
        return _load_obj_native(path)
    return _load_obj_numpy(path, flip_tex_coords)


_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
    "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4",
}
_PLY_FORMATS = ("ascii", "binary_little_endian")


def load_ply(path: str) -> dict:
    """PLY, ASCII or binary little endian (ply.cpp); any other format
    raises.  Polygons become fans; colours above 1 are scaled by 1/255."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        # (name, count, [(prop, type)] or [("list", count_t, index_t, name)])
        elements = []
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: the PLY header has no end_header")
            line = raw.strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
                if fmt not in _PLY_FORMATS:
                    raise ValueError(f"{path}: PLY format '{fmt}' is not "
                                     f"read; one of {_PLY_FORMATS}")
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elements.append([name, int(cnt), []])
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3],
                                            parts[4]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif line == "end_header":
                break

        verts = norms = uvs = colors = None
        faces = []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    arr = np.asarray(rows, np.float32)
                    verts, norms, uvs, colors = _ply_vertex_cols(
                        arr, [p[0] for p in props])
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        idx = [int(x) for x in r[1:n + 1]]
                        for k in range(1, n - 1):
                            faces.append((idx[0], idx[k], idx[k + 1]))
            elif name == "vertex":
                dt = np.dtype([(p[0], "<" + _PLY_TYPES[p[1]])
                               for p in props])
                data = np.frombuffer(f.read(dt.itemsize * count), dt)
                cols = [p[0] for p in props]
                arr = np.stack([data[c].astype(np.float32) for c in cols],
                               axis=-1)
                verts, norms, uvs, colors = _ply_vertex_cols(arr, cols)
            elif name == "face":
                faces = _ply_binary_faces(f, count, props[0])

    result = {"vertices": verts,
              "faces": np.asarray(faces, np.int32).reshape(-1, 3)}
    if norms is not None:
        result["normals"] = norms
    if uvs is not None:
        result["uvs"] = uvs
    if colors is not None:
        result["colors"] = colors
    return result


def _ply_binary_faces(f, count, prop):
    """The fan triangles of ``count`` binary faces: at once where every
    face is a triangle, else face by face."""
    _, cnt_t, idx_t, _ = prop
    cnt_dt = np.dtype("<" + _PLY_TYPES[cnt_t])
    idx_dt = np.dtype("<" + _PLY_TYPES[idx_t])
    start = f.tell()
    tri_dt = np.dtype([("n", cnt_dt), ("i", idx_dt, (3,))])
    block = f.read(tri_dt.itemsize * count)
    if len(block) == tri_dt.itemsize * count:
        tris = np.frombuffer(block, tri_dt)
        if np.all(tris["n"] == 3):
            return tris["i"].astype(np.int64)
    f.seek(start)
    faces = []
    for _ in range(count):
        n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
        idx = np.frombuffer(f.read(idx_dt.itemsize * n), idx_dt)
        for k in range(1, n - 1):
            faces.append((int(idx[0]), int(idx[k]), int(idx[k + 1])))
    return faces


def _ply_vertex_cols(arr, cols):
    def get3(names):
        if all(n in cols for n in names):
            return np.stack([arr[:, cols.index(n)] for n in names], -1)
        return None

    verts = get3(["x", "y", "z"])
    norms = get3(["nx", "ny", "nz"])
    uv = None
    for names in (["u", "v"], ["s", "t"], ["texture_u", "texture_v"]):
        if all(n in cols for n in names):
            uv = np.stack([arr[:, cols.index(n)] for n in names], -1)
            break
    colors = get3(["red", "green", "blue"])
    if colors is not None and colors.max() > 1.0:
        colors = colors / 255.0
    return verts, norms, uv, colors


def load_serialized(path: str, shape_index: int = 0) -> dict:
    """Mitsuba's .serialized meshes (serialized.cpp): magic 0x041C (u16)
    and version (u16), then one zlib stream a mesh: flags u32, [name
    \\0], vertex_count u64, face_count u64, positions, [normals],
    [texcoords], [colours], faces u32; float64 where flag 0x2000 is set.
    A table of mesh offsets and their count ends the file."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<HH", data, 0)
    if magic != 0x041C:
        raise ValueError(f"{path}: not a .serialized mesh (magic {magic:#x})")

    count = struct.unpack_from("<I", data, len(data) - 4)[0]
    off_size = 8 if version >= 4 else 4
    table_start = len(data) - 4 - count * off_size
    offsets = struct.unpack_from(
        f"<{count}{'Q' if off_size == 8 else 'I'}", data, table_start)
    if shape_index >= count:
        raise ValueError(f"{path}: shape_index {shape_index} >= {count}")

    start = offsets[shape_index] + 4  # past the mesh's magic and version
    raw = zlib.decompress(data[start:table_start])

    pos = 0
    (flags,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    if version >= 4:  # a null-terminated name
        pos = raw.index(b"\x00", pos) + 1
    v_count, f_count = struct.unpack_from("<QQ", raw, pos)
    pos += 16
    double_prec = bool(flags & 0x2000)
    fsize = 8 if double_prec else 4
    ftype = "<f8" if double_prec else "<f4"

    def read_block(n):
        nonlocal pos
        arr = np.frombuffer(raw, ftype, count=n, offset=pos)
        pos += n * fsize
        return arr.astype(np.float32)

    result = {"vertices": read_block(v_count * 3).reshape(-1, 3)}
    if flags & 0x0001:  # normals
        result["normals"] = read_block(v_count * 3).reshape(-1, 3)
    if flags & 0x0002:  # texcoords
        result["uvs"] = read_block(v_count * 2).reshape(-1, 2)
    if flags & 0x0008:  # vertex colours, skipped
        read_block(v_count * 3)
    faces = np.frombuffer(raw, "<u4", count=f_count * 3, offset=pos)
    result["faces"] = faces.astype(np.int32).reshape(-1, 3)
    return result


def load_mesh_file(path: str, shape_index: int = 0) -> dict:
    """The loader of ``path``'s extension (OBJ through the native
    parser)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    if ext == ".serialized":
        return load_serialized(path, shape_index)
    raise ValueError(f"Unsupported mesh format: {path}")


def compute_vertex_normals(vertices: np.ndarray,
                           faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals (mesh.cpp
    ``recompute_vertex_normals``), numpy; ``ops/normals.py`` has the
    angle-weighted, differentiable one."""
    p0 = vertices[faces[:, 0]]
    p1 = vertices[faces[:, 1]]
    p2 = vertices[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-20)).astype(np.float32)

"""The inputs and launch rules of kernel K1 (brute-force Moeller-Trumbore),
on the CPU: the 48-byte rows ``pack_tris`` makes, the plain versions on
them, the compiled launch configurations, and the rule that picks R, the
row split, the any hit's schedule and the tile for a triangle count, a ray
count and a shared-memory budget."""
import re

import numpy as np
import pytest
import torch

from epsm_mitsuba3_torch.ops import _native
from epsm_mitsuba3_torch.ops import cuda_intersect as CI
from epsm_mitsuba3_torch.ops import intersect as I

H100_SMS = 132
H100_BUDGET = 232448


def _soup(n_tris, n_rays, seed):
    r = np.random.default_rng(seed)
    verts = torch.from_numpy(r.uniform(-1, 1, (3 * n_tris, 3))
                             .astype(np.float32))
    faces = torch.arange(3 * n_tris, dtype=torch.int32).reshape(n_tris, 3)
    o = torch.from_numpy(r.uniform(-2, 2, (n_rays, 3)).astype(np.float32))
    d = torch.from_numpy(r.uniform(-0.8, 0.8, (n_rays, 3))
                         .astype(np.float32)) - o
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    maxt = torch.from_numpy(np.where(r.random(n_rays) < 0.3,
                                     r.uniform(0.5, 4, n_rays), np.inf)
                            .astype(np.float32))
    maxt[torch.from_numpy(r.random(n_rays) < 0.1)] = 0.0
    return verts, faces, o, d, maxt


@pytest.mark.parametrize("n_tris", [1, 12, 300])
def test_pack_tris_rows(n_tris):
    """(F, 12) contiguous rows: the first 9 columns are the former rows
    [p0, p1 - p0, p2 - p0], the last 3 zero."""
    verts, faces, *_ = _soup(n_tris, 1, n_tris)
    tri = CI.pack_tris(verts, faces)
    assert tri.shape == (n_tris, 12) and tri.dtype == torch.float32
    assert tri.is_contiguous()
    p0, p1, p2 = (verts[faces[:, k].long()] for k in range(3))
    assert torch.equal(tri[:, :9], torch.cat([p0, p1 - p0, p2 - p0], -1))
    assert not tri[:, 9:].any()
    assert tri.shape[1] * 4 == CI.ROW_BYTES


@pytest.mark.parametrize("n_tris,chunk", [(40, 512), (300, 512), (300, 7)])
def test_plain_versions_on_padded_rows(n_tris, chunk):
    """The plain versions read the first 9 columns: the 12-column rows
    give the 9-column rows' results exactly."""
    verts, faces, o, d, maxt = _soup(n_tris, 2000, n_tris + 1)
    tri = CI.pack_tris(verts, faces)
    tri9 = tri[:, :9].contiguous()
    got = I.ray_intersect_brute(tri, o, d, maxt, chunk)
    ref = I.ray_intersect_brute(tri9, o, d, maxt, chunk)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ = I.ray_test_brute(tri, o, d, maxt, chunk)
    assert torch.equal(occ, I.ray_test_brute(tri9, o, d, maxt, chunk))
    assert torch.equal(occ, got[1] >= 0)
    assert 0.1 < float(occ.float().mean()) < 0.95


def test_wrapper_takes_only_padded_rows():
    verts, faces, o, d, maxt = _soup(4, 8, 0)
    tri = CI.pack_tris(verts, faces)
    with pytest.raises(ValueError):
        CI.closest_hit(tri[:, :9].contiguous(), o, d, maxt)
    with pytest.raises(ValueError):
        CI.any_hit(tri[:, :9].contiguous(), o, d, maxt)


def _compiled(macro):
    src = (_native.PKG / "csrc" / "mt_intersect.cu").read_text()
    lines = src[src.index(f"#define {macro}("):].splitlines()
    end = next(i for i, line in enumerate(lines) if not line.endswith("\\"))
    body = "\n".join(lines[:end + 1])
    return [tuple(int(x) for x in m.split(","))
            for m in re.findall(r"X\(([\d, ]+)\)", body)]


def test_configs_are_compiled():
    """The wrapper's configuration lists are the ones the source
    instantiates, and every design step is a compiled launch."""
    assert set(_compiled("EPSM_K1_CONFIGS")) == set(CI.CONFIGS)
    assert {r for (r,) in _compiled("EPSM_K1_LANES_RAYS")} == set(
        CI.LANES_RAYS)
    assert {k for (k,) in _compiled("EPSM_K1_WARP_ROWS")} == set(
        CI.WARP_ROWS)
    for name, v in CI.STEPS.items():
        assert name in CI.CLOSEST_STEPS or name in CI.ANY_STEPS, name
    for kind in ("closest", "any"):
        assert not CI._fits(CI.Launch(1), kind)
        assert not CI._fits(CI.Launch(3), kind)
    assert not CI._fits(CI.Launch(1, any="warp", rows=3), "any")
    assert not CI._fits(CI.Launch(4, 8), "any")
    assert not CI._fits(CI.Launch(1, any="warp"), "closest")


@pytest.mark.parametrize("n_tris,budget,tile,expect", [
    (12, H100_BUDGET, 5000, 12),
    (4096, H100_BUDGET, 5000, 4096),    # the whole table fits: 196,608 B
    (4842, H100_BUDGET, 5000, 4842),
    (5000, H100_BUDGET, 5000, 4842),    # tiles of as many rows as fit
    (5000, H100_BUDGET, 1024, 1024),
    (12, H100_BUDGET, 1024, 12),
    (4096, 48 * 100, 1024, 100),
    (4096, 48, 1024, 1)])
def test_tile_rows(n_tris, budget, tile, expect):
    assert CI.tile_rows(n_tris, budget, tile) == expect
    if tile == CI.TILE_ROWS:
        assert CI.tile_rows(n_tris, budget) == expect


def test_tile_rows_refuses_no_room():
    with pytest.raises(ValueError):
        CI.tile_rows(12, CI.ROW_BYTES - 1)


RAY_COUNTS = (1, 65536, CI.FULL_RAYS - 1, CI.FULL_RAYS, 2 ** 21)


@pytest.mark.parametrize("n_tris", [1, 12, 63, 64, 127, 128, 4096, 5000,
                                    64812])
def test_launch_rule(n_tris):
    """The rule names a compiled launch of each kind, in tiles of at most
    TILE_ROWS rows, for any ray count.  From FULL_RAYS rays on the closest
    hit takes R = 4 rays a thread; below, R = 2, or from SPLIT_MIN_TRIS
    rows on R = 4 for each 8 lanes.  The any hit takes R = 4 below
    WARP_MIN_TRIS rows, else goes warp-wide, 64 rows a step below
    FULL_RAYS rays from WIDE_MIN_TRIS rows on, else 32."""
    for n_rays in RAY_COUNTS:
        full = n_rays >= CI.FULL_RAYS
        for kind in ("closest", "any"):
            v = CI.launch_rule(n_tris, n_rays, kind)
            assert CI._fits(v, kind), (kind, v)
            rows = CI.tile_rows(n_tris, H100_BUDGET, v.tile)
            assert rows == min(n_tris, CI.TILE_ROWS)
        occ = CI.launch_rule(n_tris, n_rays, "any")
        assert (occ.any == "warp") == (n_tris >= CI.WARP_MIN_TRIS)
        wide = not full and n_tris >= CI.WIDE_MIN_TRIS
        assert (occ.rays, occ.rows) == (
            (1, 2 if wide else 1) if occ.any == "warp" else (4, 1))
        v = CI.launch_rule(n_tris, n_rays, "closest")
        assert (v.rays, v.split) == (
            (4, 1) if full else (4, 8) if n_tris >= CI.SPLIT_MIN_TRIS
            else (2, 1))


def test_rule_picks_every_step():
    """Every compiled launch is one the rule picks at some triangle and
    ray count, and each is a step that ``chip_smoke.py`` times: no launch
    is compiled that the main path cannot reach."""
    picked = {kind: {CI.launch_rule(f, n, kind)
                     for f in (1, CI.WARP_MIN_TRIS, CI.SPLIT_MIN_TRIS,
                               CI.WIDE_MIN_TRIS)
                     for n in RAY_COUNTS}
              for kind in ("closest", "any")}
    assert picked["closest"] == {CI.STEPS[k] for k in CI.CLOSEST_STEPS}
    assert picked["any"] == {CI.STEPS[k] for k in CI.ANY_STEPS}
    assert {(v.rays, v.split) for v in picked["closest"]} == set(CI.CONFIGS)
    assert {v.rays for v in picked["any"] if v.any == "lanes"} == set(
        CI.LANES_RAYS)
    assert {v.rows for v in picked["any"] if v.any == "warp"} == set(
        CI.WARP_ROWS)


def test_tiles_leave_room_for_four_blocks():
    """A tile of TILE_ROWS rows takes at most a quarter of an H100 SM's
    228 KB of shared memory, with its 1 KB a block reserved."""
    assert 4 * (CI.TILE_ROWS * CI.ROW_BYTES + 1024) <= 228 * 1024

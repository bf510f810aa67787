#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every
hand-written kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failed check raises, and the script exits non-zero):

1. build kernels K1 (``csrc/mt_intersect.cu``) and K2/K4/K3
   (``csrc/bvh_traverse.cu``) with nvcc for sm_90a and the BVH builder
   (``native/bvh.cpp``) and the OBJ parser (``native/meshio.cpp``) with
   g++, all at once, and print the card's name
   and power limit and each kernel's registers, stack and spills (K4's
   by instantiation);
2. K1's closest-hit and any-hit entries against the plain versions on the
   card, bit for bit, at three shapes: (i) the Cornell box's 12 triangles
   against 2^20 camera and bounce rays, some dead; (ii) the largest scene
   K1 serves, 4,096 triangles, against 65,536 rays; (iii) the same against
   2^20 rays, a user's pass; the main path's launch, every step of
   ``cuda_intersect.STEPS`` and 1,000-row tiles, each timed on the device
   alone beside the bound (the plain versions timed at (i) and (ii)); then
   the rays one 4-spp box pass hands to ``closest_hit`` / ``any_hit``
   (wrapped in this script), held bit for bit and timed depth by depth;
   then every step at 12 to 4,096 triangles and 2^16 to 2^21 rays, held
   bit for bit and timed beside the launch ``launch_rule`` picks;
3. the Cornell box's primal render at full width: ``render(load_dict(
   cornell_box(512, 64, 6)), spp=64, spp_chunk=4)``: a warm-up and three
   timed renders, with the launch counts set to 0 before and read after
   each;
4. K2/K3 against their plain versions on ``cornell_box_mesh``'s 2^21
   camera and bounce rays (a tenth dead), bit for bit (0 lanes may
   differ), as is the reference (K2's former one-thread-a-ray walk), and
   on 65,536 of them against K1's plain brute force over all 64,812
   triangles; the stack-overflow flag stays 0;
5. K4 at P = 2 and 4 on the same rays against its plain version (every
   output equal, for the main path's launch and each design step of
   ``cuda_traverse.K4_STEPS``), against K2 (t and valid equal, tie rays
   counted) and against the brute force; then the times of K2, the
   reference, K3 and K4 at both widths, with the rays unsorted,
   Morton-sorted (sort included) and pre-sorted, in two rounds (the
   second reversed), beside the plain versions' and the bound, K2, K3
   and K4 also on device time alone; every K4 launch at both widths on
   device time alone beside K2 and the reference; K2 and K3 at each
   design step, each equal to the main path's launch; the lane
   utilisation of K2, K4 at both widths and the reference (counting
   builds); and, on the rays one 8-spp mesh pass hands to
   ``closest_hit`` / ``any_hit`` (the two wrapped in this script), K2
   and K3 against the reference, K4 against its plain version, all
   timed, depth by depth;
6. the mesh's primal render at full width: ``render(load_dict(
   cornell_box_mesh(512, 8, 6)), spp=16, spp_chunk=8)``, each launching
   K2 and K3 12 times and K1 never;
7. both scenes rendered small on the card and on the CPU;
8. bench.py's fwd+bwd cells at full width, the loss ``mean(img^2)``
   differentiated w.r.t. the vertices, reflectances and radiance: the
   box, 16 passes of 1,048,576 lanes (K1 6 + 6 launches in each forward),
   and the mesh, 2 passes of 2,097,152 lanes (K2 and K3 6 each), again
   with ``multi_pop`` 4 (K4 6, K2 none) and the gradients compared; no
   kernel launches in any backward; a warm-up and 3 timed runs each, and
   one profiled pass each (the mesh's with K2 and with K4);
9. three iterations of ``app/optim.run("prb_hybrid", ...)`` at thres 0
   on the mesh at 512^2
   x 8 spp, theta a translation of the sphere through ``set_vertices``;
   then K2 on the re-packed scene against K1's brute force over the moved
   vertices;
10. the fwd+bwd gradients at 64^2 x 4 spp on the card against the CPU's,
    for both scenes;
11. [epsm mesh]: bench.py's ``manifold_iter`` at its own size, the
    ``manifold`` integrator on cornell_box_mesh at 128^2 x 8 spp with the
    Sinkhorn matcher at 128^2: a warm-up and 4 timed iterations, ms by
    phase (forward render, Sinkhorn match, logged pass, first hit,
    Jacobians, solves, injection, PRB recording pass and replay) by CUDA
    events, K2/K3 launches an iteration (exactly 25 / 18), the gradient
    finite and non-zero, peak memory, one profiled iteration;
12. [epsm cornellbox]: ``app/optim.run("manifold_caustic_hybrid", ...)``
    on ``app/exp/cornellbox.make`` at 512^2, six lights, depth 6,
    match_res 128, spp 32 (published 256) and a 64-spp ground truth, 3
    iterations at thres 2 (the switch to PRB and the Adam reset run): ms,
    loss, theta and K1 launches an iteration, each count exact;
13. [epsm card vs cpu]: a manifold_caustic theta gradient on cornellbox at
    32^2 on the card and on the CPU, and the Sinkhorn matcher at 64^2
    (the mesh phase's 128^2 inputs resized) on the card and the CPU
    against float64;
14. [epsm experiments]: ``run`` on ``app/exp``'s egg (a glass sphere,
    manifold_caustic, depth 6), glossyball (a GGX rough-conductor sphere,
    theta its translation and roughness), highlight (a rough-conductor
    floor) and shadow (400 spheres, 1,587,204 triangles in a BVH) at
    512^2, match_res 128, 2 iterations each (spp and ground truth cut,
    ``EXP_CELLS``): ms an iteration and by phase, launches (each count
    exact), theta and its gradients finite and non-zero, peak memory,
    a config's device busy share where ``EXP_PROFILED`` names it (none
    now), shadow's BVH build and
    refit + re-pack; bunny, bathroom and bedroom one iteration each; K1
    on one egg pass's rays and K2/K3 on one shadow pass's rays, each held
    bit for bit against its plain version and timed beside its bound; the
    card against the CPU on glossyball's theta gradients and egg's
    glass-vertex gradients at 64^2 x 4 spp;
15. [scene files]: ``cornell_box_mesh(512, 16, 6)`` written to a
    temporary directory (the sphere a binary PLY with vertex normals, the
    floor an OBJ, the back wall a .serialized file, the XML through
    ``dict_to_xml`` with a ``$spp`` parameter) and loaded with
    ``load_file``: arrays, BVH and K2/K3 records bit for bit
    ``load_dict``'s, the 512^2 x 16 spp renders (passes of 8) bit for
    bit, with exact K2/K3 counts; parse, mesh-load, BVH-build and render
    times; ``cli.main`` to an EXR equal to ``render``'s image;
    ``traverse().update()`` moving the sphere against ``set_vertices``,
    then K2 on the re-packed tree against K1's brute force;
16. [glassslab]: ``run("manifold_caustic", glassslab.make(...))`` at the
    published widths (512^2, spp 64, depth 4, match_res 256, grid 16),
    ground truth 64 spp, 1 iteration (of 1,000): ms an iteration and by
    phase, K1 launches (each count exact), the normal field and its
    gradient finite and non-zero, peak memory; the normal-field gradient
    on the card against the CPU at 64^2 x 4 spp;
17. [camera]: the box (K1) and the mesh (K2/K3) rendered at 512^2 with no
    rfilter (the hdrfilm's default gaussian, splatted by the roll-sum
    ``splat_coalesced``) and the stratified sampler, at 64 and 16 spp
    (launches exact, wall ms, peak memory, one profiled pass each); the
    mesh's fwd+bwd cell with the same film; the gaussian film of one
    pass on its own (ms, launches and memory of the film, its adjoint and
    the general scatter ``splat``; the roll-sum bit for bit alike from
    run to run, the scatter within 1e-5); two ``manifold`` iterations of
    the epsm-mesh cell with a gaussian sensor on a stratified scene, whose
    passes must seed the independent sampler (PRB the scene's); and the
    card against the CPU at 64^2: every filter with the independent and
    the stratified sampler, each sampler kind at spp 16 and 9, each
    sensor kind (a thin lens of aperture 0.08, a batch sensor of two
    views), PRB gradients through two films, the manifold backward;
18. [emitters]: the box (K1) at 512^2 x 64 spp with each new light kind
    beside its area light (point, spot, directional, constant, a 512 x
    1024 envmap written as EXR and loaded by file name, a projector with
    a checkerboard, directionalarea on the ceiling light), the constant
    light alone and no emitter (exactly 0): a warm-up and 1 timed render
    each, K1 launches exact, one profiled pass, peak memory; the mesh's
    fwd+bwd cell with the envmap and a point light (K2/K3 exact, the
    gradients of the vertices through set_vertices, of radiance,
    intensity and the texels finite and non-zero); one manifold
    iteration of the epsm-mesh cell with a constant light after the area
    light (ms by phase); the envmap sampler alone at 2^20 lanes, the
    bisection against the compare-sum (ms, memory, equal texels); the
    card against the CPU at 64^2 for every case (images), each new kind's
    PRB gradients and the manifold backward with the constant light;
19. [textures]: a 1,024^2 reflectance bitmap and a 512^2 normal map made
    from the seed (smooth random fields) and written as EXR: the box (K1) at 512^2 x 64 spp with
    the bitmap on the back wall, a checkerboard on the floor, the normal
    map on the left wall, a ``regular`` spectrum on the right wall and an
    ``irregular`` one as the light's radiance (a warm-up and 1 timed
    render, K1 launches exact, the image finite and not flat, one
    profiled pass); the mesh's fwd+bwd cell with a ``mesh_attribute``
    sphere (vertex colours from the positions), the bitmap and the normal
    map (K2/K3 exact, none in the backward; the gradients of the
    vertices, the texels, the reflectances and the vertex colours finite
    and non-zero; Mrays/s, peak memory); one manifold iteration of the
    epsm-mesh cell with the bitmap and the normal map (ms by phase); the
    card against the CPU at 64^2: both scenes' images and PRB gradients
    and the textured box's manifold backward;
20. [bsdfs]: the remaining scalar BSDFs, ``mask`` and Beckmann: the box
    (K1, 20 triangles) at 512^2 x 64 spp with a Beckmann rough plastic
    floor, a principled back wall under a mask of textured opacity, a
    blend of a textured plastic and a Beckmann rough dielectric, a
    two-sided principledthin wall and thin-dielectric, null, pplastic and
    rough-dielectric quads (a warm-up pass and one timed render, K1
    launches exact, the image finite and not flat, one profiled pass); the
    mesh's fwd+bwd cell (a warm-up pass and one timed run) with a
    Beckmann rough dielectric sphere, a rough plastic floor and a blend
    wall (K2/K3 exact, none in the backward;
    the gradients of the vertices, alpha, diffuse_reflectance,
    reflectance, blend_weight and eta finite and non-zero; one profiled
    pass); one manifold iteration of the epsm-mesh cell with a rough
    plastic sphere and a mask (K2/K3 25 / 18, the theta and alpha
    gradients); the card against the CPU at 64^2: both scenes' images
    and PRB gradients, and the manifold backward of the box without its
    null-lobe quads;
21. [human]: ``optim_human.run("manifold")`` on ``human.make()`` at the
    published 512^2, spp 64 (one pass), depth 3, match_res 256 and 72-d
    pose, ground truth at 256 spp, 1 iteration (of 1,000): ms an
    iteration and by phase (ground truth, stage-1 render, match, stage-2
    render and backward, the skinning's forward and VJP, Adam), K1
    launches an iteration (each count exact), peak memory, the busy share
    and K1's share of the iteration under the profiler (from the ground
    truth's end), each pose
    gradient finite, non-zero on joints 16-19 and zero on the leaf joints
    10, 11, 22, 23; K1 on one 8-spp pass of the body's rays, held bit for
    bit and timed beside its bound; a synthetic release-sized SMPL file
    (7,200 vertices, 13,824 faces) through ``load_npz``: one
    ``pose_gradient`` with K2/K3 launches exact and one BVH refit, then K2
    on the posed body against K1's brute force;
    ``run_experiments.main(["manifold", "human", "--small"])`` in a
    temporary directory (launches exact, the logger's files), then
    ``optim.run`` with ``checkpoint_every`` 1 stopped after 2 iterations
    and resumed (the loaded optimizer bit for bit the saved one, on the
    card); the pose gradient on the card against the CPU at 64^2 x 4 spp.
22. [reparam]: ``optim_human.run("prb_reparam")`` on ``human.make()`` at
    the [human] widths (512^2, spp 64 in one pass, depth 3, the MSE
    loss), 1 iteration: ms an iteration and by phase, K1 launches an
    iteration (each count exact: the backward's auxiliary rays, 16 a
    warp, 6 warps in every lane chunk of ``ad/prb.py`` REPARAM_CHUNK),
    peak memory by phase, the busy share of the iteration, each
    pose gradient finite, non-zero on joints 16-19 and zero on the leaf
    joints; the JAX package's silhouette check (tests/test_reparam.py:
    44-75) on the blocker scene: detached PRB misses the moving shadow
    edge, prb_reparam within 0.3-3 times the finite difference; one
    prb_reparam fwd+bwd pass of cornell_box_mesh at 512^2 x 4 spp, depth
    3, its auxiliary rays all K2 (exact); the card against the CPU at
    64^2 (the box with face normals, the blocker scene): images and the
    gradients of the vertices, reflectances, radiance and sensor pose;
23. [forward]: ``render_forward`` (a warm-up and one timed call) on the
    box at 512^2 x 4 spp, depth 6 (tangents on the reflectances and the
    radiance; K1 6 / 6, all the recording primal's: the replay traverses
    nothing), on ``cornell_box_mesh`` with sphere normals at 512^2 x 8
    spp (a vertex tangent; K2/K3 6 / 6) and through ``prb_reparam`` on
    the [reparam] mesh pass's cell (K2 3 + 96 auxiliary, exact); each
    <dimg, W> against the backward's d/dtheta <img, W> at the same seed
    (relative 2e-3, 2e-2 under prb_reparam), dimg finite and not zero;
    the card against the CPU at 64^2 (relative L2 <= 1e-3);
24. [direct]: ``direct`` on the box at 512^2 x 64 spp (K1) against path
    at depth 2 (means within 5 %) and on the mesh at 512^2 x 16 spp
    (K2/K3), launches exact, images not flat; one ``direct_reparam``
    fwd+bwd pass of the mesh with sphere normals and one
    ``emission_reparam`` pass of the box at 512^2 x 16 spp, 16 auxiliary
    rays (launches exact in both directions, the vertex gradients finite
    and non-zero); the JAX package's silhouette checks
    (tests/test_reparam.py:78-157) on the blocker scene and a moving
    light; the card against the CPU at 64^2 (images, gradients);
25. [outputs]: ``depth`` and ``aov`` (13 channels, depth 2) on the box at
    512^2 x 16 spp in passes of 4 (K1), ``depth`` on the mesh (K2, no
    K3), the centre pixel's depth in 3.0-5.5; ``moment`` at depth 4,
    512^2 x 64 spp (var >= -1e-4, its mean ``path``'s image at the same
    seed) and ``render_z_test`` against ``path`` at another seed (fail
    fraction < 1 %); ``ptracer`` on ``single_quad_direct`` (K1, mean
    within 5 % of ``path`` at depth 2) and on the mesh (K2/K3), K1 and
    K3 held against their plain versions on its camera-connection
    rays; ``spectral`` on the gray box (within 3 % of the RGB render),
    ``spectral_mono`` (within 5 % of the luminance) and
    ``spectral_spec`` (the red wall's long bins above its short ones),
    the fit's share of a profiled pass; launches exact throughout; the
    card against the CPU at 64^2 x 2 spp for the seven types.

26. [plugins]: ``cornell_box`` at 512^2 x 64 spp (16 passes of 2^20
    lanes, K1 exact) with an analytic sphere and a measured back wall
    (the JAX tests' synthetic Beckmann tensor file, written at run time):
    the sphere's pixels differ from the wall's behind it, the measured
    slot's GGX proxy passes a chi-square test on 2^20 draws; on the
    reference's ball scene at 512^2 the PRB centre and radius gradients
    are non-zero with the signs of central differences, and
    ``render_forward`` of a centre tangent agrees with the backward;
    ``cornell_box_mesh`` on the numpy-built tree (its build time and
    records beside the native tree's; K2/K3 bit for bit their plain
    versions on 2^18 of its rays; its 512^2 x 16 spp render equal to the
    native tree's but for tie rays; once more with a sphere); one
    manifold iteration of the epsm-mesh cell with a sphere (finite, the
    sphere's logged vertices ismesh 0); the box under the double variant
    (float64 within 2e-3 of float32, the same K1 launches, a float64 PRB
    gradient); the box with one plugin of each registry (launches exact,
    the registered BSDF's chi-square test); the card against the CPU at
    64^2 for each.
27. [stokes]: ``render(..., integrator={"type": "stokes"})`` on
    ``cornell_box`` at 512^2 x 64 spp (16 passes, K1 exact) with a linear
    polarizer plate and a conductor right wall (the plate's pixels' degree
    of polarization > 0.98, the conductor's > 0, S3 = 0); the diffuse box
    (S0 equal to ``path``'s image at the same seed, S1..S3 = 0); Malus's
    law through two plates against a constant light (0.5 cos^2 within
    0.01, the crossed plates dark); ``cornell_box_mesh`` with the plate at
    512^2 x 16 spp (K2/K3 exact); the box with a synthetic polarizing
    ``measured_polarized`` back wall (K1 exact; the table's degree of
    linear polarization within 1e-3 of 1 on 2^20 direction pairs); one
    ``prb`` fwd+bwd pass through the plate; the card against the CPU at
    64^2 (images within 1e-3 of the mean, the PRB gradient within 1e-3).

The last lines are one JSON line of kernel numbers and one JSON line
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1 and
prints no result.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; and FP32
#: instructions/s outside the tensor cores: 132 SMs x 128 FP32 lanes x
#: 1.98 GHz boost clock.  The data sheet's 67 TFLOP/s counts an FMA as two
#: operations; the kernels are built with --fmad=false and the counts
#: below count each multiply, add, min/max and compare as one.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 132 * 128 * 1.98e9
#: float arithmetic of one ray-triangle test in K1: cross products 2 x 9,
#: dot products 4 x 5, 1 reciprocal, 3 subtractions, 3 scalings, u + v
FLOP_PER_TEST = 18 + 20 + 1 + 3 + 3 + 1
#: FP32 operations of one slab test in K2/K3: 6 subtractions, 6
#: multiplies, 6 + 4 min/max, 3 compares
OPS_PER_SLAB = 6 + 6 + 10 + 3
#: K2 orders the pushed children: 12 compares of their keys a pop
OPS_PER_ORDER = 12
#: Cornell-box workload: 512^2, 64 spp in passes of 4, max depth 6 (one
#: closest-hit and one shadow query a bounce)
RES, SPP, SPP_CHUNK, DEPTH = 512, 64, 4, 6
#: BVH-slice workload (bench.py's ``bvh`` section): cornell_box_mesh at
#: 512^2, 16 spp in passes of 8, max depth 6
MESH_SPP, MESH_CHUNK = 16, 8
#: timed renders of the render cells (cut from 5 for the time limit)
TIMED_RENDERS = 3
#: fwd+bwd cells (bench.py's ``_bench_scene``): the box's 16 passes of 4
#: spp (``sec_toy``) and the mesh's 2 passes of 8 spp (``sec_bvh``)
BOX_PASSES, MESH_PASSES = 16, 2
#: the ground truth of the [adam] phase
ADAM_GT_SPP = 16
#: K1's launch-rule sweep: triangle counts from the box's 12 to the 4,096
#: that ``ops/accel.py`` sends to K1 at most with a BVH, ray counts from
#: 65,536 to one 512^2 x 8 spp pass
SWEEP_TRIS = (12, 32, 64, 128, 256, 512, 1024, 2048, 4096)
SWEEP_RAYS = tuple(2 ** k for k in range(16, 22))
#: [epsm mesh]: bench.py's ``manifold_iter`` (bench.py:196-236) at its own
#: size: cornell_box_mesh at 128^2 x 8 spp, depth 6, match_res 128 (the
#: reference's backward budget, 128^2 at spp 8), a warm-up and 4 timed
#: iterations
EPSM_RES, EPSM_SPP, EPSM_ITERS = 128, 8, 4
#: [epsm cornellbox]: app/exp/cornellbox.make at its published widths
#: (512^2, six lights, depth 6, match_res 128); spp 32 of the published
#: 256 and a ground truth at 64 spp of the default 512, to fit the time
#: limit; 3 iterations of manifold_caustic_hybrid with thres 2
CB_RES, CB_SPP, CB_GT_SPP, CB_ITERS, CB_THRES = 512, 32, 64, 3, 2
#: [epsm card vs cpu]: the matcher held card against CPU at 64^2 (the
#: mesh phase's 128^2 inputs resized): its CPU side at 128^2 took 168 s
#: of a run on a slow host, a seventh of the script's time limit
MATCH_CMP_RES = 64
#: [epsm experiments]: app/exp's egg, glossyball, highlight and shadow at
#: their published widths (512^2, match_res 128, each config's depth and
#: method; shadow's 400 spheres), EXP_ITERS iterations of run(); (config,
#: spp, ground-truth spp): spp cut from the published 256 (egg), 64
#: (highlight, shadow) and a ground truth of the default 512 cut, for the
#: time limit
EXP_RES, EXP_MATCH, EXP_ITERS = 512, 128, 2
EXP_CELLS = (("egg", 32, 32), ("glossyball", 32, 32), ("highlight", 32, 32),
             ("shadow", 16, 16))
#: the configs whose run ends with a profiled iteration: none, for the
#: script's time limit (egg's, ~50 s, last measured K1 at a quarter of
#: its busy time; the others' were cut before it)
EXP_PROFILED = ()
#: bunny, bathroom and bedroom (procedural stand-ins): one iteration each
#: at 512^2 and this spp (ground truth too)
EXP_ONE, EXP_ONE_SPP = ("bunny", "bathroom", "bedroom"), 4
#: [scene files]: cornell_box_mesh(512, 16, 6) written out (the sphere as a
#: binary PLY, the floor as an OBJ, the back wall as a .serialized file,
#: the scene as XML) and loaded back; rendered at the mesh cell's size,
#: 16 spp in passes of 8
SF_SPP, SF_CHUNK = 16, 8
#: [glassslab]: app/exp/glassslab.make at its published widths (512^2,
#: spp 64, depth 4, match_res 256, a 16 x 16 grid), ground truth 64 spp
#: (published 512), GS_ITERS iterations of run("manifold_caustic") of the
#: published 1,000
GS_SPP, GS_MATCH, GS_ITERS = 64, 256, 1

#: [human]: app/exp/human.make at its published widths (512^2, spp 64,
#: depth 3, match_res 256, the 72-d pose; the procedural body's 3,844
#: triangles with the floor and the light go to K1), HU_ITERS iterations
#: of optim_human.run("manifold") of the published 1,000, its ground truth
#: at min(4 x 64, 256) = 256 spp as the reference's; one render of the 64
#: spp a pass (the reference does not split it; 9.52 GiB at most), the
#: iteration profiled from the ground truth's end
HU_SPP, HU_MATCH, HU_ITERS = 64, 256, 1
#: K1 held and timed on the rays of one HU_RAYS_SPP-spp pass of the body
#: (2,097,152 lanes): the 64-spp pass cut, for the time limit (the
#: any-hit bound counts each live ray's tests)
HU_RAYS_SPP = 8
#: the synthetic release-sized body: one capsule a bone of HU_SEG rings of
#: HU_RING vertices (7,200 vertices, 13,824 faces; the SMPL release has
#: 6,890 and 13,776), its radii scaled by a draw from HU_SEED, rendered at
#: 512^2 x HU_BODY_SPP spp through the BVH (K2/K3)
HU_SEG, HU_RING, HU_SEED, HU_BODY_SPP = 24, 12, 15, 8
#: the leaf joints no bone has as parent: no vertex weights them
HU_LEAVES = (10, 11, 22, 23)
#: [reparam]: optim_human.run("prb_reparam") on human.make() at the
#: [human] widths (512^2, spp 64 in one pass, depth 3, the MSE loss, no
#: match), RP_ITERS iterations of the published 1,000, profiled from the
#: ground truth's end;
#: each backward's auxiliary rays (16 a reparameterisation, the default)
#: go to K1 in lane chunks of ad/prb.py REPARAM_CHUNK
RP_ITERS = 1
#: the silhouette check of the JAX package's tests/test_reparam.py:44-75:
#: blocker_scene at 24^2, depth 2, d/ddx of sum(img * x-ramp) by prb and
#: prb_reparam at 64 spp against a central difference of path at 256 spp
RP_SIL_RES, RP_SIL_SPP, RP_SIL_FD_SPP, RP_SIL_EPS = 24, 64, 256, 0.05
#: one prb_reparam fwd+bwd pass of cornell_box_mesh (sphere normals) at
#: 512^2 x RP_MESH_SPP spp, depth RP_MESH_DEPTH: its auxiliary rays go to
#: K2
RP_MESH_SPP, RP_MESH_DEPTH = 4, 3
#: [forward]: render_forward at the fwd+bwd cells' widths, a warm-up and
#: one timed call each: the box (cornell_box(512, 4, 6), tangents on the
#: reflectances and the radiance, K1), the mesh (cornell_box_mesh(512, 8,
#: 6) with sphere normals, a vertex tangent, K2/K3) and the [reparam]
#: mesh pass (512^2 x RP_MESH_SPP spp, depth RP_MESH_DEPTH, 16 auxiliary
#: rays, a vertex tangent, K2); <dimg, W> against the backward's
#: d/dtheta <img, W> at the same seed FW_SEED within FW_RTOL (FW_RTOL_RP
#: under prb_reparam), the bars of the JAX package's
#: tests/test_render_forward.py:52-71 and :147
FW_SEED, FW_RTOL, FW_RTOL_RP = 3, 2e-3, 2e-2
#: [direct]: direct on the box at 512^2 x DI_BOX_SPP spp (passes of
#: SPP_CHUNK) against path at max_depth 2 (means within DI_PATH_REL, the
#: JAX package's tests/test_integrators.py:17-22), on the mesh at 512^2 x
#: DI_MESH_SPP (passes of MESH_CHUNK); one direct_reparam fwd+bwd pass of
#: the mesh with sphere normals and one emission_reparam pass of the box,
#: 512^2 x DI_MESH_SPP spp in one pass (two lane chunks of REPARAM_CHUNK)
DI_BOX_SPP, DI_MESH_SPP, DI_PATH_REL = 64, 16, 0.05
#: the silhouette checks of the JAX package's tests/test_reparam.py:78-157
#: at 24^2 x 64 spp: the blocker moved in x, d/ddx of sum(img * x-ramp),
#: direct and direct_reparam against a central difference of direct at
#: 256 spp; a moving area light seen directly, emission_reparam against a
#: central difference of its own primal at 64 spp
DI_SIL_FD_SPP, DI_EM_FD_SPP = 256, 64
#: [outputs]: depth, aov, ptracer and the spectral types at 512^2 x
#: OUT_SPP spp in passes of SPP_CHUNK (the mesh's in passes of
#: MESH_CHUNK), moment at SPP spp; the bars of the JAX package's
#: tests/test_integrators.py:25-84 and tests/test_spectral.py:46-103:
#: the centre depth within OUT_DEPTH, ptracer's mean within OUT_PT_REL
#: of path's, spectral's within OUT_SPEC_REL of the RGB render's,
#: spectral_mono's within OUT_MONO_REL of the luminance
OUT_SPP, OUT_DEPTH = 16, (3.0, 5.5)
OUT_PT_REL, OUT_SPEC_REL, OUT_MONO_REL = 0.05, 0.03, 0.05
#: K3's plain version on the first OUT_SUBSET of a ptracer pass's
#: connection rays, at OUT_K3_DEPTHS of its calls (the emitter vertices'
#: and the first bounce's)
OUT_SUBSET, OUT_K3_DEPTHS = 2 ** 18, 2


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warm=3):
    """Mean ms a call of ``fn`` on the card, by CUDA events, after warm-up."""
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warm=3):
    """Mean ms a call of ``fn`` takes on the device, by CUDA events, after
    warm-up: the calls are queued behind a sleeping kernel long enough for
    the host to launch all of them, so the host's time a launch (the
    wrappers' checks) does not show between them."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0  # host and device, an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e9, 1.5 * iters * once * 2e9)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn):
    """(result, ms) of one call of ``fn``, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def ptxas_usage(log):
    """{function: {"registers", "stack", "spill_stores", "spill_loads"}}
    from ``nvcc -Xptxas=-v`` output, keyed by the mangled name."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def k4_registers(log):
    """ptxas's registers, stack and spills of each K4 instantiation
    (``bvh4_closest_mp_warp_kernel<layout, threads, P, fetch, count>``),
    keyed "P=<P> <layout> <threads> <fetch>[ counting]"."""
    import re
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    layouts = {v: k for k, v in CT.LAYOUTS.items()}
    fetches = {v: k for k, v in CT.FETCHES.items()}
    out = {}
    for name, use in ptxas_usage(log).items():
        m = re.search(r"bvh4_closest_mp_warp_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)ELb([01])E", name)
        if m:
            lay, threads, p, fetch, count = (int(x) for x in m.groups())
            out[f"P={p} {layouts[lay]} {threads} {fetches[fetch]}"
                + (" counting" if count else "")] = use
    return dict(sorted(out.items()))


def main_path_rays(scene, gen, spp):
    """A pass's rays of the main path's kinds: camera rays (even lanes)
    and random bounce rays from the camera hits (odd lanes), some of
    finite extent; a tenth of all lanes dead (maxt = 0)."""
    import torch
    from epsm_mitsuba3_torch.integrators import common
    from epsm_mitsuba3_torch.models import samplers as smp
    sensor = scene.sensors[0]
    n = sensor.width * sensor.height * spp
    sampler = smp.seed(0, n, device=scene.device)
    _, cam, _, _ = common.sample_rays(sensor, sampler, spp)
    si = scene.ray_intersect(cam)
    dirs = torch.randn((n, 3), generator=gen, device=scene.device)
    bounce = si.spawn_ray(dirs / dirs.norm(dim=-1, keepdim=True))
    odd = (torch.arange(n, device=scene.device) % 2 == 1)[:, None]
    o = torch.where(odd, bounce.o, cam.o).contiguous()
    d = torch.where(odd, bounce.d, cam.d).contiguous()
    u = torch.rand(n, generator=gen, device=scene.device)
    maxt = torch.where(u < 0.3, 3.0 * u + 0.1, float("inf"))
    maxt = torch.where(u > 0.9, 0.0, maxt).contiguous()
    return o, d, maxt


def soup_rays(n_tris, n_rays, gen, device):
    """Random triangles in [-1, 1]^3 and rays aimed into them."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI

    def uniform(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    verts = uniform(3 * n_tris, 3)
    faces = torch.arange(3 * n_tris, device=device).reshape(n_tris, 3)
    o = uniform(n_rays, 3, lo=-2.0, hi=2.0)
    d = uniform(n_rays, 3, lo=-0.8, hi=0.8) - o
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    u = uniform(n_rays, lo=0.0, hi=1.0)
    maxt = torch.where(u < 0.3, 10.0 * u + 0.5, float("inf"))
    maxt = torch.where(u > 0.9, 0.0, maxt).contiguous()
    return CI.pack_tris(verts, faces), o, d, maxt


def anyhit_tests(tri, o, d, maxt, chunk=512, ray_chunk=2 ** 17):
    """Ray-triangle tests the any-hit entry needs on these rays: up to
    and including each ray's first hit; none for a ray of no extent.
    Returns their total and the most one ray needs (how far into the
    table the launch must read)."""
    import torch
    from epsm_mitsuba3_torch.ops import intersect as I
    f = tri.shape[0]
    total = most = 0
    for s in range(0, o.shape[0], ray_chunk):
        k = slice(s, s + ray_chunk)
        first = torch.full((o[k].shape[0],), f, dtype=torch.int64,
                           device=o.device)
        for base, _, hit in I.chunk_hits(tri, o[k], d[k], maxt[k], chunk):
            idx = torch.arange(base, base + hit.shape[1], device=o.device)
            first = torch.minimum(first,
                                  torch.where(hit, idx, f).amin(dim=1))
        tests = torch.where(maxt[k] > 1e-6,
                            torch.where(first < f, first + 1, f), 0)
        total += int(tests.sum())
        most = max(most, int(tests.max()) if tests.numel() else 0)
    return total, most


def ray_bytes(maxt, out_bytes):
    """Bytes of the rays a launch must read and of what it writes: the
    origin, direction and maxt (28 B) of a live ray, only the maxt of a
    dead one (maxt <= 1e-6: its miss needs no test), and ``out_bytes``
    written a ray."""
    n = maxt.shape[0]
    live = int((maxt > 1e-6).sum())
    return 28 * live + 4 * (n - live) + out_bytes * n


def k1_bound(tri, o, d, maxt, any_hit):
    """K1's bound on these rays: a live ray tests every triangle (closest
    hit) or those up to its first hit (any hit), a dead ray none; the
    table is read once, as far as the most tests one ray needs."""
    f = tri.shape[0]
    if any_hit:
        tests, reach = anyhit_tests(tri, o, d, maxt)
    else:
        live = int((maxt > 1e-6).sum())
        tests, reach = live * f, f if live else 0
    return bound_ms(36 * reach + ray_bytes(maxt, 1 if any_hit else 16),
                    tests * FLOP_PER_TEST)


#: bytes of one BVH4 record (32 floats) and of one triangle row of
#: ``tri_k`` (48 B), as K2/K3 read them
NODE_BYTES, ROW_BYTES = 128, 48


def bvh_work(maxt, work, any_hit):
    """(bytes, operations) of K2's (or K3's) function on these rays, from
    the plain version's ``work`` on them, (pops, tests, records read,
    rows read): each record and row some ray needs read once, and the
    rays' bytes (``ray_bytes``); 4 slab tests a pop (+ the ordering of
    K2's pushes) and a triangle test's operations."""
    pops, tests, n_nodes, n_rows = work
    ops = (pops * (4 * OPS_PER_SLAB + (0 if any_hit else OPS_PER_ORDER))
           + tests * FLOP_PER_TEST)
    return (n_nodes * NODE_BYTES + n_rows * ROW_BYTES
            + ray_bytes(maxt, 1 if any_hit else 16)), ops


def bvh_plain_work(nodes, tri, o, d, maxt, any_hit):
    """The plain closest hit's (or any hit's) work on these rays: (pops,
    tests, records read, rows read)."""
    from epsm_mitsuba3_torch.ops import traverse as TR
    plain = (TR.bvh_ray_test_plain if any_hit
             else TR.bvh_ray_intersect_plain)
    out = plain(nodes, tri, o, d, maxt, counts=True, reads=True)
    return tuple(int(x.sum()) for x in out[-4:])


def bound_ms(n_bytes, n_flop):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flop = n_flop / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def hold(label, got, ref):
    """Hold a kernel's (t, prim, u, v, occ) against a reference's on the
    same rays: ``prim``, ``valid`` and ``occ`` equal on >= 99.99 % of the
    lanes, |err| of t, u, v <= 1e-5 * max(|ref|, 1) where ``prim``
    agrees, and the any hit equal to the closest hit's ``valid``.
    Returns the largest absolute error of t, u, v and of ``occ``."""
    import torch
    t, prim, u, v, occ = got
    t_p, prim_p, u_p, v_p, occ_p = ref
    n = prim.shape[0]
    same = prim == prim_p
    n_diff = int((~same).sum())
    n_valid_diff = int(((prim >= 0) != (prim_p >= 0)).sum())
    n_occ_diff = int((occ != occ_p).sum())
    agree = same & (prim >= 0)
    errs = {}
    for name, a, b in (("t", t, t_p), ("u", u, u_p), ("v", v, v_p)):
        e = (a[agree] - b[agree]).abs()
        rel = e / b[agree].abs().clamp(min=1.0)
        errs[name] = (float(e.max()) if e.numel() else 0.0,
                      float(rel.max()) if rel.numel() else 0.0)
    self_consistent = bool(torch.equal(occ, prim >= 0))
    say(f"[{label}] rays {n} hits {int((prim_p >= 0).sum())}: prim differs "
        f"on {n_diff} lanes, valid on {n_valid_diff}, any-hit on "
        f"{n_occ_diff}; any-hit == closest valid: {self_consistent}; "
        "max |err| " + ", ".join(f"{k} {a:.3g} (rel {r:.3g})"
                                 for k, (a, r) in errs.items())
        + "  [limits: >= 99.99 % agree, |err| <= 1e-5 * max(|ref|, 1)]")
    check(n_diff <= 1e-4 * n and n_valid_diff <= 1e-4 * n,
          f"{label}: closest hit disagrees on {n_diff} lanes")
    check(n_occ_diff <= 1e-4 * n,
          f"{label}: any hit disagrees on {n_occ_diff} lanes")
    check(self_consistent, f"{label}: any-hit != closest-hit valid")
    for k, (_, rel) in errs.items():
        check(rel <= 1e-5, f"{label}: {k} off by {rel} relative")
    return (max(a for a, _ in errs.values()),
            float((occ != occ_p).float().max()) if n else 0.0)


K1_FIELDS = ("t", "prim", "u", "v", "occ")


def plain_k1(tri, o, d, maxt, ray_chunk=2 ** 17):
    """The plain versions' (t, prim, u, v, occ), in chunks of rays."""
    import torch
    from epsm_mitsuba3_torch.ops import intersect as I
    outs = []
    for s in range(0, o.shape[0], ray_chunk):
        k = slice(s, s + ray_chunk)
        outs.append((*I.ray_intersect_brute(tri, o[k], d[k], maxt[k]),
                     I.ray_test_brute(tri, o[k], d[k], maxt[k])))
    return tuple(torch.cat(x) for x in zip(*outs))


def k1_calls(tri):
    """Every K1 launch ``chip_smoke.py`` holds and times, by name: the
    main path's ("main") and each step of ``cuda_intersect.STEPS`` (the
    launches ``launch_rule`` picks among), for the closest hit and the any
    hit."""
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    closest = {"main": lambda o, d, m: CI.closest_hit(tri, o, d, m)}
    anyh = {"main": lambda o, d, m: CI.any_hit(tri, o, d, m)}
    for name, v in CI.STEPS.items():
        if name in CI.CLOSEST_STEPS:
            closest[name] = (lambda v_: lambda o, d, m: CI.launch_closest(
                tri, o, d, m, v_))(v)
        if name in CI.ANY_STEPS:
            anyh[name] = (lambda v_: lambda o, d, m: CI.launch_any(
                tri, o, d, m, v_))(v)
    return {"mt_closest_hit": closest, "mt_any_hit": anyh}


def compare_k1(label, tri, o, d, maxt):
    """Both K1 entries against the plain versions on the same inputs, bit
    for bit (0 lanes may differ in t, prim, u, v or occ): the main path's
    launch, every design step, and a launch that walks the table in tiles
    of 1,000 rows.  Returns the largest absolute errors (t, u, v; occ) of
    the main launch."""
    from dataclasses import replace
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    ref = plain_k1(tri, o, d, maxt)
    calls = k1_calls(tri)
    main = (*calls["mt_closest_hit"]["main"](o, d, maxt),
            calls["mt_any_hit"]["main"](o, d, maxt))
    torch.cuda.synchronize()
    err = hold(f"K1 {label}, {tri.shape[0]} tris", main, ref)
    got = {"main": main}
    for name in set(calls["mt_closest_hit"]) | set(calls["mt_any_hit"]):
        if name == "main":
            continue
        c = calls["mt_closest_hit"].get(name, calls["mt_closest_hit"]["main"])
        a = calls["mt_any_hit"].get(name, calls["mt_any_hit"]["main"])
        got[name] = (*c(o, d, maxt), a(o, d, maxt))
    if tri.shape[0] > 1000:
        f, n = tri.shape[0], o.shape[0]
        got["tiles of 1000"] = (
            *CI.launch_closest(tri, o, d, maxt, replace(
                CI.launch_rule(f, n, "closest"), tile=1000)),
            CI.launch_any(tri, o, d, maxt, replace(
                CI.launch_rule(f, n, "any"), tile=1000)))
    torch.cuda.synchronize()
    for name, g in got.items():
        diff = {k: int((a != b).sum()) for k, a, b in zip(K1_FIELDS, g, ref)}
        check(sum(diff.values()) == 0, f"K1 {label}, launch {name!r} "
              f"differs from the plain versions: {diff}")
    check(bool(torch.equal(main[4], main[1] >= 0)),
          f"K1 {label}: any hit != closest hit's valid")
    say(f"[K1] {label}: the main launch, steps "
        f"{', '.join(CI.STEPS)} and 1,000-row tiles equal the plain "
        f"versions bit for bit on {o.shape[0]} rays (0 lanes differ in "
        f"{', '.join(K1_FIELDS)}); any hit == closest valid")
    return err


def time_k1(tri, o, d, maxt, iters, plain=True):
    """ms a launch of both entries (the main path's launch and every design
    step, two rounds, the second reversed; device time alone) and of their
    plain versions, and the bound of each entry on these inputs."""
    from epsm_mitsuba3_torch.ops import intersect as I
    n, f = o.shape[0], tri.shape[0]
    args = (tri, o, d, maxt)
    calls = k1_calls(tri)
    cases = [(k, name) for k in calls for name in calls[k]]
    runs = {c: [] for c in cases}
    for seq in (cases, cases[::-1]):
        for k, name in seq:
            fn = calls[k][name]
            runs[(k, name)].append(device_ms(lambda: fn(o, d, maxt), iters))
    out = {}
    for name, plain_fn, any_hit in (
            ("mt_closest_hit", I.ray_intersect_brute, False),
            ("mt_any_hit", I.ray_test_brute, True)):
        plain_ms = cuda_ms(lambda: plain_fn(*args), 5) if plain else None
        b_ms, by = k1_bound(*args, any_hit)
        steps = {s: sum(runs[(name, s)]) / 2 for s in calls[name]}
        out[name] = dict(ms=steps.pop("main"), plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=by, steps_ms=steps)
        v = out[name]
        say(f"[time] {name} at {f} tris x {n} rays: {v['ms']:.4f} ms a "
            f"launch (plain version "
            + (f"{plain_ms:.3f} ms" if plain else "not timed")
            + f"), bound {b_ms:.4f} ms by {by} ({b_ms / v['ms']:.1%}); "
            "steps " + ", ".join(f"{s} {t:.4f}" for s, t in steps.items()))
    return out


def render_rays_k1(scene, spp):
    """Record the rays one ``spp`` pass of the box hands to
    ``closest_hit`` and ``any_hit`` (wrapped here, not in the package);
    then on each depth's batch hold the main path's K1 launches against
    the plain versions bit for bit (and the any hit against the closest
    hit's valid on the shadow rays), and time them beside every design step
    (two rounds, the second reversed; device time alone)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    rec = {"closest": [], "any": []}
    orig = CI.closest_hit, CI.any_hit

    def keep(kind, fn):
        def call(tri, o, d, maxt):
            rec[kind].append((tri.clone(), o.clone(), d.clone(),
                              maxt.clone()))
            return fn(tri, o, d, maxt)
        return call

    CI.closest_hit = keep("closest", orig[0])
    CI.any_hit = keep("any", orig[1])
    try:
        mt.render(scene, spp=spp, seed=5)
    finally:
        CI.closest_hit, CI.any_hit = orig
    torch.cuda.synchronize()
    check(len(rec["closest"]) == DEPTH and len(rec["any"]) == DEPTH,
          f"a pass made {len(rec['closest'])} closest-hit and "
          f"{len(rec['any'])} any-hit calls, expected {DEPTH} each")
    out = []
    for depth, (c, a) in enumerate(zip(rec["closest"], rec["any"])):
        got = (*CI.closest_hit(*c), CI.any_hit(*a))
        ref_c = plain_k1(*c)
        ref_a = plain_k1(*a)
        ref = (*ref_c[:4], ref_a[4])
        diff = {k: int((x != y).sum()) for k, x, y in
                zip(K1_FIELDS, got, ref)}
        check(sum(diff.values()) == 0,
              f"depth {depth}: K1 differs from the plain versions: {diff}")
        check(bool(torch.equal(got[4], ref_a[1] >= 0)),
              f"depth {depth}: any hit != the closest hit's valid")
        calls = {}
        for k, rays in (("closest", c), ("any", a)):
            for name, fn in k1_calls(rays[0])[f"mt_{k}_hit"].items():
                calls[f"{k} {name}"] = (lambda f_, r_: lambda: f_(*r_[1:]))(
                    fn, rays)
        runs = {k: [] for k in calls}
        for seq in (list(calls), list(calls)[::-1]):
            for k in seq:
                runs[k].append(device_ms(calls[k], 20))
        ms = {k: sum(v) / 2 for k, v in runs.items()}
        row = dict(depth=depth, rays=c[1].shape[0],
                   live_closest=int((c[3] > 1e-6).sum()),
                   live_any=int((a[3] > 1e-6).sum()),
                   hits=int((got[1] >= 0).sum()),
                   occluded=int(got[4].sum()), **ms)
        out.append(row)
        say(f"[render rays K1] depth {depth}: {row['rays']} rays "
            f"({row['live_closest']} live, {row['hits']} hits) closest "
            f"{ms['closest main']:.4f} ms; {row['live_any']} live shadow "
            f"rays ({row['occluded']} occluded) any {ms['any main']:.4f} ms; "
            "bit for bit equal to the plain versions; steps "
            + ", ".join(f"{k} {t:.4f}" for k, t in ms.items()
                        if not k.endswith(" main")))
    return out


def k1_rule_sweep(gen, device):
    """K1's steps at each triangle count of SWEEP_TRIS and ray count of
    SWEEP_RAYS, on random soups: every step's results equal the main
    launch's bit for bit, and the plain versions' on the first 65,536
    rays; each step timed (device time alone, two rounds, the second
    reversed) beside the launch ``launch_rule`` picks there, and the
    fastest.  Returns {"F x N": {entry: {step: ms}, "rule": ..., ...}}."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    out, worst = {}, {}
    for f in SWEEP_TRIS:
        for n in SWEEP_RAYS:
            tri, o, d, maxt = soup_rays(f, n, gen, device)
            calls = k1_calls(tri)
            main = (*calls["mt_closest_hit"]["main"](o, d, maxt),
                    calls["mt_any_hit"]["main"](o, d, maxt))
            k = slice(0, 65536)
            ref = plain_k1(tri, o[k], d[k], maxt[k])
            diff = {name: int((a[k] != b).sum())
                    for name, a, b in zip(K1_FIELDS, main, ref)}
            for kind, fields in (("mt_closest_hit", slice(0, 4)),
                                 ("mt_any_hit", slice(4, 5))):
                for name, fn in calls[kind].items():
                    got = fn(o, d, maxt)
                    got = got if isinstance(got, tuple) else (got,)
                    for field, a, b in zip(K1_FIELDS[fields], got,
                                           main[fields]):
                        diff[f"{name} {field}"] = int((a != b).sum())
            torch.cuda.synchronize()
            check(sum(diff.values()) == 0, f"K1 sweep {f} x {n}: launches "
                  f"differ from the main launch or the plain versions: "
                  f"{ {k_: v for k_, v in diff.items() if v} }")
            cases = [(kind, name) for kind in calls for name in calls[kind]
                     if name != "main"]
            iters = 50 if f * n <= 2 ** 24 else 20 if f * n <= 2 ** 27 else 5
            runs = {c: [] for c in cases}
            for seq in (cases, cases[::-1]):
                for kind, name in seq:
                    fn = calls[kind][name]
                    runs[(kind, name)].append(
                        device_ms(lambda: fn(o, d, maxt), iters))
            row, parts = {}, []
            for kind, short in (("mt_closest_hit", "closest"),
                                ("mt_any_hit", "any")):
                ms = {name: sum(runs[(kind, name)]) / 2
                      for name in calls[kind] if name != "main"}
                rule = CI.launch_rule(f, n, short)
                pick = next(name for name in ms if CI.STEPS[name] == rule)
                best = min(ms, key=ms.get)
                ratio = ms[pick] / ms[best]
                worst[kind] = max(worst.get(kind, (1.0, "")),
                                  (ratio, f"{f} x {n}"))
                row[kind] = dict(ms=ms, rule=pick, fastest=best,
                                 rule_over_fastest=ratio)
                parts.append(f"{short} " + ", ".join(
                    f"{name} {t:.4f}" for name, t in ms.items())
                    + f" -> rule {pick!r}, fastest {best!r} ({ratio:.3f})")
            out[f"{f}x{n}"] = row
            say(f"[K1 rule] {f} tris x {n} rays: " + "; ".join(parts))
    say("[K1 rule] bit for bit equal to the main launch and the plain "
        "versions at every point; the rule's pick over the fastest, at "
        "worst: " + ", ".join(f"{k} {r:.3f} at {at}"
                             for k, (r, at) in worst.items()))
    return out


def compare_bvh(scene, o, d, maxt, n_brute=65536):
    """K2 and K3 (default ray order) against their plain versions on the
    same rays, and on the first ``n_brute`` rays against K1's plain brute
    force over every triangle; the overflow flag must stay 0.  Returns
    the errors against each, the plain versions' ms and their work
    counts."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    from epsm_mitsuba3_torch.ops import traverse as TR
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    order = scene.bvh.order.long()
    t, slot, u, v = CT.closest_hit(nodes, tri, o, d, maxt, tri_k=tri_k)
    occ = CT.any_hit(nodes, tri, o, d, maxt, tri_k=tri_k)
    ref = CT.closest_hit_reference(nodes, tri, o, d, maxt)
    torch.cuda.synchronize()
    CT.raise_on_overflow(o.device)
    say("[K2/K3] overflow flag: 0")
    (t_p, slot_p, u_p, v_p, pops, tests), plain_ms_c = timed(
        lambda: TR.bvh_ray_intersect_plain(nodes, tri, o, d, maxt,
                                           counts=True))
    (occ_p, pops_a, tests_a), plain_ms_a = timed(
        lambda: TR.bvh_ray_test_plain(nodes, tri, o, d, maxt, counts=True))
    err = hold("K2/K3 vs plain, main-path rays", (t, slot, u, v, occ),
               (t_p, slot_p, u_p, v_p, occ_p))
    plain = (t_p, slot_p, u_p, v_p, occ_p)
    for label, got in (("K2/K3", (t, slot, u, v, occ)),
                       ("reference (K2's former walk)", ref)):
        diff = {k: int((a != b).sum()) for k, a, b in
                zip(("t", "slot", "u", "v", "occ"), got, plain)}
        say(f"[K2/K3] {label} against the plain versions, bit for bit on "
            f"{o.shape[0]} rays: lanes differing {diff}  [limit 0 each]")
        check(sum(diff.values()) == 0, f"{label} differs from its plain "
              f"version: {diff}")

    def prim_of(s):
        return torch.where(s >= 0, order[s.clamp(min=0).long()], -1)

    k = slice(0, n_brute)
    tri_all = CI.pack_tris(scene.vertices, scene.faces)
    ref = (*I.ray_intersect_brute(tri_all, o[k], d[k], maxt[k]),
           I.ray_test_brute(tri_all, o[k], d[k], maxt[k]))
    ref = (ref[0], ref[1].long(), *ref[2:])
    err_b = hold(f"K2/K3 vs K1 brute force, {tri_all.shape[0]} tris",
                 (t[k], prim_of(slot[k]), u[k], v[k], occ[k]), ref)
    live = maxt > 1e-6
    say(f"[K2/K3] per live ray: closest hit {float(pops[live].float().mean()):.2f}"
        f" pops, {float(tests[live].float().mean()):.2f} triangle tests; "
        f"any hit {float(pops_a[live].float().mean()):.2f} pops, "
        f"{float(tests_a[live].float().mean()):.2f} tests")
    return dict(err=err, err_brute=err_b, plain_ms=(plain_ms_c, plain_ms_a),
                work=(bvh_plain_work(nodes, tri, o, d, maxt, False),
                      bvh_plain_work(nodes, tri, o, d, maxt, True)))


def _ref_sorting(nodes, tri):
    """The reference (K2's former walk) as ``closest_hit`` calls a kernel:
    ``sort`` Morton-sorts the rays first and un-sorts the results."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT

    def call(o, d, maxt, sort):
        if not sort:
            return CT.closest_hit_reference(nodes, tri, o, d, maxt)
        p = CT._morton_order(nodes, o, d, maxt)
        out = CT.closest_hit_reference(nodes, tri, o[p], d[p], maxt[p])
        return tuple(CT._unsort(x, p) for x in out)
    return call


ORDERS = ("unsorted", "sorted", "presorted")


def time_bvh(scene, o, d, maxt, plain_ms, work, k4):
    """ms a launch of K2, the reference (K2's former walk), K3 and K4 at
    P = 2 and 4, each with the rays unsorted, Morton-sorted (the sort and
    un-sort included) and pre-sorted (the traversal alone on rays already
    in Morton order), timed in two rounds, the second in reverse order,
    and averaged; and each entry's bound on these rays from the plain
    versions' work counts.  K4 and the reference compute K2's function, so
    their bound is K2's; K4's own schedule's pops and tests are printed
    beside it."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    n = o.shape[0]
    pops, tests = work[0][:2]
    work_c = bvh_work(maxt, work[0], False)
    work_a = bvh_work(maxt, work[1], True)
    perm = CT._morton_order(nodes, o, d, maxt)
    pre = (o[perm].contiguous(), d[perm].contiguous(),
           maxt[perm].contiguous())

    def k4_of(width):
        return lambda o_, d_, m_, s_: CT.closest_hit(
            nodes, tri, o_, d_, m_, sort=s_, multi_pop=width, tri_k=tri_k)

    entries = {
        "bvh4_closest_hit": (lambda o_, d_, m_, s_: CT.closest_hit(
            nodes, tri, o_, d_, m_, sort=s_, tri_k=tri_k), work_c,
            plain_ms[0]),
        "bvh4_closest_hit_ref": (_ref_sorting(nodes, tri), work_c,
                                 plain_ms[0]),
        "bvh4_any_hit": (lambda o_, d_, m_, s_: CT.any_hit(
            nodes, tri, o_, d_, m_, sort=s_, tri_k=tri_k), work_a,
            plain_ms[1]),
        "bvh4_closest_hit_mp P=2": (k4_of(2), work_c, k4[2]["plain_ms"]),
        "bvh4_closest_hit_mp P=4": (k4_of(4), work_c, k4[4]["plain_ms"]),
    }
    cases = [(name, kind) for name in entries for kind in ORDERS]
    runs = {c: [] for c in cases}
    for seq in (cases, cases[::-1]):
        for name, kind in seq:
            fn = entries[name][0]
            args = (*pre, False) if kind == "presorted" else (
                o, d, maxt, kind == "sorted")
            runs[(name, kind)].append(cuda_ms(lambda: fn(*args), 20))
    out = {}
    for name, (_, (n_bytes, ops), p_ms) in entries.items():
        ms = {kind: sum(runs[(name, kind)]) / 2 for kind in ORDERS}
        b_ms, by = bound_ms(n_bytes, ops)
        out[name] = dict(
            ms=ms["sorted" if CT.SORT_RAYS else "unsorted"],
            ms_unsorted=ms["unsorted"], ms_sorted=ms["sorted"],
            ms_presorted=ms["presorted"],
            rounds={kind: runs[(name, kind)] for kind in ORDERS},
            plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        say(f"[time] {name} at {tri.shape[0]} tris x {n} rays: unsorted "
            f"{ms['unsorted']:.4f} ms, Morton-sorted {ms['sorted']:.4f} ms "
            f"(sort included), pre-sorted {ms['presorted']:.4f} ms "
            f"(rounds {runs[(name, 'unsorted')]}, unsorted); plain version "
            f"{p_ms:.1f} ms; bound {b_ms:.4f} ms by {by} ({ops / 1e9:.3f} "
            f"G operations, {n_bytes / 1e6:.1f} MB)")
    for name in ("bvh4_closest_hit", "bvh4_any_hit",
                 "bvh4_closest_hit_mp P=2", "bvh4_closest_hit_mp P=4"):
        fn = entries[name][0]
        t = device_ms(lambda: fn(o, d, maxt, False), 20)
        out[name]["device_ms"] = t
        say(f"[time] {name} unsorted, device time alone: {t:.4f} ms a "
            "launch")
    for width in CT.K4_WIDTHS:
        kp, kt = k4[width]["work"]
        say(f"[time] K4 P={width}: its own schedule {kp / n:.2f} pops, "
            f"{kt / n:.2f} tests a ray against K2's {pops / n:.2f} and "
            f"{tests / n:.2f}")
    k2, ref = out["bvh4_closest_hit"], out["bvh4_closest_hit_ref"]
    say(f"[speed] new K2 / reference, unsorted: "
        f"{k2['ms_unsorted'] / ref['ms_unsorted']:.3f} (aim <= 0.8); new K3 "
        f"{out['bvh4_any_hit']['ms_unsorted']:.4f} ms (aim <= 0.46)")
    return out


def time_steps(scene, o, d, maxt):
    """ms a launch of K2 and K3 at each design step
    (``cuda_traverse.STEPS``: warp-wide leaf tests alone, with the 48-byte
    rows, with the shared top on a persistent, refilling grid) on the rays
    unsorted and pre-sorted, in two rounds (the second reversed); each
    step's hits must equal the main path's bit for bit."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri = scene.bvh_nodes, scene.bvh_tris
    perm = CT._morton_order(nodes, o, d, maxt)
    pre = (o[perm].contiguous(), d[perm].contiguous(),
           maxt[perm].contiguous())
    main = (*CT.launch_closest(nodes, scene.bvh_tris_k, o, d, maxt),
            CT.launch_any(nodes, scene.bvh_tris_k, o, d, maxt))
    vs = {f"step {k}": v for k, v in CT.STEPS.items()}
    layouts = {v.layout: CT.kernel_tris(tri, v.layout) for v in vs.values()}
    for name, v in vs.items():
        tk = layouts[v.layout]
        got = (*CT.launch_closest(nodes, tk, o, d, maxt, v),
               CT.launch_any(nodes, tk, o, d, maxt, v))
        check(all(torch.equal(a, b) for a, b in zip(got, main)),
              f"K2/K3 {name} differs from the main path's launch")
    cases = [(name, k, kind) for name in vs for k in ("K2", "K3")
             for kind in ("unsorted", "presorted")]
    runs = {c: [] for c in cases}
    for seq in (cases, cases[::-1]):
        for name, k, kind in seq:
            v = vs[name]
            fn = CT.launch_closest if k == "K2" else CT.launch_any
            rays = pre if kind == "presorted" else (o, d, maxt)
            runs[(name, k, kind)].append(cuda_ms(
                lambda: fn(nodes, layouts[v.layout], *rays, v), 20))
    out = {}
    for name, v in vs.items():
        ms = {f"{k} {kind}": sum(runs[(name, k, kind)]) / 2
              for k in ("K2", "K3") for kind in ("unsorted", "presorted")}
        out[name] = ms
        grid = "persistent, refilled" if v.persistent else "32 rays a warp"
        say(f"[steps] {name} ({v.layout}, {v.threads} threads, {grid}, "
            f"{'top in shared memory' if v.shared else 'R = 0'}, serial "
            f"{v.serial}/8): "
            + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items())
            + "; hits equal the main path's")
    return out


def time_k4_steps(scene, o, d, maxt, bound):
    """ms a launch, on the device alone, of every K4 launch of
    ``k4_calls`` at each width (the main path's and each design step),
    with K2 and the reference beside them, in two rounds (the second
    reversed); each set against ``bound``, the least time of K2's
    function on these rays, and the main path's launch against the aim
    of at most 1.25 x K2.  Returns {name: ms}, the K4 launches named
    "P=<width> <launch>"."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    calls = {"K2": lambda o_, d_, m_: CT.launch_closest(nodes, tri_k, o_,
                                                         d_, m_),
             "reference": lambda o_, d_, m_: CT.closest_hit_reference(
                 nodes, tri, o_, d_, m_)}
    for width in CT.K4_WIDTHS:
        for name, fn in k4_calls(scene, width).items():
            calls[f"P={width} {name}"] = fn
    runs = {k: [] for k in calls}
    for seq in (list(calls), list(calls)[::-1]):
        for k in seq:
            runs[k].append(device_ms(lambda: calls[k](o, d, maxt), 20))
    ms = {k: sum(v) / 2 for k, v in runs.items()}
    say(f"[K4 steps] device time alone, {o.shape[0]} rays: K2 "
        f"{ms['K2']:.4f} ms, reference {ms['reference']:.4f} ms; bound "
        f"{bound:.4f} ms")
    for width in CT.K4_WIDTHS:
        say(f"[K4 steps] P={width}: " + "; ".join(
            f"{k.split(' ', 1)[1]} {t:.4f} ms ({t / ms['K2']:.3f} x K2, "
            f"{t / ms['reference']:.3f} x the reference, {bound / t:.1%} "
            "of the bound)" for k, t in ms.items()
            if k.startswith(f"P={width} ")))
        main = ms[f"P={width} main"]
        say(f"[speed] K4 P={width}: {main / ms['K2']:.3f} x K2 (aim <= "
            f"1.25: {'met' if main <= 1.25 * ms['K2'] else 'missed'})")
    return ms


def lane_utilisation(scene, o, d, maxt):
    """Active lane-steps over 32 x warp-steps in the traversal loop and in
    the leaf tests, from the counting builds of the main path's K2 and K4
    at each width and of the reference, whose hits must equal the
    uncounted ones.  K4's traversal step is one batch position visited by
    the warp."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    out = {}
    k4 = [(f"K4 P={w}", (lambda w_: lambda c: CT.launch_closest_mp(
        nodes, tri_k, o, d, maxt, w_, counts=c))(w),
           (lambda w_: lambda: CT.launch_closest_mp(
               nodes, tri_k, o, d, maxt, w_))(w)) for w in CT.K4_WIDTHS]
    for name, fn, plain in (
            ("K2", lambda c: CT.launch_closest(nodes, tri_k, o, d,
                                               maxt, counts=c),
             lambda: CT.launch_closest(nodes, tri_k, o, d, maxt)),
            *k4,
            ("reference", lambda c: CT.closest_hit_reference(
                nodes, tri, o, d, maxt, counts=c),
             lambda: CT.closest_hit_reference(nodes, tri, o, d, maxt))):
        counts = torch.zeros(4, dtype=torch.int64, device=o.device)
        got = fn(counts)
        check(all(torch.equal(a, b) for a, b in zip(got, plain())),
              f"the counting {name} differs from the uncounted one")
        steps, active, lsteps, lactive = (int(x) for x in counts.tolist())
        out[name] = dict(traversal=active / (32 * steps),
                         leaf=lactive / (32 * lsteps),
                         traversal_steps=steps, leaf_steps=lsteps)
        say(f"[lanes] {name}: traversal {active / (32 * steps):.3f} of the "
            f"lanes in {steps} warp-steps, leaf tests "
            f"{lactive / (32 * lsteps):.3f} in {lsteps} warp-steps "
            f"({o.shape[0]} rays)")
    return out


def render_rays(scene, spp):
    """Record the rays one ``spp`` pass hands to ``closest_hit`` and
    ``any_hit`` (wrapped here, not in the package); then, on each depth's
    batch, time the main path's K2 against the reference, K3 and K4 at
    each width (two rounds, the second reversed), and check K2 against
    the reference, K3 against the reference's valid, and K4 against its
    plain version, bit for bit, and its t and valid against K2's."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import traverse as TR
    rec = {"closest": [], "any": []}
    orig = CT.closest_hit, CT.any_hit

    def keep(kind, fn):
        def call(nodes, tri, o, d, maxt, **kw):
            rec[kind].append((o.clone(), d.clone(), maxt.clone()))
            return fn(nodes, tri, o, d, maxt, **kw)
        return call

    CT.closest_hit = keep("closest", orig[0])
    CT.any_hit = keep("any", orig[1])
    try:
        mt.render(scene, spp=spp, seed=5)
    finally:
        CT.closest_hit, CT.any_hit = orig
    torch.cuda.synchronize()
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    check(len(rec["closest"]) == DEPTH and len(rec["any"]) == DEPTH,
          f"a pass made {len(rec['closest'])} closest-hit and "
          f"{len(rec['any'])} any-hit calls, expected {DEPTH} each")
    out = []
    for depth, (c, a) in enumerate(zip(rec["closest"], rec["any"])):
        k2 = CT.launch_closest(nodes, tri_k, *c)
        ref = CT.closest_hit_reference(nodes, tri, *c)
        occ = CT.launch_any(nodes, tri_k, *a)
        occ_ref = CT.closest_hit_reference(nodes, tri, *a)[1] >= 0
        check(all(torch.equal(x, y) for x, y in zip(k2, ref))
              and torch.equal(occ, occ_ref),
              f"depth {depth}: K2/K3 differ from the reference")
        calls = {"K2": lambda: CT.launch_closest(nodes, tri_k, *c),
                 "reference": lambda: CT.closest_hit_reference(
                     nodes, tri, *c),
                 "K3": lambda: CT.launch_any(nodes, tri_k, *a)}
        for w in CT.K4_WIDTHS:
            k4 = CT.launch_closest_mp(nodes, tri_k, *c, w)
            plain = TR.bvh_ray_intersect_plain(nodes, tri, *c, multi_pop=w)
            diff = sum(int((x != y).sum()) for x, y in zip(k4, plain))
            check(diff == 0 and torch.equal(k4[0], k2[0])
                  and torch.equal(k4[1] >= 0, k2[1] >= 0),
                  f"depth {depth}: K4 P={w} differs from its plain version "
                  f"on {diff} lanes, or its t / valid from K2's")
            calls[f"K4 P={w}"] = (lambda w_: lambda: CT.launch_closest_mp(
                nodes, tri_k, *c, w_))(w)
        runs = {k: [] for k in calls}
        for seq in (list(calls), list(calls)[::-1]):
            for k in seq:
                runs[k].append(cuda_ms(calls[k], 10))
        ms = {k: sum(v) / 2 for k, v in runs.items()}
        live_c = int((c[2] > 1e-6).sum())
        live_a = int((a[2] > 1e-6).sum())
        row = dict(depth=depth, rays=c[0].shape[0], live_closest=live_c,
                   live_any=live_a, hits=int((k2[1] >= 0).sum()),
                   occluded=int(occ.sum()), **{f"{k}_ms": v
                                               for k, v in ms.items()})
        out.append(row)
        say(f"[render rays] depth {depth}: {c[0].shape[0]} rays ({live_c} "
            f"live, {row['hits']} hits) K2 {ms['K2']:.4f} ms, reference "
            f"{ms['reference']:.4f} ms ({ms['K2'] / ms['reference']:.3f}), "
            + ", ".join(f"K4 P={w} {ms[f'K4 P={w}']:.4f} ms"
                        for w in CT.K4_WIDTHS)
            + f"; {live_a} live shadow rays ({row['occluded']} occluded) K3 "
            f"{ms['K3']:.4f} ms; K2/K3 bit for bit equal to the reference, "
            "K4 to its plain version (t and valid to K2's)")
    slower = [r["depth"] for r in out if r["K2_ms"] > r["reference_ms"]]
    say(f"[speed] render rays: K2 slower than the reference at depths "
        f"{slower or 'none'}")
    return out


def image_checks(img, res):
    import torch
    check(tuple(img.shape) == (res, res, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "image has non-finite pixels")
    w = res // 8
    left = img[:, :w].mean((0, 1))
    right = img[:, -w:].mean((0, 1))
    top, bottom = img[: res // 2].mean(), img[res // 2:].mean()
    say(f"[render] mean {float(img.mean()):.5f}; left rgb "
        f"{[round(float(x), 4) for x in left]}, right rgb "
        f"{[round(float(x), 4) for x in right]}; top/bottom "
        f"{float(top):.4f}/{float(bottom):.4f}")
    check(left[0] > left[1], "left wall is not red-tinted")
    check(right[1] > right[0], "right wall is not green-tinted")
    check(top > bottom, "the light is not in the top half")


def render_phase(label, scene, spp, chunk, expect):
    """A warm-up and TIMED_RENDERS timed renders at full width; before
    each every launch count is set to 0, and after it each count must be
    ``expect``'s.  Returns the median wall ms and the last counts."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    walls = []
    for run in ["warm-up"] + [f"timed {i + 1}" for i in range(TIMED_RENDERS)]:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = mt.render(scene, spp=spp, spp_chunk=chunk, seed=0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        say(f"[{label}] {run}: {walls[-1]:.1f} ms, launches {counts}")
        for k, n in expect.items():
            check(counts[k] == n,
                  f"{k} launched {counts[k]} times, expected {n}")
        image_checks(img, scene.sensors[0].width)
    CT.raise_on_overflow(scene.device)
    timed_walls = sorted(walls[1:])
    median = timed_walls[len(timed_walls) // 2]
    sensor = scene.sensors[0]
    n_passes = -(-spp // chunk)
    rays = sensor.width * sensor.height * chunk * DEPTH * 2 * n_passes
    say(f"[{label}] {sensor.width}^2 x {spp} spp ({n_passes} passes of "
        f"{chunk}), depth {DEPTH}: wall median {median:.1f} ms of "
        f"{len(timed_walls)} (min {timed_walls[0]:.1f}, max "
        f"{timed_walls[-1]:.1f}); {rays / (median / 1e3) / 1e6:.2f} "
        "physical Mrays/s at the median")
    return median, counts


def _device_events(prof):
    """(name, device ms, count) by kernel name, read from the profiler's
    raw events: seconds for ~10^6 launches, where ``key_averages``
    takes minutes."""
    import torch
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(k, ms, n) for k, (ms, n) in by_name.items()]


def profile_pass(label, fn, names, cpu=True, table=True):
    """Device time by kernel over one call of ``fn`` (torch.profiler),
    with the share of the kernels whose names contain one of ``names``;
    the full table goes to standard error.  ``cpu=False`` traces the
    device alone: no host operator events, whose collection takes tens
    of seconds on a call of ~10^5 launches.  ``table=False`` sums the
    raw device events instead of ``key_averages`` (the same kernels, no
    table), for a call of ~10^6 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if not table:
        kernels = _device_events(prof)
        if not kernels:
            say(f"[profile] {label}: wall {wall:.1f} ms; the profiler saw "
                "no device time (not measured)")
            return None
        busy = sum(ms for _, ms, _ in kernels)
        ours = sum(ms for k, ms, _ in kernels
                   if any(nm in k for nm in names))
        n_launch = sum(n for _, _, n in kernels)
        top = sorted(kernels, key=lambda e: -e[1])[:8]
        say("[profile] %s: wall %.1f ms, device busy %.1f ms (%.1f %%), %s "
            "%.2f ms (%.1f %% of busy), %d kernel launches; top: %s" % (
                label, wall, busy, 100 * busy / wall, "/".join(names), ours,
                100 * ours / busy, n_launch,
                "; ".join(f"{k[:40]} {ms:.2f} ms x{n}" for k, ms, n in top)))
        return dict(wall=wall, busy=busy, launches=n_launch)
    avgs = prof.key_averages()
    key = ("device_time_total" if hasattr(avgs[0], "device_time_total")
           else "cuda_time_total")
    # kernels only: an operator's device time repeats its kernels' time
    kernels = [e for e in avgs if getattr(e, key) > 0 and getattr(
        e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    print(f"== profile: {label}", file=sys.stderr)
    print(avgs.table(sort_by=key, row_limit=30), file=sys.stderr)
    if not kernels:
        say(f"[profile] {label}: wall {wall:.1f} ms; the profiler saw no "
            "device time (not measured)")
        return None
    busy = sum(getattr(e, key) for e in kernels) / 1e3
    ours = sum(getattr(e, key) for e in kernels
               if any(nm in e.key for nm in names)) / 1e3
    top = sorted(kernels, key=lambda e: -getattr(e, key))[:8]
    n_launch = sum(e.count for e in kernels)
    say("[profile] %s: wall %.1f ms, device busy %.1f ms (%.1f %%), %s "
        "%.2f ms (%.1f %% of busy), %d kernel launches; top: %s" % (
            label, wall, busy, 100 * busy / wall, "/".join(names), ours,
            100 * ours / busy, n_launch,
            "; ".join(f"{e.key[:40]} {getattr(e, key) / 1e3:.2f} ms"
                      f" x{e.count}" for e in top)))
    return dict(wall=wall, busy=busy, launches=n_launch)


def k4_calls(scene, width):
    """Every K4 launch ``chip_smoke.py`` holds and times at one width, by
    name: the main path's (``closest_hit``) and each design step of
    ``cuda_traverse.K4_STEPS``; each takes (o, d, maxt)."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    layouts = {"pad": tri_k, "rows": tri}
    calls = {"main": lambda o, d, m: CT.closest_hit(
        nodes, tri, o, d, m, multi_pop=width, tri_k=tri_k)}
    for name, v in CT.K4_STEPS.items():
        calls[f"step {name}"] = (lambda v_: lambda o, d, m: (
            CT.launch_closest_mp(nodes, layouts[v_.layout], o, d, m, width,
                                 v_)))(v)
    return calls


def compare_k4(scene, o, d, maxt, n_brute=65536):
    """K4 at each multi-pop width against its plain version (every output
    equal, for the main path's launch and each design step), against K2
    (t and valid equal; the rays where the two keep different triangles
    at the same t counted) and, on the first ``n_brute`` rays, against
    K1's plain brute force.  Returns per width the errors, the plain
    version's ms and its work counts."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    from epsm_mitsuba3_torch.ops import traverse as TR
    nodes, tri = scene.bvh_nodes, scene.bvh_tris
    order = scene.bvh.order.long()
    k2 = CT.closest_hit(nodes, tri, o, d, maxt, multi_pop=0)
    k = slice(0, n_brute)
    tri_all = CI.pack_tris(scene.vertices, scene.faces)
    brute = I.ray_intersect_brute(tri_all, o[k], d[k], maxt[k])
    brute = (brute[0], brute[1].long(), *brute[2:],
             brute[1] >= 0)
    out = {}
    for width in CT.K4_WIDTHS:
        calls = k4_calls(scene, width)
        runs = {name: fn(o, d, maxt) for name, fn in calls.items()}
        got = runs["main"]
        torch.cuda.synchronize()
        CT.raise_on_overflow(o.device)
        (*plain, pops, tests), plain_ms = timed(
            lambda: TR.bvh_ray_intersect_plain(nodes, tri, o, d, maxt,
                                               counts=True,
                                               multi_pop=width))
        diffs = {name: sum(int((a != b).sum()) for a, b in zip(g, plain))
                 for name, g in runs.items()}
        say(f"[k4] P={width}: lanes differing from the plain version, by "
            "launch: " + ", ".join(f"{k} {v}" for k, v in diffs.items())
            + "  [limit 0 each]")
        check(sum(diffs.values()) == 0,
              f"K4 P={width}: a launch differs from its plain version: "
              f"{diffs}")
        n_diff = diffs["main"]
        # t is +inf on a miss in both: compare the finite entries
        err = max(float(torch.where(torch.isfinite(b), a - b, 0.0).abs()
                        .max()) for a, b in zip((got[0], got[2], got[3]),
                                                (plain[0], plain[2],
                                                 plain[3])))
        t_same = bool(torch.equal(got[0], k2[0]))
        valid_same = bool(torch.equal(got[1] >= 0, k2[1] >= 0))
        ties = int((got[1] != k2[1]).sum())
        say(f"[k4] P={width} on {o.shape[0]} main-path rays: against its "
            f"plain version {n_diff} lanes differ, max |err| {err:.3g} "
            f"(limit 0); against K2 t equal: {t_same}, valid equal: "
            f"{valid_same}, {ties} tie rays keep another triangle; "
            "overflow flag 0")
        check(n_diff == 0, f"K4 P={width} differs from its plain version")
        check(t_same and valid_same, f"K4 P={width}: t/valid != K2's")

        def prim_of(s_):
            return torch.where(s_ >= 0, order[s_.clamp(min=0).long()], -1)

        err_b = hold(f"K4 P={width} vs K1 brute force, "
                     f"{tri_all.shape[0]} tris",
                     (got[0][k], prim_of(got[1][k]), got[2][k], got[3][k],
                      got[1][k] >= 0), brute)
        out[width] = dict(err=err, err_brute=err_b[0], ties=ties,
                          plain_ms=plain_ms,
                          work=(int(pops.sum()), int(tests.sum())))
    return out


#: the leaves the training phases differentiate
TRAIN_LEAVES = ("vertices", "bsdfs.reflectance", "emitters.radiance")


def trainable(scene):
    """The scene with TRAIN_LEAVES replaced by copies that require grad,
    and those copies."""
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in scene.leaves().items() if k in TRAIN_LEAVES}
    return scene.with_leaves(leaves), leaves


def zero_counts():
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    for counts in (CI.launches, CT.launches):
        for k in counts:
            if _TALLY is not None:
                _TALLY[k] = _TALLY.get(k, 0) + counts[k]
            counts[k] = 0


def read_counts():
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    return {**CI.launches, **CT.launches}


def fwd_bwd(scene, leaves, spp, seed, integrator=None):
    """One fwd+bwd pass as bench.py's ``_bench_scene`` times it: the loss
    ``mean((img - 0)^2)`` and its gradient w.r.t. ``leaves``.  Returns
    (loss, grads, launches in the forward, launches in the backward)."""
    import torch
    import epsm_mitsuba3_torch as mt
    zero_counts()
    img = mt.render(scene, spp=spp, seed=seed, integrator=integrator)
    loss = torch.mean((img - 0.0) ** 2)
    fwd = read_counts()
    zero_counts()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, grads, fwd, read_counts()


def train_phase(label, scene, spp, passes, expect_fwd, integrator=None):
    """bench.py's fwd+bwd cell at full width: a warm-up and 3 timed runs
    of ``passes`` fwd+bwd passes.  Every pass must launch ``expect_fwd``
    in the forward and no kernel in the backward (the replay reads the
    recorded trace).  Prints the median wall ms with the range and the
    physical Mrays/s; returns (median ms, Mrays/s, the forward's counts
    of the last run, the trainable scene and its leaves)."""
    import torch
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    walls = []
    sc, leaves = trainable(scene)
    sensor = scene.sensors[0]
    lanes = sensor.width * sensor.height * spp
    torch.cuda.reset_peak_memory_stats()
    for run in ["warm-up", "timed 1", "timed 2", "timed 3"]:
        run_counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(passes):
            loss, grads, fwd, bwd = fwd_bwd(sc, leaves, spp, p + 1,
                                            integrator)
            for k, n in fwd.items():
                run_counts[k] = run_counts.get(k, 0) + n
            for k, n in expect_fwd.items():
                check(fwd[k] == n, f"{label}: {k} launched {fwd[k]} times "
                      f"in a forward, expected {n}")
            check(sum(bwd.values()) == 0,
                  f"{label}: the replay launched kernels: {bwd}")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        say(f"[{label}] {run}: {walls[-1]:.1f} ms for {passes} passes, "
            f"loss {float(loss.detach()):.6g}, gradients finite: {finite}; "
            "forward "
            f"launches {run_counts}, backward 0")
        check(finite, f"{label}: loss or gradients not finite")
    rays = lanes * DEPTH * 2 * passes
    timed_walls = sorted(walls[1:])
    median = timed_walls[1]
    mrays = rays / (median / 1e3) / 1e6
    say(f"[{label}] {sensor.width}^2 x {spp} spp, {passes} fwd+bwd passes "
        f"of {lanes} lanes, depth {DEPTH}: wall median {median:.1f} ms "
        f"(range {timed_walls[0]:.1f}-{timed_walls[-1]:.1f}); "
        f"{mrays:.2f} physical Mrays/s fwd+bwd; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    CT.raise_on_overflow(scene.device)
    return median, mrays, run_counts, (sc, leaves)


def rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def blob_normals(d):
    """``cornell_box_mesh``'s dict with outward vertex normals on the
    sphere.  Its faces wind inward, so without normals the one-sided
    diffuse sphere is black from outside and detached PRB gives its
    vertices no gradient; with interpolated normals the hit's
    barycentrics carry the vertices' gradient into the shading."""
    import numpy as np
    v = np.asarray(d["blob"]["vertices"])
    d["blob"]["normals"] = v - np.asarray([0.0, 0.7, 0.0], np.float32)
    return d


def grad_card_vs_cpu(label, d, spp):
    """The fwd+bwd gradient of every TRAIN_LEAVES leaf on the card
    (kernels) against the CPU's (plain versions)."""
    import torch
    import epsm_mitsuba3_torch as mt
    out = {}
    for dev in ("cuda", "cpu"):
        sc, leaves = trainable(mt.load_dict(d, device=dev))
        img = mt.render(sc, spp=spp, seed=0, device=dev)
        loss = (img ** 2).mean()
        out[dev] = torch.autograd.grad(loss, list(leaves.values()))
    errs = {k: rel_l2(a.cpu(), b) for k, a, b in
            zip(TRAIN_LEAVES, out["cuda"], out["cpu"])}
    norms = {k: float(b.norm()) for k, b in zip(TRAIN_LEAVES, out["cpu"])}
    res = d["sensor"]["film"]["width"]
    say(f"[grad cpu] {label} {res}^2 x {spp} spp: |g_gpu - g_cpu| / |g_cpu| "
        + ", ".join(f"{k} {e:.3g} (|g| {norms[k]:.4g})"
                    for k, e in errs.items())
        + "  [limit 1e-3 each]")
    for k, e in errs.items():
        check(e <= 1e-3, f"{label}: card and CPU gradients of {k} differ "
              f"by {e} relative")


def adam_phase(mesh_dict, gen):
    """The port's ``app/optim.run("prb_hybrid", ...)`` at thres 0 (PRB's
    loss from the first iteration) for 3 iterations on
    cornell_box_mesh: theta is a translation of the sphere's vertices,
    applied through ``set_vertices``.  Afterwards K2 on the re-packed
    scene must equal K1's brute force over the moved vertices."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    scene = mt.load_dict(blob_normals(mesh_dict))
    blob = (scene.face_shape == scene.face_shape.max())
    moving = torch.zeros(scene.vertices.shape[0], dtype=torch.bool,
                         device=scene.device)
    moving[scene.faces[blob].long().flatten()] = True
    v0 = scene.vertices

    def apply(sc, theta):
        return sc.set_vertices(
            v0 + torch.where(moving[:, None], theta["t"][None, :], 0.0))

    exp = dict(scene=scene, apply=apply,
               init_theta={"t": torch.zeros(3)},
               target_theta={"t": torch.tensor([0.1, -0.05, 0.08],
                                               device=scene.device)},
               gt_spp=ADAM_GT_SPP, it=3, spp=MESH_CHUNK, resolution=RES,
               max_depth=DEPTH, match_res=64, output=str, thres=0)
    losses = []
    t0 = time.perf_counter()
    opt, history = optim.run(
        "prb_hybrid", exp, iters=3,
        log=lambda it, loss, theta: losses.append(loss))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for it, (loss, h) in enumerate(zip(losses, history)):
        say(f"[adam] iteration {it}: loss {loss:.6g}, theta "
            f"{[round(float(x), 6) for x in h['t']]}")
    thetas = [h["t"] for h in history]
    import numpy as np
    check(all(np.isfinite(x).all() for x in thetas)
          and all(np.isfinite(x) for x in losses), "adam: not finite")
    check(float(np.abs(thetas[-1]).max()) > 0, "adam: theta did not move")
    say(f"[adam] 3 iterations at {RES}^2 x {MESH_CHUNK} spp, ground truth "
        f"at {ADAM_GT_SPP} spp: {wall:.1f} ms in all")
    final = apply(scene, {"t": opt["t"]})
    o, d, maxt = main_path_rays(final, gen, MESH_CHUNK)
    k = slice(0, 65536)
    t, slot, u, v = CT.closest_hit(final.bvh_nodes, final.bvh_tris, o[k],
                                   d[k], maxt[k])
    prim = torch.where(slot >= 0, final.bvh.order[slot.clamp(min=0).long()],
                       -1)
    tri = CI.pack_tris(final.vertices, final.faces)
    ref = I.ray_intersect_brute(tri, o[k], d[k], maxt[k])
    hold("adam: K2 on the re-packed scene vs K1 brute force, moved "
         "vertices", (t, prim, u, v, slot >= 0),
         (ref[0], ref[1].long(), ref[2], ref[3], ref[1] >= 0))


def card_vs_cpu(label, d, spp):
    """Render the scene dict ``d`` on the card and on the CPU."""
    import epsm_mitsuba3_torch as mt
    img_gpu = mt.render(mt.load_dict(d), spp=spp, seed=0).cpu()
    img_cpu = mt.render(mt.load_dict(d, device="cpu"), spp=spp, seed=0,
                        device="cpu")
    diff = (img_gpu - img_cpu).abs()
    mad, mean = float(diff.mean()), float(img_cpu.mean())
    within = float((diff.amax(-1) <= 1e-3).float().mean())
    say(f"[cpu] {label} 64^2 x {spp} spp: mean |gpu - cpu| {mad:.3g} (limit "
        f"{1e-3 * mean:.3g} = 1e-3 x mean {mean:.4f}); {100 * within:.2f} % "
        "of pixels within 1e-3 (limit 99 %)")
    check(mad <= 1e-3 * mean and within >= 0.99,
          f"{label}: card and CPU renders disagree")


class PhaseTimer:
    """CUDA events around named functions of the port, by wrapping the
    module attributes the EPSM backward calls them through (the path run
    is unchanged): ``wrap(module, attr, label)``; ``read()`` waits for
    the device and returns ms by label since the last read."""

    def __init__(self):
        self.pending, self.saved = [], []

    def wrap(self, module, attr, label):
        import torch
        fn = getattr(module, attr)

        def timed_fn(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.pending.append((label, start, end))
            return out

        setattr(module, attr, timed_fn)
        self.saved.append((module, attr, fn))

    def wrap_call(self, label, fn):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self.pending.append((label, start, end))
        return out

    def read(self):
        import torch
        torch.cuda.synchronize()
        out = {}
        for label, s, e in self.pending:
            out[label] = out.get(label, 0.0) + s.elapsed_time(e)
        self.pending = []
        return out

    def close(self):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)
        self.saved = []


def epsm_backward_timer():
    """A PhaseTimer on the stages of the EPSM backward: the logged pass,
    the first-hit derivative, the Jacobians (within calc_grad, whose rest
    is the solves), the injection, and the PRB recording pass and replay."""
    from epsm_mitsuba3_torch.ad import prb
    from epsm_mitsuba3_torch.integrators import epsm as ET
    from epsm_mitsuba3_torch.integrators import path as P
    timer = PhaseTimer()
    timer.wrap(ET, "sample_path_logged", "logged pass")
    timer.wrap(ET, "first_hit_jvp", "first hit")
    timer.wrap(ET, "_row_jacobians_all", "Jacobians")
    timer.wrap(ET, "calc_grad", "calc_grad")
    timer.wrap(ET, "inject_gradients", "injection")
    timer.wrap(P, "sample_primal_recorded", "PRB recording pass")
    timer.wrap(prb, "prb_backward", "PRB replay")
    return timer


def split_phases(ms):
    """The phase split of one EPSM iteration from a PhaseTimer's read."""
    out = dict(ms)
    out["solves"] = out.pop("calc_grad", 0.0) - out.get("Jacobians", 0.0)
    bwd = out.pop("backward", 0.0)
    out["backward, other"] = bwd - sum(
        out.get(k, 0.0) for k in ("logged pass", "first hit", "Jacobians",
                                  "solves", "injection",
                                  "PRB recording pass", "PRB replay"))
    return out


def epsm_mesh_phase():
    """[epsm mesh]: bench.py's ``manifold_iter`` at its own size. theta is
    an x-offset of every vertex (through ``set_vertices``); each iteration
    renders with the ``manifold`` integrator, matches at 128^2 with the
    Sinkhorn matcher against a 8-spp reference (seed 123) and takes the
    gradient of sum(img * g5).  A warm-up and EPSM_ITERS timed
    iterations: ms by phase (CUDA events), K1-K4 launches (exactly 4
    depth + 1 K2 and 3 depth K3 an iteration, K1 and K4 none), the
    gradient finite and non-zero, the overflow flag 0, peak memory; then
    one profiled iteration.  Returns (the timed iterations' phases and
    walls, the last launch counts, the Sinkhorn inputs)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    scene = mt.load_dict(cornell_box_mesh(res=EPSM_RES, spp=EPSM_SPP,
                                          max_depth=DEPTH))
    dev = scene.device
    matcher = Matcher(EPSM_RES)
    integ = {"type": "manifold", "max_depth": DEPTH}
    with torch.no_grad():
        img_ref = mt.render(scene, spp=EPSM_SPP, seed=123,
                            integrator={"type": "path", "max_depth": DEPTH})
    gt_low = img_ref[..., :3].reshape(-1, 3)
    v0 = scene.vertices
    ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
    timer = epsm_backward_timer()
    last = {}

    def iteration(seed):
        theta = torch.tensor(0.01, device=dev, requires_grad=True)
        sc = scene.set_vertices(v0 + theta * ex)
        img = timer.wrap_call("forward render", lambda: mt.render(
            sc, spp=EPSM_SPP, seed=seed, integrator=integ))
        with torch.no_grad():
            img_low = img[..., :3].reshape(-1, 3)
            g5 = timer.wrap_call("Sinkhorn match", lambda: (
                matcher.match_Sinkhorn(img_low, gt_low)))
            g5 = g5.reshape(EPSM_RES, EPSM_RES, 5)
        loss = torch.sum(img * g5)
        (g,) = timer.wrap_call("backward", lambda: torch.autograd.grad(
            loss, theta))
        last["img_low"] = img_low
        return g

    phases, walls = [], []
    try:
        torch.cuda.reset_peak_memory_stats()
        for i, run in enumerate(["warm-up"] + [f"timed {k + 1}" for k in
                                               range(EPSM_ITERS)]):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = iteration(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            ms = split_phases(timer.read())
            gval = float(g)
            say(f"[epsm mesh] {run}: {wall:.1f} ms, dL/dtheta {gval:.6g}; "
                + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                + f" ms; launches {counts}")
            check(math.isfinite(gval) and gval != 0.0,
                  f"epsm mesh: gradient {gval} not finite and non-zero")
            expect = {"bvh4_closest_hit": 4 * DEPTH + 1,
                      "bvh4_any_hit": 3 * DEPTH, "bvh4_closest_hit_mp": 0,
                      "mt_closest_hit": 0, "mt_any_hit": 0}
            for k, n in expect.items():
                check(counts[k] == n, f"epsm mesh: {k} launched "
                      f"{counts[k]} times an iteration, expected {n}")
            CT.raise_on_overflow(dev)
            if i:
                phases.append(ms)
                walls.append(wall)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_pass("epsm mesh, one manifold iteration",
                            lambda: iteration(99),
                            ("bvh4_closest", "bvh4_any"), cpu=False,
                            table=False)
        timer.read()
    finally:
        timer.close()
    mean = {k: sum(p[k] for p in phases) / len(phases) for k in phases[0]}
    ws = sorted(walls)
    say(f"[epsm mesh] cornell_box_mesh {EPSM_RES}^2 x {EPSM_SPP} spp, depth "
        f"{DEPTH}, match_res {EPSM_RES}, {len(walls)} timed iterations: "
        f"wall median {ws[len(ws) // 2]:.1f} ms (range {ws[0]:.1f}-"
        f"{ws[-1]:.1f}); mean ms by phase (CUDA events): "
        + ", ".join(f"{k} {v:.1f}" for k, v in mean.items())
        + f"; peak device memory {peak:.2f} GiB; device busy "
        + (f"{prof['busy']:.1f} of {prof['wall']:.1f} ms "
           f"({100 * prof['busy'] / prof['wall']:.1f} %)" if prof
           else "not measured"))
    return dict(phases=mean, walls=walls, peak_gib=peak, profile=prof,
                counts=counts, x=last["img_low"], y=gt_low)


def epsm_cornellbox_phase():
    """[epsm cornellbox]: ``run("manifold_caustic_hybrid", cornellbox.make(
    ...), iters=CB_ITERS)`` at the experiment's published widths, thres
    CB_THRES, so that the switch to PRB's loss and the Adam reset run.
    K1 launches counted an iteration: exactly 25 closest and 18 any hits
    a manifold pass (6 + 6 forward; the logged pass 12 + 6, the first hit
    1, the recording pass 6 + 6), 6 + 6 a PRB pass, and the ground
    truth's 6 + 6 a pass in iteration 0.  Returns the counts of the run."""
    import torch
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.app.exp import cornellbox
    exp = cornellbox.make(resolution=CB_RES, spp=CB_SPP, it=CB_ITERS,
                          thres=CB_THRES, max_depth=DEPTH, match_res=128)
    exp["gt_spp"] = CB_GT_SPP
    chunk = max(1, min(CB_SPP, 2_000_000 // (CB_RES * CB_RES)))
    n_pass, n_gt = -(-CB_SPP // chunk), -(-CB_GT_SPP // chunk)
    rows, total = [], {}
    zero_counts()
    torch.cuda.synchronize()
    mark = [time.perf_counter()]

    def log(it, loss, theta):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = read_counts()
        zero_counts()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        rows.append(dict(it=it, ms=(now - mark[0]) * 1e3, loss=loss,
                         theta=[float(theta[f"rot{i}"]) for i in range(6)],
                         counts=counts))
        mark[0] = now

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    optim.run("manifold_caustic_hybrid", exp, iters=CB_ITERS, log=log)
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in rows:
        manifold = r["it"] < CB_THRES
        per = (25, 18) if manifold else (DEPTH, DEPTH)
        gt = n_gt * DEPTH if r["it"] == 0 else 0
        expect = {"mt_closest_hit": n_pass * per[0] + gt,
                  "mt_any_hit": n_pass * per[1] + gt,
                  "bvh4_closest_hit": 0, "bvh4_any_hit": 0}
        say(f"[epsm cornellbox] iteration {r['it']} "
            f"({'manifold_caustic' if manifold else 'prb, Adam reset'}"
            f"{', with the ground truth' if r['it'] == 0 else ''}): "
            f"{r['ms']:.1f} ms, loss {r['loss']:.6g}, theta "
            f"{[round(x, 6) for x in r['theta']]}, launches {r['counts']}")
        for k, n in expect.items():
            check(r["counts"][k] == n, f"epsm cornellbox: {k} launched "
                  f"{r['counts'][k]} times in iteration {r['it']}, "
                  f"expected {n}")
        check(math.isfinite(r["loss"]) and all(
            math.isfinite(x) for x in r["theta"]), "epsm cornellbox: "
            "loss or theta not finite")
    check(max(abs(x - math.pi / 3) for x in rows[-1]["theta"]) > 0,
          "epsm cornellbox: theta did not move")
    say(f"[epsm cornellbox] {CB_RES}^2, six lights, depth {DEPTH}, "
        f"match_res 128, spp {CB_SPP} (published 256) in {n_pass} passes "
        f"of {chunk}, ground truth at {CB_GT_SPP} spp (default 512), "
        f"{CB_ITERS} iterations of manifold_caustic_hybrid at thres "
        f"{CB_THRES}: {wall:.1f} ms in all; K1 launches "
        f"{total.get('mt_closest_hit', 0)} closest / "
        f"{total.get('mt_any_hit', 0)} any; peak device memory "
        f"{peak:.2f} GiB")
    exp["gt_spp"] = 1
    prof = profile_pass("epsm cornellbox, one manifold_caustic iteration "
                        "(and a 1-spp ground truth)",
                        lambda: optim.run("manifold_caustic", exp, iters=1),
                        ("mt_closest", "mt_any"), cpu=False, table=False)
    return dict(rows=rows, total=total, wall=wall, peak_gib=peak,
                profile=prof)


def epsm_card_vs_cpu(x, y):
    """[epsm card vs cpu]: (i) one manifold_caustic gradient of theta on
    cornellbox at 32^2, spp 4, match_res 32, depth 4, on the card and on
    the CPU (the plain versions), both through one OT gradient (the
    card's matcher on the card's render): relative L2 <= 1e-3, as the
    other gradient checks; (ii) the Sinkhorn matcher at MATCH_CMP_RES^2
    on the mesh phase's inputs (resized from 128^2) on the card and on
    the CPU in float32, and on the card in float64: at eps = 1e-4 float32
    is itself ~1e-3 of the largest entry off the exact result, so the
    check is relative L2 <= 1e-2 and a largest difference within twice
    the larger of the two float32 results' distances to float64."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.app.exp import cornellbox
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    kw = dict(resolution=32, spp=4, match_res=32, max_depth=4)
    integ = {"type": "manifold_caustic", "max_depth": 4}
    g5 = None
    grads = {}
    for dev in ("cuda", "cpu"):
        exp = cornellbox.make(device=dev, **kw)
        if g5 is None:
            with torch.no_grad():
                gt = mt.render(exp["apply"](exp["scene"],
                                            exp["target_theta"]), spp=16,
                               seed=0, device=dev,
                               integrator={"type": "path", "max_depth": 4})
                img = mt.render(exp["apply"](exp["scene"],
                                             exp["init_theta"]), spp=4,
                                seed=0, sensor=1, device=dev, integrator=integ)
                g5 = Matcher(32).match_Sinkhorn(
                    optim._resize(img[..., :3], 32).reshape(-1, 3),
                    optim._resize(gt[..., :3], 32).reshape(-1, 3)).reshape(
                        32, 32, 5)
        theta = {k: v.clone().requires_grad_(True)
                 for k, v in exp["init_theta"].items()}
        img = mt.render(exp["apply"](exp["scene"], theta), spp=4, seed=0,
                        sensor=1, integrator=integ, device=dev)
        loss = torch.sum(img * g5.to(dev))
        gs = torch.autograd.grad(loss, list(theta.values()))
        grads[dev] = torch.stack([g.detach().cpu() for g in gs])
    err = rel_l2(grads["cuda"], grads["cpu"])
    say(f"[epsm card vs cpu] manifold_caustic dL/dtheta on cornellbox 32^2 "
        f"x 4 spp, depth 4: card {[round(float(v), 7) for v in grads['cuda']]}"
        f", cpu {[round(float(v), 7) for v in grads['cpu']]}; |g_gpu - "
        f"g_cpu| / |g_cpu| {err:.3g}  [limit 1e-3]")
    check(err <= 1e-3, f"epsm: card and CPU theta gradients differ by {err}")
    check(float(grads["cpu"].abs().max()) > 0, "epsm: zero theta gradient")

    res = MATCH_CMP_RES
    x, y = (optim._resize(v.reshape(EPSM_RES, EPSM_RES, 3), res).reshape(
        -1, 3) for v in (x, y))
    t0 = time.perf_counter()
    g_card = Matcher(res).match_Sinkhorn(x, y)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    g64 = Matcher(res).match_Sinkhorn(x.double(), y.double())
    t0 = time.perf_counter()
    g_cpu = Matcher(res, device="cpu").match_Sinkhorn(x.cpu(), y.cpu())
    cpu_s = time.perf_counter() - t0
    g_card, g64 = g_card.cpu(), g64.cpu()
    top = float(g64.abs().max())

    def far(a, b):
        return float((a.double() - b.double()).abs().max()) / top

    e_cc, e_card, e_cpu = far(g_card, g_cpu), far(g_card, g64), far(g_cpu,
                                                                     g64)
    l2 = rel_l2(g_card.double(), g_cpu.double())
    say(f"[epsm card vs cpu] match_Sinkhorn at {res}^2 ({x.shape[0]} "
        f"points, the mesh phase's inputs resized): card {card_s:.2f} s, cpu "
        f"{cpu_s:.2f} s; largest |difference| / largest |g64|: card-cpu "
        f"{e_cc:.3g}, card-f64 {e_card:.3g}, cpu-f64 {e_cpu:.3g}; relative "
        f"L2 card-cpu {l2:.3g}  [limits: L2 1e-2, card-cpu <= 2 x "
        f"max(card-f64, cpu-f64)]")
    check(l2 <= 1e-2 and e_cc <= 2.0 * max(e_card, e_cpu),
          "epsm: card and CPU matchers disagree")
    return dict(theta_grad_rel_l2=err, match_rel_l2=l2, match_far=e_cc,
                card_f64=e_card, cpu_f64=e_cpu)


# ---------------------------------------------------------------------------
# [epsm experiments]: the paper's glass, rough-metal and many-object
# experiments through run(...), and K1-K3 on their own rays
# ---------------------------------------------------------------------------

def _pass_count(spp, res):
    """The passes ``run`` renders ``spp`` in at ``res``^2 (its
    ``spp_chunk``: at most 2,000,000 lanes a pass) and the chunk."""
    chunk = max(1, min(spp, 2_000_000 // (res * res)))
    return -(-spp // chunk), chunk


def _labelled_render(timer, render):
    """``app/optim.py``'s ``render`` timed by CUDA events: the ground
    truth (the ``path`` integrator) apart from the method's forward."""
    def call(*a, **kw):
        kind = (kw.get("integrator") or {}).get("type")
        label = "ground truth" if kind == "path" else "forward render"
        return timer.wrap_call(label, lambda: render(*a, **kw))
    return call


def experiment_run(name, spp, gt_spp, iters, do_profile=True,
                   each_leaf=True, match_res=EXP_MATCH, profile_table=True):
    """``run(method, <name>.make(...))`` at EXP_RES^2 and ``match_res``
    (EXP_MATCH unless given), each config's own depth and method (its scene's
    integrator), ``iters`` iterations.  ms an iteration (the ground truth
    apart), ms by phase (CUDA events), launches an iteration (each count
    exact: a manifold pass launches 4 D + 1 closest and 3 D any hits, a
    ground-truth pass D and D), the loss, theta and every theta gradient
    finite and non-zero (each leaf's, with ``each_leaf``), theta moved,
    peak device
    memory, the BVH build's seconds and set_vertices' ms; then one
    profiled iteration (with a 1-spp ground truth).  Returns the rows,
    the launch totals and the summary."""
    import importlib
    import torch
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.models import scene as scene_mod
    from epsm_mitsuba3_torch.ops import bvh as bvh_mod
    mod = importlib.import_module(f"epsm_mitsuba3_torch.app.exp.{name}")
    build_s = []
    orig_build = bvh_mod.build

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = orig_build(*a, **kw)
        build_s.append(time.perf_counter() - t0)
        return out

    bvh_mod.build = timed_build
    try:
        t0 = time.perf_counter()
        exp = mod.make(resolution=EXP_RES, spp=spp, it=iters,
                       match_res=match_res)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        bvh_mod.build = orig_build
    exp["gt_spp"] = gt_spp
    scene = exp["scene"]
    method = dict(scene.static.integrator)["type"]
    depth = exp["max_depth"]
    n_tris = scene.faces.shape[0]
    bvh = scene.bvh is not None
    say(f"[epsm experiments] {name}: {n_tris} triangles ("
        + (f"BVH of {scene.bvh_nodes.shape[0]} BVH4 records, built in "
           f"{sum(build_s):.2f} s" if bvh else "brute force, K1")
        + f"), loaded in {load_s:.2f} s; {method}, depth {depth}, "
        f"{EXP_RES}^2 x {spp} spp, ground truth {gt_spp} spp, match_res "
        f"{match_res}, {iters} iterations")

    timer = epsm_backward_timer()
    timer.wrap(optim.Matcher, "match_Sinkhorn", "Sinkhorn match")
    timer.wrap(scene_mod.Scene, "set_vertices", "set_vertices")
    orig_render, orig_step = optim.render, optim.Adam.step
    optim.render = _labelled_render(timer, orig_render)
    grads = []

    def step(self, g):
        grads.append({k: v.detach().clone() for k, v in g.items()})
        return orig_step(self, g)

    optim.Adam.step = step
    rows, total = [], {}
    zero_counts()
    torch.cuda.synchronize()
    mark = [time.perf_counter()]

    def log(it, loss, theta):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = read_counts()
        zero_counts()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        ms = split_phases(timer.read())
        ms["backward, other"] = None   # run() calls autograd itself
        rows.append(dict(it=it, wall=(now - mark[0]) * 1e3, loss=loss,
                         theta={k: v.copy() for k, v in theta.items()},
                         counts=counts, phases=ms))
        mark[0] = now

    try:
        torch.cuda.reset_peak_memory_stats()
        optim.run(method, exp, iters=iters, log=log)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = None
        if do_profile:
            exp["gt_spp"] = 1
            prof = profile_pass(
                f"epsm {name}, one {method} iteration (and a 1-spp ground "
                "truth)", lambda: optim.run(method, exp, iters=1),
                ("bvh4_closest", "bvh4_any") if bvh
                else ("mt_closest", "mt_any"), cpu=False,
                table=profile_table)
            timer.read()
    finally:
        optim.render, optim.Adam.step = orig_render, orig_step
        timer.close()

    n_pass, _ = _pass_count(spp, EXP_RES)
    n_gt, _ = _pass_count(gt_spp, EXP_RES)
    closest, anyhit = (("bvh4_closest_hit", "bvh4_any_hit") if bvh
                       else ("mt_closest_hit", "mt_any_hit"))
    walls = []
    for r, g in zip(rows, grads):
        gt = n_gt * depth if r["it"] == 0 else 0
        expect = {closest: n_pass * (4 * depth + 1) + gt,
                  anyhit: n_pass * 3 * depth + gt}
        for k in ("mt_closest_hit", "mt_any_hit", "bvh4_closest_hit",
                  "bvh4_any_hit", "bvh4_closest_hit_mp"):
            expect.setdefault(k, 0)
        ph = r["phases"]
        wall = r["wall"] - ph.get("ground truth", 0.0)
        walls.append(wall)
        gsum = {k: (float(v.abs().max()), bool(torch.isfinite(v).all()
                                               and v.abs().max() < 1e30))
                for k, v in g.items()}
        say(f"[epsm experiments] {name} iteration {r['it']}"
            + (" (with the ground truth)" if r["it"] == 0 else "")
            + f": {r['wall']:.1f} ms, {wall:.1f} without the ground truth; "
            f"loss {r['loss']:.6g}; theta "
            + "; ".join(f"{k} {[round(float(x), 6) for x in v.ravel()[:6]]}"
                        for k, v in r["theta"].items())
            + "; max |dL/dtheta| "
            + ", ".join(f"{k} {m:.4g}" for k, (m, _) in gsum.items())
            + "; ms by phase "
            + ", ".join(f"{k} {v:.1f}" for k, v in ph.items()
                        if v is not None)
            + f"; launches {r['counts']}")
        for k, n in expect.items():
            check(r["counts"][k] == n, f"{name}: {k} launched "
                  f"{r['counts'][k]} times in iteration {r['it']}, "
                  f"expected {n}")
        check(math.isfinite(r["loss"]), f"{name}: loss not finite")
        for k, (m, finite) in gsum.items():
            check(finite and (m > 0 or not each_leaf), f"{name}: dL/d{k} "
                  f"not finite and non-zero ({m})")
        check(max(m for m, _ in gsum.values()) > 0, f"{name}: zero "
              "gradient")
        for k, v in r["theta"].items():
            check(bool((abs(v) < 1e30).all()), f"{name}: theta {k} not "
                  "finite")
    init = exp["init_theta"]
    moved = max(float((torch.as_tensor(rows[-1]["theta"][k])
                       - init[k].cpu()).abs().max()) for k in init)
    check(moved > 0, f"{name}: theta did not move")
    mean = {k: sum(r["phases"].get(k) or 0.0 for r in rows) / len(rows)
            for k in rows[0]["phases"] if k != "backward, other"}
    ws = sorted(walls)
    say(f"[epsm experiments] {name} summary: ms an iteration without the "
        f"ground truth median {ws[len(ws) // 2]:.1f} (range {ws[0]:.1f}-"
        f"{ws[-1]:.1f}); {n_pass} passes of a manifold backward each; mean "
        "ms by phase (CUDA events) "
        + ", ".join(f"{k} {v:.1f}" for k, v in mean.items())
        + f"; peak device memory {peak:.2f} GiB; device busy "
        + (f"{prof['busy']:.1f} of {prof['wall']:.1f} ms "
           f"({100 * prof['busy'] / prof['wall']:.1f} %)" if prof
           else "not measured")
        + f"; launches in all {total}"
        + (f"; BVH build {sum(build_s):.2f} s, set_vertices (refit + "
           f"pack_bvh4) {mean.get('set_vertices', 0.0):.1f} ms an "
           "iteration" if bvh else ""))
    return dict(rows=rows, grads=grads[:len(rows)], total=total,
                walls=walls,
                phases=mean, peak_gib=peak, profile=prof, exp=exp,
                build_s=sum(build_s), load_s=load_s, method=method)


def _record_rays(module, names, fn):
    """Run ``fn`` with ``module``'s functions ``names`` wrapped to keep
    copies of their arguments; returns {name: [args, ...]}."""
    rec = {nm: [] for nm in names}
    orig = {nm: getattr(module, nm) for nm in names}

    def keep(nm):
        def call(*a, **kw):
            rec[nm].append(([x.clone() if hasattr(x, "clone") else x
                             for x in a], dict(kw)))
            return orig[nm](*a, **kw)
        return call

    for nm in names:
        setattr(module, nm, keep(nm))
    try:
        fn()
    finally:
        for nm in names:
            setattr(module, nm, orig[nm])
    return rec


def exp_rays_k1(exp, subset=2 ** 18, name="egg", chunk=None):
    """K1 at egg's 3,972 triangles (or experiment ``name``'s) on the rays
    one EXP_RES^2 forward pass of its manifold render hands to
    ``closest_hit`` / ``any_hit`` (a pass of ``chunk`` spp, by default
    ``run``'s): each depth's launches held bit for bit against the plain
    versions on the first ``subset`` rays, timed on the device alone
    beside the bound (closest hit: every live ray tests every triangle;
    any hit: each live ray's tests up to its first hit) and the plain
    versions on the subset."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import intersect as I
    scene = exp["apply"](exp["scene"], exp["init_theta"])
    if chunk is None:
        _, chunk = _pass_count(exp["spp"], EXP_RES)
    with torch.no_grad():
        rec = _record_rays(CI, ("closest_hit", "any_hit"), lambda: mt.render(
            scene, spp=chunk, seed=5, sensor=1))
    torch.cuda.synchronize()
    depth = exp["max_depth"]
    check(len(rec["closest_hit"]) == depth and len(rec["any_hit"]) == depth,
          f"a {name} pass made {len(rec['closest_hit'])} closest-hit and "
          f"{len(rec['any_hit'])} any-hit calls, expected {depth} each")
    out = []
    for d, (c, a) in enumerate(zip(rec["closest_hit"], rec["any_hit"])):
        (tri, o, dd, maxt), (tri_a, oa, da, ma) = c[0], a[0]
        f, n = tri.shape[0], o.shape[0]
        got = (*CI.closest_hit(tri, o, dd, maxt),
               CI.any_hit(tri_a, oa, da, ma))
        k = slice(0, subset)
        ref_c, plain_c_ms = timed(lambda: I.ray_intersect_brute(
            tri, o[k], dd[k], maxt[k]))
        ref_a, plain_a_ms = timed(lambda: I.ray_test_brute(
            tri_a, oa[k], da[k], ma[k]))
        ref = (*ref_c, ref_a)
        diff = {nm: int((x[k] != y).sum()) for nm, x, y in
                zip(K1_FIELDS, got, ref)}
        check(sum(diff.values()) == 0, f"{name} depth {d}: K1 differs "
              f"from the plain versions on {diff}")
        ms_c = device_ms(lambda: CI.closest_hit(tri, o, dd, maxt), 10)
        ms_a = device_ms(lambda: CI.any_hit(tri_a, oa, da, ma), 10)
        live_c = int((maxt > 1e-6).sum())
        live_a = int((ma > 1e-6).sum())
        b_c, by_c = k1_bound(tri, o, dd, maxt, False)
        b_a, by_a = k1_bound(tri_a, oa, da, ma, True)
        row = dict(depth=d, rays=n, live_closest=live_c, live_any=live_a,
                   closest_ms=ms_c, any_ms=ms_a, closest_bound_ms=b_c,
                   closest_bound_by=by_c, any_bound_ms=b_a,
                   any_bound_by=by_a, plain_rays=min(n, subset),
                   closest_plain_ms=plain_c_ms, any_plain_ms=plain_a_ms)
        out.append(row)
        say(f"[{name} rays K1] depth {d}: {f} tris x {n} rays ({live_c} live; "
            f"{int((got[1] >= 0).sum())} hits): closest {ms_c:.4f} ms "
            f"(bound {b_c:.4f} by {by_c}, {b_c / ms_c:.1%}); {live_a} live "
            f"shadow rays ({int(got[4].sum())} occluded): any {ms_a:.4f} ms "
            f"(bound {b_a:.4f} by {by_a}, {b_a / ms_a:.1%}); plain versions "
            f"on {min(n, subset)} of them {plain_c_ms:.1f} / "
            f"{plain_a_ms:.1f} ms; bit for bit equal there (0 lanes differ "
            f"in {', '.join(K1_FIELDS)})")
    return out


def exp_rays_k23(exp, subset=2 ** 18):
    """K2/K3 on shadow's tree (1,587,204 triangles at 400 spheres) on the
    rays one EXP_RES^2 forward pass hands to ``closest_hit`` /
    ``any_hit``: each depth's launches held bit for bit against the plain
    versions on the first ``subset`` rays, timed on the device alone
    beside the bound from the plain versions' work on all of the rays
    (their pops and triangle tests, and the records and rows read)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import traverse as TR
    scene = exp["apply"](exp["scene"], exp["init_theta"])
    _, chunk = _pass_count(exp["spp"], EXP_RES)
    with torch.no_grad():
        rec = _record_rays(CT, ("closest_hit", "any_hit"), lambda: mt.render(
            scene, spp=chunk, seed=5, sensor=1))
    torch.cuda.synchronize()
    CT.raise_on_overflow(scene.device)
    depth = exp["max_depth"]
    check(len(rec["closest_hit"]) == depth and len(rec["any_hit"]) == depth,
          f"a shadow pass made {len(rec['closest_hit'])} closest-hit and "
          f"{len(rec['any_hit'])} any-hit calls, expected {depth} each")
    nodes, tri, tri_k = scene.bvh_nodes, scene.bvh_tris, scene.bvh_tris_k
    out = []
    for d, (c, a) in enumerate(zip(rec["closest_hit"], rec["any_hit"])):
        (o, dd, maxt), kw_c = c[0][2:5], c[1]
        (oa, da, ma), kw_a = a[0][2:5], a[1]
        n = o.shape[0]
        got = (*CT.closest_hit(nodes, tri, o, dd, maxt, **kw_c),
               CT.any_hit(nodes, tri, oa, da, ma, **kw_a))
        CT.raise_on_overflow(scene.device)
        k = slice(0, subset)
        (t_p, s_p, u_p, v_p), plain_c_ms = timed(
            lambda: TR.bvh_ray_intersect_plain(nodes, tri, o[k], dd[k],
                                               maxt[k]))
        occ_p, plain_a_ms = timed(lambda: TR.bvh_ray_test_plain(
            nodes, tri, oa[k], da[k], ma[k]))
        diff = {nm: int((x[k] != y).sum()) for nm, x, y in zip(
            ("t", "slot", "u", "v", "occ"), got, (t_p, s_p, u_p, v_p,
                                                  occ_p))}
        check(sum(diff.values()) == 0, f"shadow depth {d}: K2/K3 differ "
              f"from the plain versions on {diff}")
        work_c = bvh_plain_work(nodes, tri, o, dd, maxt, False)
        work_a = bvh_plain_work(nodes, tri, oa, da, ma, True)
        pops, tests, _, rows_c = work_c
        pops_a, tests_a, _, rows_a = work_a
        ms_c = device_ms(lambda: CT.closest_hit(nodes, tri, o, dd, maxt,
                                                **kw_c), 10)
        ms_a = device_ms(lambda: CT.any_hit(nodes, tri, oa, da, ma, **kw_a),
                         10)
        bytes_c, ops_c = bvh_work(maxt, work_c, False)
        bytes_a, ops_a = bvh_work(ma, work_a, True)
        b_c, by_c = bound_ms(bytes_c, ops_c)
        b_a, by_a = bound_ms(bytes_a, ops_a)
        live_c = int((maxt > 1e-6).sum())
        live_a = int((ma > 1e-6).sum())
        row = dict(depth=d, rays=n, live_closest=live_c, live_any=live_a,
                   closest_ms=ms_c, any_ms=ms_a, closest_bound_ms=b_c,
                   closest_bound_by=by_c, any_bound_ms=b_a,
                   any_bound_by=by_a, pops=pops, tests=tests,
                   pops_any=pops_a, tests_any=tests_a, rows_read=rows_c,
                   rows_read_any=rows_a,
                   plain_rays=min(n, subset), closest_plain_ms=plain_c_ms,
                   any_plain_ms=plain_a_ms, closest_mb=bytes_c / 1e6,
                   any_mb=bytes_a / 1e6, rows_mb=tri_k.numel() * 4 / 1e6)
        out.append(row)
        say(f"[shadow rays K2/K3] depth {d}: {tri.shape[0]} tris "
            f"({row['rows_mb']:.1f} MB of 48-byte rows), {n} rays ({live_c} "
            f"live, {int((got[1] >= 0).sum())} hits; "
            f"{pops / max(live_c, 1):.2f} pops, "
            f"{tests / max(live_c, 1):.2f} tests a live ray, {rows_c} "
            f"distinct rows): K2 "
            f"{ms_c:.4f} ms (bound {b_c:.4f} by {by_c}: {ops_c / 1e6:.1f} M "
            f"operations, {bytes_c / 1e6:.1f} MB; {b_c / ms_c:.1%}); "
            f"{live_a} live shadow rays ({int(got[4].sum())} occluded; "
            f"{pops_a} pops, {tests_a} tests, {rows_a} distinct rows): K3 "
            f"{ms_a:.4f} ms (bound "
            f"{b_a:.4f} by {by_a}: {ops_a / 1e6:.1f} M operations, "
            f"{bytes_a / 1e6:.1f} MB; {b_a / ms_a:.1%}); "
            f"plain versions on {min(n, subset)} of them {plain_c_ms:.1f} / "
            f"{plain_a_ms:.1f} ms; bit for bit equal there (0 lanes differ "
            "in t, slot, u, v, occ)")
    return out


def exp_card_vs_cpu(cases=(("glossyball", 2), ("egg", 4)),
                    label="epsm experiments, card vs cpu"):
    """[epsm experiments, card vs cpu]: at 64^2 x 4 spp, match_res 32,
    each gradient of sum(img * g5) for one fixed OT gradient g5 (seeded),
    on the card and on the CPU, for ``cases`` (config, depth): by default
    glossyball's translation and roughness (manifold_caustic, depth 2)
    and egg's glass-vertex gradients (manifold_caustic, depth 4 of the
    published 6, for the CPU's time); a config's theta otherwise:
    relative L2 <= 1e-3 each."""
    import importlib
    import torch
    import epsm_mitsuba3_torch as mt
    g5 = (torch.randn((64, 64, 5), generator=torch.Generator().manual_seed(
        13)) * 0.05)
    out = {}
    for name, depth in cases:
        mod = importlib.import_module(f"epsm_mitsuba3_torch.app.exp.{name}")
        grads, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            exp = mod.make(resolution=64, spp=4, match_res=32,
                           max_depth=depth, device=dev)
            integ = {"type": "manifold_caustic", "max_depth": depth}
            theta = {k: v.clone().requires_grad_(True)
                     for k, v in exp["init_theta"].items()}
            sc = exp["apply"](exp["scene"], theta)
            if name == "egg":
                v = sc.vertices.detach().clone().requires_grad_(True)
                sc = sc.with_leaves({"vertices": v})
                leaves = {"glass vertices": v}
            else:
                leaves = theta
            img = mt.render(sc, spp=4, seed=0, sensor=1, integrator=integ,
                            device=dev)
            gs = torch.autograd.grad(torch.sum(img * g5.to(dev)),
                                     list(leaves.values()))
            if name == "egg":
                s, c = exp["scene"].static.vertex_ranges[
                    list(exp["scene"].static.shape_names).index("egg")]
                gs = (gs[0][s:s + c],)
            grads[dev] = {k: g.detach().cpu() for k, g in zip(leaves, gs)}
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
        for k in grads["cpu"]:
            a, b = grads["cuda"][k], grads["cpu"][k]
            err = rel_l2(a, b)
            out[f"{name} {k}"] = err
            say(f"[{label}] {name} dL/d{k} at 64^2 x "
                f"4 spp, depth {depth}: |g| {float(b.norm()):.6g}, first "
                f"entries card {[round(float(x), 7) for x in a.ravel()[:3]]}"
                f" cpu {[round(float(x), 7) for x in b.ravel()[:3]]}; |g_gpu"
                f" - g_cpu| / |g_cpu| {err:.3g}  [limit 1e-3]; card "
                f"{secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s")
            check(float(b.abs().max()) > 0, f"{name}: zero dL/d{k}")
            check(err <= 1e-3, f"{name}: card and CPU dL/d{k} differ by "
                  f"{err}")
    return out


def epsm_experiments_phase():
    """[epsm experiments]: egg, glossyball, highlight and shadow through
    ``run`` at EXP_RES^2 (EXP_CELLS: spp and ground truth cut), EXP_ITERS
    iterations each; bunny, bathroom and bedroom one iteration each at
    EXP_ONE_SPP; K1 at egg's 3,972 triangles and K2/K3 on shadow's tree on
    their own rays; the card against the CPU.  Returns the runs, the
    kernel rows and the launch totals."""
    runs, total, secs = {}, {}, {}
    k1_rows = k23_rows = None

    def clock(label, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[label] = time.perf_counter() - t0
        return out

    for name, spp, gt_spp in EXP_CELLS:
        runs[name] = clock(name, lambda: experiment_run(
            name, spp, gt_spp, EXP_ITERS, do_profile=name in EXP_PROFILED))
        if name == "egg":
            k1_rows = clock("K1 on egg's rays",
                            lambda: exp_rays_k1(runs[name]["exp"]))
        if name == "shadow":
            k23_rows = clock("K2/K3 on shadow's rays",
                             lambda: exp_rays_k23(runs[name]["exp"]))
        runs[name].pop("exp")
    for name in EXP_ONE:
        runs[name] = clock(name, lambda: experiment_run(
            name, EXP_ONE_SPP, EXP_ONE_SPP, 1, do_profile=False,
            each_leaf=False))
        runs[name].pop("exp")
    for r in runs.values():
        for k, n in r["total"].items():
            total[k] = total.get(k, 0) + n
    g = runs["glossyball"]["grads"]
    say("[epsm experiments] glossyball dL/dalpha an iteration: "
        + ", ".join(f"{float(x['alpha']):.6g}" for x in g)
        + "; dL/dtrans " + "; ".join(
            str([round(float(v), 6) for v in x["trans"]]) for x in g))
    cpu = clock("card vs cpu", exp_card_vs_cpu)
    say("[epsm experiments] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    return dict(runs=runs, total=total, k1=k1_rows, k23=k23_rows, cpu=cpu,
                secs=secs)


# ---------------------------------------------------------------------------
# [scene files]: the box with the mesh written to files, loaded with
# load_file, against load_dict of the same meshes; the CLI; traverse
# ---------------------------------------------------------------------------

def _write_rectangle_obj(path):
    """``shapes.rectangle()`` as an OBJ with its normals and texture
    coordinates (v written flipped: the loader flips it back)."""
    from epsm_mitsuba3_torch.models import shapes
    r = shapes.rectangle()
    with open(path, "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in r["vertices"])
        f.writelines(f"vt {u} {1 - v}\n" for u, v in r["uvs"])
        f.writelines(f"vn {x} {y} {z}\n" for x, y, z in r["normals"])
        f.writelines(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n"
                     for a, b, c in r["faces"] + 1)


def _write_rectangle_serialized(path):
    """``shapes.rectangle()`` in Mitsuba's serialized format (version 4,
    float32 positions, normals and texture coordinates)."""
    import struct
    import zlib
    from epsm_mitsuba3_torch.models import shapes
    r = shapes.rectangle()
    body = (struct.pack("<I", 0x0001 | 0x0002) + b"back\x00"
            + struct.pack("<QQ", len(r["vertices"]), len(r["faces"]))
            + r["vertices"].astype("<f4").tobytes()
            + r["normals"].astype("<f4").tobytes()
            + r["uvs"].astype("<f4").tobytes()
            + r["faces"].astype("<u4").tobytes())
    with open(path, "wb") as f:
        f.write(struct.pack("<HH", 0x041C, 4) + zlib.compress(body)
                + struct.pack("<Q", 0) + struct.pack("<I", 1))


def _write_ply(path, V, F, N):
    """A binary little-endian PLY of float32 positions and normals and
    int triangles."""
    import numpy as np
    head = ["ply", "format binary_little_endian 1.0",
            f"element vertex {len(V)}"]
    head += [f"property float {c}" for c in ("x", "y", "z", "nx", "ny",
                                              "nz")]
    head += [f"element face {len(F)}",
             "property list uchar int vertex_indices", "end_header"]
    tris = np.zeros(len(F), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    tris["n"], tris["i"] = 3, F
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(np.concatenate([V, N], -1).astype("<f4").tobytes())
        f.write(tris.tobytes())


def write_scene_files(ref, tmp):
    """The scene dict ``ref`` (cornell_box_mesh with sphere normals) as
    files in ``tmp``: the sphere a PLY, the floor an OBJ, the back wall a
    .serialized file, every shape under its key as its id, and the XML,
    its sample count the parameter ``$spp``.  Returns the XML's path."""
    import os
    from epsm_mitsuba3_torch.utils.xmlwrite import dict_to_xml
    blob = ref["blob"]
    _write_ply(os.path.join(tmp, "blob.ply"), blob["vertices"],
               blob["faces"], blob["normals"])
    _write_rectangle_obj(os.path.join(tmp, "floor.obj"))
    _write_rectangle_serialized(os.path.join(tmp, "back.serialized"))
    files = {"blob": {"type": "ply", "filename": "blob.ply"},
             "floor": {"type": "obj", "filename": "floor.obj"},
             "back": {"type": "serialized", "filename": "back.serialized"}}
    d = {}
    for key, val in ref.items():
        if isinstance(val, dict) and key not in ("sensor", "integrator"):
            val = {**val, "id": key}
            if key in files:
                val = {**files[key], **{k: v for k, v in val.items()
                                        if k not in ("type", "vertices",
                                                     "faces", "normals")}}
        d[key] = val
    text = dict_to_xml(d)
    spp = ref["sensor"]["sampler"]["sample_count"]
    text = text.replace(
        f'<integer name="sample_count" value="{spp}"/>',
        '<integer name="sample_count" value="$spp"/>').replace(
        '<scene version="3.0.0">',
        f'<scene version="3.0.0">\n    <default name="spp" value="{spp}"/>')
    path = os.path.join(tmp, "scene.xml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _timed_calls(module, attr, secs):
    """Wrap ``module.attr`` to add each call's seconds to ``secs``;
    returns the restore function."""
    fn = getattr(module, attr)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        secs.append(time.perf_counter() - t0)
        return out

    setattr(module, attr, timed)
    return lambda: setattr(module, attr, fn)


def _assert_scenes_equal(label, a, b):
    """Every array of two scenes, their BVHs and K2/K3 records, equal."""
    import torch
    from epsm_mitsuba3_torch.models.scene import GEOMETRY_FIELDS
    from epsm_mitsuba3_torch.ops.bvh import ARRAY_FIELDS
    pairs = [(k, getattr(a, k), getattr(b, k))
             for k in GEOMETRY_FIELDS + ("vertex_colors", "bvh_nodes",
                                         "bvh_tris", "bvh_tris_k")]
    pairs += [(f"bsdfs.{k}", v, b.bsdfs[k]) for k, v in a.bsdfs.items()]
    pairs += [(f"emitters.{k}", v, b.emitters[k])
              for k, v in a.emitters.items()]
    pairs += [(f"bvh.{k}", getattr(a.bvh, k), getattr(b.bvh, k))
              for k in ARRAY_FIELDS]
    pairs += [(f"sensors.{i}.to_world", x.to_world, y.to_world)
              for i, (x, y) in enumerate(zip(a.sensors, b.sensors))]
    differ = [k for k, x, y in pairs if not torch.equal(x, y)]
    same_static = (a.static == b.static and a.bvh.n_levels == b.bvh.n_levels
                   and set(a.bsdfs) == set(b.bsdfs)
                   and len(a.sensors) == len(b.sensors))
    say(f"[scene files] {label}: {len(pairs)} arrays (geometry, tables, "
        f"sensors, BVH, K2/K3 records) compared, {len(differ)} differ"
        f"{': ' + ', '.join(differ) if differ else ''}; static fields "
        f"equal: {same_static}")
    check(not differ and same_static, f"{label}: the scenes differ")


def scene_files_phase(gen):
    """[scene files]: ``cornell_box_mesh(512, 16, 6)`` with its sphere's
    vertex normals (``mesh_io.compute_vertex_normals``) written to a
    temporary directory (``write_scene_files``) and loaded on the card
    with ``load_file``: its arrays, BVH and K2/K3 records equal
    ``load_dict``'s of the same meshes; both rendered at 512^2 x 16 spp
    in passes of 8 (the same seed): the images equal, K2/K3 launched 12
    times each and K1 never; the parse, mesh-load, BVH-build and render
    times; ``cli.main`` writes an EXR equal to ``render``'s image; and
    ``traverse``: the sphere moved through ``update()`` renders as the
    ``set_vertices`` path does (the sphere's smooth normals refreshed
    there by ``refresh_smooth_normals``, as ``update()`` does), and K2 on
    the re-packed tree equals K1's brute force over the moved vertices.
    Returns the times and the launch totals."""
    import os
    import tempfile
    import numpy as np
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch import cli
    from epsm_mitsuba3_torch.core import xmlparse
    from epsm_mitsuba3_torch.models import mesh_io
    from epsm_mitsuba3_torch.ops import bvh as bvh_mod
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    from epsm_mitsuba3_torch.ops import normals as NT
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    ref = cornell_box_mesh(res=RES, spp=SF_SPP, max_depth=DEPTH)
    blob = ref["blob"]
    blob["normals"] = mesh_io.compute_vertex_normals(blob["vertices"],
                                                     blob["faces"])
    n_pass = SF_SPP // SF_CHUNK
    expect = {"mt_closest_hit": 0, "mt_any_hit": 0,
              "bvh4_closest_hit": DEPTH * n_pass,
              "bvh4_any_hit": DEPTH * n_pass, "bvh4_closest_hit_mp": 0}
    out = {"total": {}}

    def count(label, counts, want):
        for k, n in counts.items():
            out["total"][k] = out["total"].get(k, 0) + n
        for k, n in want.items():
            check(counts[k] == n, f"{label}: {k} launched {counts[k]} "
                  f"times, expected {n}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_scene_files(ref, tmp)
        write_s = time.perf_counter() - t0
        sizes = {f: os.path.getsize(os.path.join(tmp, f))
                 for f in sorted(os.listdir(tmp))}
        t0 = time.perf_counter()
        xmlparse.parse_string(open(path).read(), base_dir=tmp)
        parse_s = time.perf_counter() - t0
        mesh_s, bvh_s = [], []
        restore = [_timed_calls(mesh_io, "load_mesh_file", mesh_s),
                   _timed_calls(bvh_mod, "build", bvh_s)]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc_file = mt.load_file(path)
            torch.cuda.synchronize()
            file_s = time.perf_counter() - t0
            n_bvh = len(bvh_s)
            t0 = time.perf_counter()
            sc_dict = mt.load_dict(ref)
            torch.cuda.synchronize()
            dict_s = time.perf_counter() - t0
        finally:
            for r in restore:
                r()
        say(f"[scene files] wrote {sizes} in {write_s:.2f} s; load_file "
            f"{file_s:.2f} s on {sc_file.device}: parse {parse_s * 1e3:.1f} "
            f"ms, mesh files {sum(mesh_s) * 1e3:.1f} ms ("
            + ", ".join(f"{x * 1e3:.1f}" for x in mesh_s)
            + f"), BVH build {sum(bvh_s[:n_bvh]):.2f} s; load_dict of the "
            f"same meshes {dict_s:.2f} s (its BVH build "
            f"{sum(bvh_s[n_bvh:]):.2f} s); {sc_file.faces.shape[0]} "
            f"triangles, {sc_file.bvh_nodes.shape[0]} BVH4 records; shapes "
            f"{sc_file.static.shape_names}")
        check(sc_file.static.spp == SF_SPP, "$spp not substituted")
        _assert_scenes_equal("load_file vs load_dict", sc_file, sc_dict)

        imgs, walls = {}, {}
        for label, sc in (("load_file", sc_file), ("load_dict", sc_dict)):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[label] = mt.render(sc, spp=SF_SPP, spp_chunk=SF_CHUNK,
                                    seed=0)
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            count(f"render {label}", counts, expect)
            image_checks(imgs[label], RES)
        CT.raise_on_overflow(sc_file.device)
        same = bool(torch.equal(imgs["load_file"], imgs["load_dict"]))
        say(f"[scene files] renders {RES}^2 x {SF_SPP} spp in passes of "
            f"{SF_CHUNK}, depth {DEPTH}: load_file scene "
            f"{walls['load_file']:.1f} ms, load_dict scene "
            f"{walls['load_dict']:.1f} ms (first renders of each); images "
            f"equal bit for bit: {same}; launches {counts}")
        check(same, "the load_file and load_dict renders differ")

        exr = os.path.join(tmp, "out.exr")
        zero_counts()
        t0 = time.perf_counter()
        rc = cli.main([path, "-o", exr, "--spp", str(SF_SPP)])
        cli_s = time.perf_counter() - t0
        count("cli", read_counts(), {k: n // n_pass
                                     for k, n in expect.items()})
        img_cli = mt.read_image(exr).data
        img_ref = mt.render(sc_file, spp=SF_SPP, seed=0).cpu().numpy()
        same = bool(np.array_equal(img_cli, img_ref))
        say(f"[scene files] cli.main -o out.exr --spp {SF_SPP}: rc {rc}, "
            f"{cli_s:.2f} s (load, one {SF_SPP}-spp pass, EXR of "
            f"{os.path.getsize(exr)} bytes); read back {img_cli.shape}, "
            f"equal to render's image bit for bit: {same}")
        check(rc == 0 and same, "the CLI's EXR is not render's image")

    # traverse: move the sphere through update() and through set_vertices
    names = sc_file.static.shape_names
    s, c = sc_file.static.vertex_ranges[names.index("blob")]
    offset = torch.tensor([0.05, -0.03, 0.04], device=sc_file.device)
    params = mt.traverse(sc_file)
    check("blob.vertex_positions" in params.keys(), "no blob key")
    params["blob.vertex_positions"] = params["blob.vertex_positions"] + offset
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc_t = params.update()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    v = sc_file.vertices.clone()
    v[s:s + c] += offset
    rows = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
    rows[s:s + c] = True
    sc_s = NT.refresh_smooth_normals(sc_file.set_vertices(v), rows)
    same_nodes = bool(torch.equal(sc_t.bvh_nodes, sc_s.bvh_nodes)) and \
        not bool(torch.equal(sc_t.bvh_nodes, sc_file.bvh_nodes))
    imgs = {}
    for label, sc in (("update", sc_t), ("set_vertices", sc_s)):
        zero_counts()
        imgs[label] = mt.render(sc, spp=SF_SPP, spp_chunk=SF_CHUNK, seed=0)
        count(f"render {label}", read_counts(), expect)
    same = bool(torch.equal(imgs["update"], imgs["set_vertices"]))
    say(f"[scene files] traverse: {len(params.keys())} keys; update() "
        f"(positions, the sphere's smooth normals, refit + re-pack) "
        f"{update_ms:.1f} ms; records re-packed as set_vertices' and moved: "
        f"{same_nodes}; images equal bit for bit: {same}")
    check(same_nodes and same, "traverse().update() differs from "
          "set_vertices")
    o, d, maxt = main_path_rays(sc_t, gen, SF_CHUNK)
    k = slice(0, 65536)
    t, slot, u, vv = CT.closest_hit(sc_t.bvh_nodes, sc_t.bvh_tris, o[k],
                                    d[k], maxt[k])
    prim = torch.where(slot >= 0, sc_t.bvh.order[slot.clamp(min=0).long()],
                       -1)
    ref_hit = I.ray_intersect_brute(CI.pack_tris(sc_t.vertices, sc_t.faces),
                                    o[k], d[k], maxt[k])
    hold("scene files: K2 on the re-packed tree vs K1 brute force, moved "
         "sphere", (t, prim, u, vv, slot >= 0),
         (ref_hit[0], ref_hit[1].long(), ref_hit[2], ref_hit[3],
          ref_hit[1] >= 0))
    out.update(parse_s=parse_s, mesh_s=sum(mesh_s), bvh_s=sum(bvh_s[:n_bvh]),
               file_s=file_s, render_ms=walls, cli_s=cli_s,
               update_ms=update_ms)
    return out


# ---------------------------------------------------------------------------
# [glassslab]: the paper's normal-field experiment at its published widths
# ---------------------------------------------------------------------------

def glassslab_phase():
    """[glassslab]: ``run("manifold_caustic", glassslab.make(...))`` at
    512^2, spp 64, depth 4, match_res 256, a 16 x 16 grid (the published
    widths), ground truth 64 spp, GS_ITERS iterations (cut from the
    published 1,000, for the time limit): ms an iteration and by phase,
    K1 launches an iteration (exact), normal_field and its gradient
    finite and non-zero, peak memory (no profiled iteration: cut for the
    time limit); then the normal_field gradient on the card against the
    CPU's at 64^2 x 4 spp."""
    run = experiment_run("glassslab", GS_SPP, GS_SPP, GS_ITERS,
                         do_profile=False, match_res=GS_MATCH)
    init = run.pop("exp")["init_theta"]["normal_field"].cpu().numpy()
    last = run["rows"][-1]["theta"]["normal_field"]
    say("[glassslab] dL/dnormal_field an iteration: "
        + "; ".join(f"max |g| {float(x['normal_field'].abs().max()):.6g}, "
                    f"|g| {float(x['normal_field'].norm()):.6g}"
                    for x in run["grads"])
        + f"; max |normal_field - init| after the last "
        f"{float(abs(last - init).max()):.6g}")
    run["cpu"] = exp_card_vs_cpu((("glassslab", 4),), "glassslab, card vs cpu")
    return run


# ---------------------------------------------------------------------------
# [camera]: reconstruction filters, sampler kinds and sensor kinds
# ---------------------------------------------------------------------------

#: launch counts summed over a phase: ``zero_counts`` adds the counts it
#: clears here while this is a dict
_TALLY = None


def camera_dict(make, rfilter=None, sampler="stratified", sensor=None,
                **kw):
    """``make(**kw)`` (a scene dict of ``epsm_mitsuba3_torch.scenes``) with
    the film's filter (None: no rfilter entry, so the hdrfilm's default
    gaussian), the sampler kind and the sensor's entries changed."""
    d = make(**kw)
    s = d["sensor"]
    if rfilter is None:
        s["film"].pop("rfilter", None)
    else:
        s["film"]["rfilter"] = {"type": rfilter}
    s["sampler"]["type"] = sampler
    s.update(sensor or {})
    return d


def batch_sensor(d):
    """``d`` with its sensor replaced by a batch sensor of two perspective
    views side by side, on a film as wide as the old one."""
    from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
    s = d["sensor"]
    views = {f"view{i}": {
        "type": "perspective", "fov": 35.0 + 10 * i,
        "to_world": T.look_at(origin=[0.4 * i - 0.2, 1, 3.9],
                              target=[0, 1, 0], up=[0, 1, 0]).matrix}
        for i in range(2)}
    d["sensor"] = {"type": "batch", **views, "film": s["film"],
                   "sampler": s["sampler"]}
    return d


def seeded_kinds(fn):
    """(fn's result, the sampler kinds ``samplers.seed`` was asked for
    while fn ran, in order)."""
    from epsm_mitsuba3_torch.models import samplers as smp
    kinds, seed = [], smp.seed

    def spy(*a, **kw):
        kinds.append(kw.get("kind", "independent"))
        return seed(*a, **kw)

    smp.seed = spy
    try:
        return fn(), kinds
    finally:
        smp.seed = seed


def film_costs(label, spp):
    """The gaussian film of one PRB pass at 512^2 x ``spp`` on its own:
    ``_film_fn`` (the roll-sum ``splat_coalesced`` and ``develop``) and
    its adjoint ``film_adjoint``, by CUDA events and torch.profiler (ms,
    launches, the memory they add at their peak); the general scatter
    ``splat`` (the EPSM primal's film) beside it; each run twice, the
    roll-sum's results bit for bit alike, the scatter's (float atomics)
    within 1e-5 of its largest entry, the two splats within 1e-4 of the
    largest entry of each other (the scatter weighs a sample by the
    filter at px + 0.5 - x, whose float32 rounding grows with the film
    coordinate x; the roll-sum at the jitter alone)."""
    import torch
    from epsm_mitsuba3_torch.ad import prb
    from epsm_mitsuba3_torch.models import films
    from epsm_mitsuba3_torch.models.sensors import Sensor
    dev = torch.device("cuda")
    n = RES * RES * spp
    gen = torch.Generator(device=dev).manual_seed(5)
    pix = torch.arange(n, device=dev) // spp
    corner = torch.stack([pix % RES, pix // RES], -1).float()
    pos = corner + torch.rand(n, 2, device=dev, generator=gen)
    # where pixel + jitter rounds up to the next integer, the roll-sum
    # (as the reference's) splats the sample from its own pixel with
    # jitter 0: the scatter is held at those positions
    rounded = int((torch.floor(pos) != corner).any(-1).sum())
    pos_lane = corner + (pos - torch.floor(pos))
    vals = torch.rand(n, 3, device=dev, generator=gen)
    weight = torch.ones(n, 3, device=dev)
    g_img = torch.randn(RES, RES, 3, device=dev, generator=gen)
    sensor = Sensor(to_world=torch.eye(4, device=dev), width=RES, height=RES,
                    rfilter="gaussian")
    calls = {
        "film": lambda: prb._film_fn(vals, pos, weight, sensor, spp),
        "adjoint": lambda: prb.film_adjoint(g_img, pos, weight, sensor, spp,
                                            n),
        "splat": lambda: films.develop(*films.splat(pos_lane, vals, RES,
                                                    RES, "gaussian"))}
    out = {}
    for name, fn in calls.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 5, warm=1)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        prof = profile_pass(f"{label}: {name}", fn, ("roll", "index_add"),
                            cpu=False, table=False)
        diff = float((a - b).abs().max())
        out[name] = dict(ms=ms, launches=prof["launches"] if prof else None,
                         extra_mib=extra, rerun_max_abs=diff, out=a)
    check(out["film"]["rerun_max_abs"] == 0.0
          and out["adjoint"]["rerun_max_abs"] == 0.0,
          "camera: splat_coalesced is not deterministic on the card")
    top = float(out["splat"]["out"].abs().max())
    check(out["splat"]["rerun_max_abs"] <= 1e-5 * top,
          "camera: two runs of the scatter differ beyond 1e-5")
    err = float((out["film"]["out"] - out["splat"]["out"]).abs().max()) / top
    check(err <= 1e-4, f"camera: splat_coalesced and splat differ by {err}")
    say(f"[camera] {label}, {RES}^2 x {spp} spp ({n} lanes): "
        + "; ".join(f"{k} {v['ms']:.2f} ms, {v['launches']} launches, "
                    f"+{v['extra_mib']:.1f} MiB at its peak, rerun max "
                    f"|diff| {v['rerun_max_abs']:.3g}"
                    for k, v in out.items())
        + f"; splat_coalesced vs splat {err:.3g} of the largest entry "
        f"({rounded} lanes' pixel + jitter rounded to the next integer) "
        "[limits: reruns of the roll-sum 0, of the scatter 1e-5; the two "
        "1e-4]")
    for v in out.values():
        v.pop("out")
    out["rounded_lanes"] = rounded
    return out


def camera_card_vs_cpu():
    """[camera card vs cpu] at 64^2 x 4 spp, depth 6 (the gates of
    ``card_vs_cpu`` and ``grad_card_vs_cpu``): every filter with the
    independent and the stratified sampler; each sampler kind at spp 16
    and 9; each sensor kind (a thin lens of aperture 0.08, a batch sensor
    of two views); PRB gradients through a gaussian film with the
    stratified sampler and through a thin lens with a Lanczos film and
    the multijitter sampler; the manifold backward on a gaussian,
    stratified box."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
    from epsm_mitsuba3_torch.integrators import epsm as ET
    from epsm_mitsuba3_torch.models import films, samplers, sensors
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.scenes import cornell_box
    box = dict(res=64, spp=4, max_depth=DEPTH)
    for rf in films.FILTERS:
        for smp in ("independent", "stratified"):
            card_vs_cpu(f"{rf} / {smp}", camera_dict(cornell_box, rf, smp,
                                                     **box), 4)
    for smp in samplers.KINDS:
        for spp in (16, 9):
            card_vs_cpu(f"gaussian / {smp} at spp {spp}", camera_dict(
                cornell_box, None, smp, res=64, spp=spp, max_depth=DEPTH),
                spp)
    probe = T.look_at(origin=[0.1, 1.2, 1.5], target=[0, 0.6, -1],
                      up=[0, 1, 0]).matrix
    sensor_cases = {
        "perspective": {},
        "thinlens": {"aperture_radius": 0.08, "focus_distance": 3.9},
        "orthographic": {"to_world": T.look_at(
            origin=[0, 1, 3.9], target=[0, 1, 0], up=[0, 1, 0]).scale(
                [0.9, 0.9, 1]).matrix},
        "distant": {}, "radiancemeter": {"to_world": probe},
        "irradiancemeter": {"to_world": probe}, "batch": None}
    check(set(sensor_cases) == set(sensors.KINDS), "camera: sensor kinds")
    for kind, extra in sensor_cases.items():
        d = camera_dict(cornell_box, None, "stratified", **box)
        if kind == "batch":
            d = batch_sensor(d)
        else:
            d["sensor"].update({"type": kind, **extra})
        card_vs_cpu(f"{kind} sensor, gaussian / stratified", d, 4)
    # PRB gradients through the film (face normals: vertex gradients)
    for label, rf, smp, sensor in (
            ("gaussian / stratified", None, "stratified", None),
            ("thinlens, lanczos / multijitter", "lanczos", "multijitter",
             sensor_cases["thinlens"])):
        d = camera_dict(cornell_box, rf, smp, sensor, **box)
        if sensor:
            d["sensor"]["type"] = "thinlens"
        for k in ("floor", "ceiling", "back", "left", "right"):
            d[k]["face_normals"] = True
        grad_card_vs_cpu(f"cornell_box {label}", d, 4)
    # the manifold backward on a stratified scene (independent samples)
    d = camera_dict(cornell_box, None, "stratified", **box)
    g = torch.randn(64, 64, 5, generator=torch.Generator().manual_seed(3))
    names = ("vertices", "bsdfs.reflectance")
    got = {}
    for dev in ("cuda", "cpu"):
        sc = mt.load_dict(d, device=dev)
        got[dev] = ET.render_backward(sc, names, g.to(sc.device) * 0.05, 3,
                                      DEPTH, 5, False, -1, 4)
        if dev == "cuda":
            CT.raise_on_overflow(sc.device)
    errs = {k: rel_l2(got["cuda"][k].cpu(), got["cpu"][k]) for k in names}
    say("[camera card vs cpu] manifold backward, gaussian / stratified box "
        "64^2 x 4 spp: |g_gpu - g_cpu| / |g_cpu| "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + "  [limit 1e-3 each]")
    for k, e in errs.items():
        check(e <= 1e-3 and float(got["cpu"][k].abs().max()) > 0,
              f"camera: manifold backward {k} card vs cpu {e}")


def camera_phase():
    """[camera]: the box (K1) and cornell_box_mesh (K2/K3) at 512^2 with no
    rfilter (the hdrfilm's default gaussian) and the stratified sampler,
    at the render cells' spp (64 in passes of 4, 16 in passes of 8): a
    warm-up and TIMED_RENDERS timed renders each, launches exact, one
    profiled pass each, peak memory; the mesh's fwd+bwd cell (2 passes of
    8 spp) with the same film and sampler, and one profiled pass; the
    gaussian film of a pass on its own (``film_costs``); one warm-up and
    two timed ``manifold`` iterations of the epsm-mesh cell with a
    gaussian sensor on a stratified scene, whose forward and backward
    must seed the independent sampler; then ``camera_card_vs_cpu``.
    Returns the numbers and the K1-K4 launches of the phase."""
    global _TALLY
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh
    zero_counts()
    _TALLY = {}
    out = {}
    try:
        # -- full width renders: K1 and K2/K3 through the gaussian film --
        for label, make, spp, chunk, expect, names in (
                ("camera box", cornell_box, SPP, SPP_CHUNK,
                 {"mt_closest_hit": DEPTH * (SPP // SPP_CHUNK),
                  "mt_any_hit": DEPTH * (SPP // SPP_CHUNK),
                  "bvh4_closest_hit": 0, "bvh4_any_hit": 0},
                 ("mt_closest", "mt_any")),
                ("camera mesh", cornell_box_mesh, MESH_SPP, MESH_CHUNK,
                 {"mt_closest_hit": 0, "mt_any_hit": 0,
                  "bvh4_closest_hit": DEPTH * (MESH_SPP // MESH_CHUNK),
                  "bvh4_any_hit": DEPTH * (MESH_SPP // MESH_CHUNK)},
                 ("bvh4_closest", "bvh4_any"))):
            scene = mt.load_dict(camera_dict(make, res=RES, spp=chunk,
                                             max_depth=DEPTH))
            check(scene.sensors[0].rfilter == "gaussian"
                  and scene.static.sampler_kind == "stratified",
                  f"{label}: not a gaussian / stratified scene")
            torch.cuda.reset_peak_memory_stats()
            median, counts = render_phase(label, scene, spp, chunk, expect)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = profile_pass(f"{label}, one {chunk}-spp pass",
                                lambda: mt.render(scene, spp=chunk, seed=7),
                                names + ("roll",))
            say(f"[{label}] peak device memory {peak:.2f} GiB")
            out[label] = dict(median_ms=median, counts=counts, peak_gib=peak,
                              profile=prof)
            del scene
        # -- PRB fwd+bwd: the mesh cell with the gaussian film --
        mesh = mt.load_dict(camera_dict(cornell_box_mesh, res=RES,
                                         spp=MESH_CHUNK, max_depth=DEPTH))
        median, mrays, counts, (sc, lv) = train_phase(
            "camera train mesh", mesh, MESH_CHUNK, MESH_PASSES,
            {"bvh4_closest_hit": DEPTH, "bvh4_closest_hit_mp": 0,
             "bvh4_any_hit": DEPTH, "mt_closest_hit": 0, "mt_any_hit": 0})
        prof = profile_pass(f"camera train mesh, one {MESH_CHUNK}-spp "
                            "fwd+bwd pass",
                            lambda: fwd_bwd(sc, lv, MESH_CHUNK, 99),
                            ("bvh4_closest", "bvh4_any", "roll"))
        out["camera train mesh"] = dict(median_ms=median, mrays=mrays,
                                        counts=counts, profile=prof)
        del mesh, sc, lv
        out["film"] = film_costs("gaussian film of a mesh pass", MESH_CHUNK)
        # -- EPSM: a manifold iteration, gaussian sensor, stratified scene --
        scene = mt.load_dict(camera_dict(cornell_box_mesh, res=EPSM_RES,
                                         spp=EPSM_SPP, max_depth=DEPTH))
        dev = scene.device
        with torch.no_grad():
            gt = mt.render(scene, spp=EPSM_SPP, seed=123,
                           integrator={"type": "path", "max_depth": DEPTH})
        gt_low = gt.reshape(-1, 3)
        matcher = Matcher(EPSM_RES)
        v0 = scene.vertices
        ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
        integ = {"type": "manifold", "max_depth": DEPTH}

        def iteration(seed):
            theta = torch.tensor(0.01, device=dev, requires_grad=True)
            sc = scene.set_vertices(v0 + theta * ex)
            img = mt.render(sc, spp=EPSM_SPP, seed=seed, integrator=integ)
            with torch.no_grad():
                g5 = matcher.match_Sinkhorn(img[..., :3].reshape(-1, 3),
                                            gt_low).reshape(EPSM_RES,
                                                            EPSM_RES, 5)
            (g,) = torch.autograd.grad(torch.sum(img * g5), theta)
            return float(g)

        walls = []
        torch.cuda.reset_peak_memory_stats()
        for i, run in enumerate(("warm-up", "timed 1", "timed 2")):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, kinds = seeded_kinds(lambda: iteration(i))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
            say(f"[camera epsm] {run}: {walls[-1]:.1f} ms, dL/dtheta "
                f"{g:.6g}, sampler kinds seeded {kinds}, launches {counts}")
            check(math.isfinite(g) and g != 0.0,
                  f"camera epsm: gradient {g}")
            check(kinds == ["independent", "independent"],
                  f"camera epsm: the manifold pass seeded {kinds}, expected "
                  "the independent sampler in the forward and the backward")
            for k, n in {"bvh4_closest_hit": 4 * DEPTH + 1,
                         "bvh4_any_hit": 3 * DEPTH}.items():
                check(counts[k] == n, f"camera epsm: {k} launched "
                      f"{counts[k]} times, expected {n}")
        _, kinds = seeded_kinds(lambda: mt.render(scene, spp=1, seed=1))
        check(kinds == ["stratified"], f"camera: PRB seeded {kinds}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f"[camera epsm] cornell_box_mesh {EPSM_RES}^2 x {EPSM_SPP} spp, "
            "gaussian sensor, stratified scene sampler (the manifold passes "
            f"seed independent, PRB stratified): iterations "
            f"{walls[1]:.1f} / {walls[2]:.1f} ms; peak device memory "
            f"{peak:.2f} GiB")
        out["camera epsm"] = dict(walls=walls[1:], counts=counts,
                                  peak_gib=peak)
        del scene
        camera_card_vs_cpu()
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    return out


# ---------------------------------------------------------------------------
# [emitters]: every emitter kind on every render path
# ---------------------------------------------------------------------------

#: [emitters]: the box's cases, in order: each new kind beside the box's
#: area light, then the constant light alone and no emitter at all
EM_CASES = ("point", "spot", "directional", "constant", "envmap",
            "projector", "directionalarea", "constant only", "no emitter")
#: timed renders a case (after a warm-up); the envmap's lat-long size;
#: lanes of the envmap sampler timed alone
EM_RENDERS, EM_ENV_HW, EM_SAMPLER_LANES = 1, (512, 1024), 2 ** 20


def emitter_lights(tmp, env_hw=EM_ENV_HW):
    """The lights of [emitters] by case, each a dict of scene entries: a
    point light and a spot aimed down below the ceiling light, a
    directional light through the box's open front, a constant
    environment, an envmap (a lat-long map made from the script's seed,
    written as EXR with the port's ``core/bitmap.py`` into ``tmp`` and
    loaded through ``filename``) and a projector with a checkerboard."""
    import os
    import numpy as np
    from epsm_mitsuba3_torch.core.bitmap import write_image
    from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
    r = np.random.default_rng(12)
    path = os.path.join(tmp, "sky.exr")
    write_image(path, (r.random((*env_hw, 3)) ** 4 * 4).astype(np.float32))
    return {
        "point": {"bulb": {"type": "point", "position": [0.0, 1.6, 0.2],
                           "intensity": [2.0, 1.8, 1.5]}},
        "spot": {"spot": {"type": "spot", "to_world": T.look_at(
            origin=[0, 1.8, 0], target=[0, 0, 0], up=[0, 0, 1]).matrix,
            "intensity": 6.0, "cutoff_angle": 35.0}},
        "directional": {"sun": {"type": "directional",
                                "direction": [0.2, -0.5, -1.0],
                                "irradiance": [2.0, 1.9, 1.6]}},
        "constant": {"sky": {"type": "constant", "radiance": 0.5}},
        "envmap": {"env": {"type": "envmap", "filename": path,
                           "scale": 0.5}},
        "projector": {"slide": {"type": "projector", "to_world": T.look_at(
            origin=[0, 1, 2.5], target=[0, 1, -1], up=[0, 1, 0]).matrix,
            "fov": 40.0, "scale": 10.0, "irradiance": {
                "type": "checkerboard", "color0": [1.0, 0.1, 0.1],
                "color1": [0.1, 0.1, 1.0], "uv_scale": 4.0}}},
    }


def emitter_box(case, lights, res, spp, face_normals=False):
    """``cornell_box(res, spp, DEPTH)`` lit for ``case`` (``EM_CASES``):
    directionalarea on the ceiling light's own shape."""
    from epsm_mitsuba3_torch.scenes import cornell_box
    d = cornell_box(res=res, spp=spp, max_depth=DEPTH)
    if face_normals:
        for k in ("floor", "ceiling", "back", "left", "right"):
            d[k]["face_normals"] = True
    if case == "directionalarea":
        d["light"]["emitter"]["type"] = "directionalarea"
    elif case == "no emitter":
        del d["light"]
    elif case == "constant only":
        del d["light"]
        d.update(lights["constant"])
    else:
        d.update(lights[case])
    return d


def emitter_leaves(scene, names=None):
    """The scene's emitter leaves that a gradient can reach, with copies
    that require grad: the lights' radiance, intensity and irradiance and
    each texture's texels (or just ``names``)."""
    keep = names or ("bsdfs.reflectance", "emitters.radiance",
                     "emitters.intensity", "emitters.irradiance")
    return {k: v.clone().requires_grad_(True)
            for k, v in scene.leaves().items()
            if k in keep or (names is None and k.startswith("textures.")
                             and k.endswith(".data"))}


def emitters_box_cell(lights, res=RES, spp=SPP, chunk=SPP_CHUNK):
    """emitters-box-512-64spp: each case of ``EM_CASES`` at the box render
    cell's size (K1): a warm-up and EM_RENDERS timed renders, the K1
    launches of each (exact), the image finite, non-zero (exactly 0 with
    no emitter), one profiled pass, the peak memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    out = {}
    n_passes = spp // chunk
    expect = {"mt_closest_hit": DEPTH * n_passes,
              "mt_any_hit": DEPTH * n_passes, "bvh4_closest_hit": 0,
              "bvh4_any_hit": 0}
    for case in EM_CASES:
        scene = mt.load_dict(emitter_box(case, lights, res, chunk))
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for run in ["warm-up"] + [f"timed {i + 1}"
                                  for i in range(EM_RENDERS)]:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = mt.render(scene, spp=spp, spp_chunk=chunk, seed=0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
            for k, n in expect.items():
                check(counts[k] == n, f"emitters box {case}: {k} launched "
                      f"{counts[k]} times, expected {n}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(tuple(img.shape) == (res, res, 3)
              and bool(torch.isfinite(img).all()),
              f"emitters box {case}: image {tuple(img.shape)} not finite")
        mean = float(img.mean())
        if case == "no emitter":
            check(bool((img == 0).all()), "emitters box: a scene without "
                  "an emitter gave a non-zero pixel")
        else:
            check(mean > 0, f"emitters box {case}: black image")
        prof = profile_pass(f"emitters box {case}, one {chunk}-spp pass",
                            lambda: mt.render(scene, spp=chunk, seed=7),
                            ("mt_closest", "mt_any"), cpu=False,
                            table=False)
        ws = sorted(walls[1:])
        say(f"[emitters box] {case}: {res}^2 x {spp} spp in passes of "
            f"{chunk}, kinds {scene.static.emitter_kinds}: wall median "
            f"{ws[len(ws) // 2]:.1f} ms (range {ws[0]:.1f}-{ws[-1]:.1f}); "
            f"launches {counts}; image mean {mean:.5f}; peak device memory "
            f"{peak:.2f} GiB; busy of a pass "
            + (f"{prof['busy']:.1f} of {prof['wall']:.1f} ms "
               f"({100 * prof['busy'] / prof['wall']:.1f} %), "
               f"{prof['launches']} launches" if prof else "not measured"))
        out[case] = dict(median_ms=ws[len(ws) // 2],
                         range_ms=(ws[0], ws[-1]), counts=counts, mean=mean,
                         peak_gib=peak, profile=prof)
        del scene, img
    return out


def emitters_mesh_cell(lights, res=RES, spp=MESH_CHUNK, passes=MESH_PASSES):
    """emitters-mesh-512-8spp-fwdbwd: cornell_box_mesh (outward normals on
    its sphere, ``blob_normals``) with the envmap and a point light added,
    ``passes`` fwd+bwd passes (the loss
    ``mean(img^2)``) a run, a warm-up and 3 timed runs: K2/K3 launches
    exact in each forward, none in the backward; the gradients of the
    vertices (through ``set_vertices``), the lights' radiance and
    intensity and the envmap's texels finite and non-zero."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    d = blob_normals(cornell_box_mesh(res=res, spp=spp, max_depth=DEPTH))
    d.update(lights["envmap"])
    d.update(lights["point"])
    scene = mt.load_dict(d)
    env = scene.static.env_texture
    names = ("emitters.radiance", "emitters.intensity",
             f"textures.{env}.data")
    expect = {"bvh4_closest_hit": DEPTH, "bvh4_any_hit": DEPTH,
              "bvh4_closest_hit_mp": 0, "mt_closest_hit": 0,
              "mt_any_hit": 0}
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for run in ["warm-up", "timed 1", "timed 2", "timed 3"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(passes):
            v = scene.vertices.clone().requires_grad_(True)
            lv = emitter_leaves(scene, names)
            sc = scene.set_vertices(v).with_leaves(lv)
            zero_counts()
            img = mt.render(sc, spp=spp, seed=p + 1)
            loss = torch.mean(img ** 2)
            fwd = read_counts()
            zero_counts()
            grads = torch.autograd.grad(loss, [v, *lv.values()])
            bwd = read_counts()
            for k, n in expect.items():
                check(fwd[k] == n, f"emitters mesh: {k} launched {fwd[k]} "
                      f"times in a forward, expected {n}")
            check(sum(bwd.values()) == 0,
                  f"emitters mesh: the replay launched kernels: {bwd}")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        norms = {k: float(g.norm()) for k, g in
                 zip(("vertices",) + names, grads)}
        say(f"[emitters mesh] {run}: {walls[-1]:.1f} ms for {passes} "
            f"passes, loss {float(loss):.6g}; |grad| "
            + ", ".join(f"{k} {n:.4g}" for k, n in norms.items()))
        for k, g in zip(("vertices",) + names, grads):
            check(bool(torch.isfinite(g).all()) and norms[k] > 0,
                  f"emitters mesh: the gradient of {k} is not finite and "
                  "non-zero")
    CT.raise_on_overflow(scene.device)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ws = sorted(walls[1:])
    rays = res * res * spp * DEPTH * 2 * passes
    mrays = rays / (ws[1] / 1e3) / 1e6
    say(f"[emitters mesh] cornell_box_mesh + envmap {EM_ENV_HW} + point, "
        f"{res}^2 x {spp} spp, {passes} fwd+bwd passes: wall median "
        f"{ws[1]:.1f} ms (range {ws[0]:.1f}-{ws[-1]:.1f}); {mrays:.2f} "
        f"physical Mrays/s fwd+bwd; forward launches {fwd}; peak device "
        f"memory {peak:.2f} GiB")
    return dict(median_ms=ws[1], range_ms=(ws[0], ws[-1]), mrays=mrays,
                counts=fwd, peak_gib=peak)


def emitters_epsm_cell(lights, res=EPSM_RES, spp=EPSM_SPP):
    """emitters-epsm-mesh-128-8spp: the epsm-mesh cell with a constant
    environment added after the area light (so that emitter row 0 stays
    the area light): a warm-up and one timed ``manifold`` iteration, ms
    by phase (CUDA events), K2/K3 launches exact, the gradient finite and
    non-zero, the peak memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    d = cornell_box_mesh(res=res, spp=spp, max_depth=DEPTH)
    d.update(lights["constant"])
    scene = mt.load_dict(d)
    check(int(scene.emitters["kind"][0]) == 0,
          "emitters epsm: row 0 is not the area light")
    dev = scene.device
    with torch.no_grad():
        gt = mt.render(scene, spp=spp, seed=123,
                       integrator={"type": "path", "max_depth": DEPTH})
    gt_low = gt.reshape(-1, 3)
    matcher = Matcher(res)
    v0 = scene.vertices
    ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
    integ = {"type": "manifold", "max_depth": DEPTH}
    timer = epsm_backward_timer()

    def iteration(seed):
        theta = torch.tensor(0.01, device=dev, requires_grad=True)
        sc = scene.set_vertices(v0 + theta * ex)
        img = timer.wrap_call("forward render", lambda: mt.render(
            sc, spp=spp, seed=seed, integrator=integ))
        with torch.no_grad():
            g5 = timer.wrap_call("Sinkhorn match", lambda: (
                matcher.match_Sinkhorn(img[..., :3].reshape(-1, 3),
                                       gt_low))).reshape(res, res, 5)
        (g,) = timer.wrap_call("backward", lambda: torch.autograd.grad(
            torch.sum(img * g5), theta))
        return float(g)

    try:
        torch.cuda.reset_peak_memory_stats()
        for i, run in enumerate(("warm-up", "timed")):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = iteration(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            ms = split_phases(timer.read())
            say(f"[emitters epsm] {run}: {wall:.1f} ms, dL/dtheta {g:.6g}; "
                + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                + f" ms; launches {counts}")
            check(math.isfinite(g) and g != 0.0,
                  f"emitters epsm: gradient {g}")
            for k, n in {"bvh4_closest_hit": 4 * DEPTH + 1,
                         "bvh4_any_hit": 3 * DEPTH, "mt_closest_hit": 0,
                         "mt_any_hit": 0}.items():
                check(counts[k] == n, f"emitters epsm: {k} launched "
                      f"{counts[k]} times, expected {n}")
            CT.raise_on_overflow(dev)
    finally:
        timer.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"[emitters epsm] cornell_box_mesh + constant, {res}^2 x {spp} "
        f"spp, one manifold iteration: {wall:.1f} ms; peak device memory "
        f"{peak:.2f} GiB")
    return dict(wall_ms=wall, phases=ms, counts=counts, peak_gib=peak)


def envmap_sampler_alone(lights, lanes=EM_SAMPLER_LANES):
    """The envmap's sampler alone at ``lanes`` lanes of the 512 x 1024
    map: ``_envmap_sample`` (the column found by bisecting the lane's row,
    ``core/distr2d.py`` ``bisect_rows``) against the reference's
    compare-sum over each lane's gathered row CDF (here on the port's
    float64 CDFs, twice the reference's float32 bytes), both timed by
    CUDA events, with the peak memory each adds; the texels equal."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.models import emitters as E
    scene = mt.load_dict(emitter_box("envmap", lights, 64, 1))
    dev = scene.device
    tex = scene.textures[scene.static.env_texture]
    gen = torch.Generator(device=dev).manual_seed(5)
    s2 = torch.rand(lanes, 2, device=dev, generator=gen)
    ref_p = torch.rand(lanes, 3, device=dev, generator=gen)
    row = int((scene.emitters["kind"] == E.KIND_ENVMAP).nonzero()[0, 0])
    em_idx = torch.full((lanes,), row, dtype=torch.int32, device=dev)
    p_em = {k: v[em_idx.long()] for k, v in scene.emitters.items()}

    def bisect():
        return E._envmap_sample(p_em, ref_p, s2, em_idx, tex)[0].uv

    def compare_sum():
        wgt = E.envmap_weights(tex)
        h, w = wgt.shape
        row_cdf = torch.cumsum(wgt.sum(1), 0)
        row_cdf = row_cdf / row_cdf[-1]
        col = torch.cumsum(wgt, 1)
        col = col / col[:, -1:]
        y = torch.clamp(torch.searchsorted(row_cdf, s2[:, 1].contiguous(),
                                           right=True), 0, h - 1)
        x = torch.clamp((col[y] <= s2[:, :1]).sum(-1), 0, w - 1)
        return torch.stack([(x + 0.5) / w, (y + 0.5) / h], -1)

    out = {}
    for label, fn in (("bisection", bisect), ("compare-sum", compare_sum)):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        uv = fn()
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        ms = cuda_ms(fn, 10)
        out[label] = dict(ms=ms, peak_mib=extra, uv=uv)
    same = bool(torch.equal(out["bisection"]["uv"],
                            out["compare-sum"]["uv"]))
    say(f"[emitters envmap sampler] {lanes} lanes, map "
        f"{tuple(tex.data.shape)}: "
        + "; ".join(f"{k} {v['ms']:.3f} ms, + {v['peak_mib']:.1f} MiB at "
                    "its peak" for k, v in out.items())
        + f"; the same texel on every lane: {same}")
    check(same, "emitters: the bisection and the compare-sum picked other "
          "texels")
    return {k: dict(ms=v["ms"], peak_mib=v["peak_mib"])
            for k, v in out.items()}


def emitters_card_vs_cpu(lights, res=64, spp=4):
    """[emitters card vs cpu] at 64^2 x 4 spp, depth 6, with the camera
    phase's gates: every case's image; each new kind's PRB gradients (the
    vertices, with face normals on the walls; the reflectances; the
    lights' radiance, intensity, irradiance; the texels); the manifold
    backward of the box with the constant light after the area light.
    The far lights' shadow rays reach ~1e5 (K1 on the card, its plain
    version on the CPU)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.integrators import epsm as ET
    for case in EM_CASES:
        card_vs_cpu(f"emitters {case}",
                    emitter_box(case, lights, res, spp), spp)
    for case in EM_CASES[:-2]:
        d = emitter_box(case, lights, res, spp, face_normals=True)
        got = {}
        for dev in ("cuda", "cpu"):
            sc = mt.load_dict(d, device=dev)
            v = sc.vertices.clone().requires_grad_(True)
            lv = emitter_leaves(sc)
            img = mt.render(sc.with_leaves({"vertices": v, **lv}), spp=spp,
                            seed=0, device=dev)
            gs = torch.autograd.grad((img ** 2).mean(), [v, *lv.values()])
            got[dev] = dict(zip(("vertices", *lv), gs))
        errs = {k: rel_l2(got["cuda"][k].cpu(), g)
                for k, g in got["cpu"].items()}
        say(f"[emitters card vs cpu] {case}: PRB gradients |g_gpu - g_cpu| "
            "/ |g_cpu| "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + "  [limit 1e-3 each]")
        for k, e in errs.items():
            check(e <= 1e-3, f"emitters {case}: card and CPU gradients of "
                  f"{k} differ by {e} relative")
    d = emitter_box("constant", lights, res, spp)
    g = torch.randn(res, res, 5, generator=torch.Generator().manual_seed(3))
    names = ("vertices", "bsdfs.reflectance", "emitters.radiance")
    got = {}
    for dev in ("cuda", "cpu"):
        sc = mt.load_dict(d, device=dev)
        got[dev] = ET.render_backward(sc, names, g.to(sc.device) * 0.05, 3,
                                      DEPTH, 5, False, -1, spp)
    errs = {k: rel_l2(got["cuda"][k].cpu(), got["cpu"][k]) for k in names}
    say("[emitters card vs cpu] manifold backward, box + constant "
        f"{res}^2 x {spp} spp: |g_gpu - g_cpu| / |g_cpu| "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + "  [limit 1e-3 each]")
    for k, e in errs.items():
        check(e <= 1e-3 and float(got["cpu"][k].abs().max()) > 0,
              f"emitters: manifold backward {k} card vs cpu {e}")


def emitters_phase():
    """[emitters]: every emitter kind on every render path (K1 on the box,
    K2/K3 on the mesh and in the EPSM iteration), then the envmap sampler
    alone and the card against the CPU.  Returns the numbers and the K1-K4
    launches of the phase."""
    global _TALLY
    import tempfile
    zero_counts()
    _TALLY = {}
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            lights = emitter_lights(tmp)
            for label, fn in (("box", emitters_box_cell),
                              ("mesh", emitters_mesh_cell),
                              ("epsm", emitters_epsm_cell),
                              ("sampler", envmap_sampler_alone),
                              ("card vs cpu", emitters_card_vs_cpu)):
                t0 = time.perf_counter()
                out[label] = fn(lights)
                say(f"[emitters] {label}: {time.perf_counter() - t0:.1f} s")
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    return out


# ---------------------------------------------------------------------------
# [textures]: textured BSDFs, vertex colours, normal maps, spectra
# ---------------------------------------------------------------------------

#: [textures]: texels a side of the reflectance bitmap and of the normal
#: map; timed renders of the box (after a warm-up)
TX_ALBEDO, TX_NORMAL, TX_RENDERS = 1024, 512, 1


def smooth_field(rng, n, channels, cells=8):
    """An n x n image of ``channels`` values in [0, 1): a (cells + 1)^2
    grid of uniform draws from ``rng``, bilinearly interpolated."""
    import numpy as np
    grid = rng.random((cells + 1, cells + 1, channels))
    x = np.linspace(0.0, cells, n)
    i = np.minimum(x.astype(int), cells - 1)
    f = (x - i)[:, None, None]
    rows = grid[i] * (1 - f) + grid[i + 1] * f              # (n, cells+1, c)
    f = f.reshape(1, n, 1)
    return (rows[:, i] * (1 - f) + rows[:, i + 1] * f).astype(np.float32)


def texture_files(tmp):
    """The textures of [textures], made with numpy from the script's seed
    and written as EXR with the port's ``core/bitmap.py``: a reflectance
    bitmap in [0.1, 0.9] and a tangent-space normal map (z >= 0.8, so
    each perturbed normal stays within ~37 degrees of the surface's).
    Both are smooth (``smooth_field``): a white-noise texture's
    derivative jumps at every texel edge, and the card's and the CPU's
    last-bit differences in a sampled direction then move the vertices'
    PRB gradient by 2.8e-2 relative (``PERF.md``, PR 13)."""
    import os
    import numpy as np
    from epsm_mitsuba3_torch.core.bitmap import write_image
    r = np.random.default_rng(13)
    out = {"albedo": os.path.join(tmp, "albedo.exr"),
           "normal": os.path.join(tmp, "normal.exr")}
    write_image(out["albedo"], 0.1 + 0.8 * smooth_field(r, TX_ALBEDO, 3))
    xy = 0.5 + 0.3 * (smooth_field(r, TX_NORMAL, 2) - 0.5)
    z = 0.8 + 0.2 * smooth_field(r, TX_NORMAL, 1)
    write_image(out["normal"], np.concatenate([xy, z], -1))
    return out


def textured_box(files, res, spp):
    """textures-box: ``cornell_box(res, spp, DEPTH)`` with the bitmap as
    the back wall's reflectance, a checkerboard on the floor at uv_scale
    8, the normal map on the left wall, a ``regular`` spectrum as the
    right wall's reflectance and an ``irregular`` one as the light's
    radiance."""
    from epsm_mitsuba3_torch.scenes import cornell_box
    d = cornell_box(res=res, spp=spp, max_depth=DEPTH)
    d["back"]["bsdf"]["reflectance"] = {"type": "bitmap",
                                        "filename": files["albedo"]}
    d["floor"]["bsdf"]["reflectance"] = {
        "type": "checkerboard", "uv_scale": 8.0,
        "color0": [0.8, 0.75, 0.7], "color1": [0.25, 0.3, 0.35]}
    d["left"]["bsdf"] = {"type": "normalmap", "bsdf": d["left"]["bsdf"],
                         "normalmap": {"type": "bitmap",
                                       "filename": files["normal"]}}
    d["right"]["bsdf"]["reflectance"] = {
        "type": "regular", "wavelength_min": 400, "wavelength_max": 700,
        "values": [0.1, 0.15, 0.6, 0.8, 0.7, 0.3]}
    d["light"]["emitter"]["radiance"] = {
        "type": "irregular", "value": "400:14, 480:18, 560:17, 640:16, "
                                      "700:15"}
    return d


def textured_mesh(files, res, spp, sphere_colors=True):
    """textures-mesh: ``cornell_box_mesh(res, spp, DEPTH)`` with the bitmap
    as the back wall's reflectance and the normal map on the floor; with
    ``sphere_colors`` the sphere takes outward normals (``blob_normals``)
    and a ``mesh_attribute`` reflectance (``vertex_colored`` gives the
    colours)."""
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    d = cornell_box_mesh(res=res, spp=spp, max_depth=DEPTH)
    d["back"]["bsdf"]["reflectance"] = {"type": "bitmap",
                                        "filename": files["albedo"]}
    d["floor"]["bsdf"] = {"type": "normalmap", "bsdf": d["floor"]["bsdf"],
                          "normalmap": {"type": "bitmap",
                                        "filename": files["normal"]}}
    if sphere_colors:
        d = blob_normals(d)
        d["blob"]["bsdf"]["reflectance"] = {"type": "mesh_attribute",
                                            "name": "vertex_color"}
    return d


def vertex_colored(scene):
    """The scene with vertex colours made from the positions: each
    vertex's position mapped into [0.1, 0.9] over the scene's bounds."""
    v = scene.vertices
    lo, hi = v.amin(0), v.amax(0)
    return scene.with_leaves({"vertex_colors": 0.1 + 0.8 * (v - lo)
                              / (hi - lo).clamp(min=1e-6)})


def texture_leaves(scene):
    """Copies that require grad of the textured scene's leaves: the BSDF
    bitmap's texels (not the normal map's), the reflectances and, where a
    texture is a ``mesh_attribute``, the vertex colours."""
    refl = [i for i in scene.static.bsdf_textures
            if scene.textures[i].kind == "bitmap"]
    keep = {"bsdfs.reflectance", *(f"textures.{i}.data" for i in refl)}
    if scene.static.has_vertex_colors:
        keep.add("vertex_colors")
    return {k: v.clone().requires_grad_(True)
            for k, v in scene.leaves().items() if k in keep}


def textures_box_cell(files, res=RES, spp=SPP, chunk=SPP_CHUNK):
    """textures-box-512-64spp: the textured box at the box render cell's
    size (K1): a warm-up and TX_RENDERS timed renders, the K1 launches of
    each (exact), the image finite and not flat, one profiled pass, the
    peak memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    n_passes = spp // chunk
    expect = {"mt_closest_hit": DEPTH * n_passes,
              "mt_any_hit": DEPTH * n_passes, "bvh4_closest_hit": 0,
              "bvh4_any_hit": 0}
    scene = mt.load_dict(textured_box(files, res, chunk))
    st = scene.static
    check(st.has_normal_maps and len(st.bsdf_textures) == 2,
          f"textures box: loaded {st}")
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for run in ["warm-up"] + [f"timed {i + 1}" for i in range(TX_RENDERS)]:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = mt.render(scene, spp=spp, spp_chunk=chunk, seed=0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        for k, n in expect.items():
            check(counts[k] == n, f"textures box: {k} launched {counts[k]} "
                  f"times, expected {n}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean, std = float(img.mean()), float(img.std())
    check(tuple(img.shape) == (res, res, 3)
          and bool(torch.isfinite(img).all()) and mean > 0
          and std > 0.05 * mean, f"textures box: image shape "
          f"{tuple(img.shape)}, mean {mean}, std {std}")
    prof = profile_pass(f"textures box, one {chunk}-spp pass",
                        lambda: mt.render(scene, spp=chunk, seed=7),
                        ("mt_closest", "mt_any"), cpu=False, table=False)
    ws = sorted(walls[1:])
    say(f"[textures box] {res}^2 x {spp} spp in passes of {chunk}: wall "
        f"median {ws[len(ws) // 2]:.1f} ms (range {ws[0]:.1f}-{ws[-1]:.1f})"
        f"; launches {counts}; image mean {mean:.5f}, std {std:.5f}; peak "
        f"device memory {peak:.2f} GiB; busy of a pass "
        + (f"{prof['busy']:.1f} of {prof['wall']:.1f} ms "
           f"({100 * prof['busy'] / prof['wall']:.1f} %), "
           f"{prof['launches']} launches" if prof else "not measured"))
    return dict(median_ms=ws[len(ws) // 2], range_ms=(ws[0], ws[-1]),
                counts=counts, mean=mean, peak_gib=peak, profile=prof)


def textures_mesh_cell(files, res=RES, spp=MESH_CHUNK, passes=MESH_PASSES):
    """textures-mesh-512-8spp-fwdbwd: the textured mesh, ``passes``
    fwd+bwd passes (the loss ``mean(img^2)``) a run, a warm-up and 3
    timed runs: K2/K3 launches exact in each forward, none in the
    backward; the gradients of the vertices (through ``set_vertices``),
    the bitmap's texels, the reflectances and the vertex colours finite
    and non-zero."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    scene = vertex_colored(mt.load_dict(textured_mesh(files, res, spp)))
    expect = {"bvh4_closest_hit": DEPTH, "bvh4_any_hit": DEPTH,
              "bvh4_closest_hit_mp": 0, "mt_closest_hit": 0,
              "mt_any_hit": 0}
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for run in ["warm-up", "timed 1", "timed 2", "timed 3"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(passes):
            v = scene.vertices.clone().requires_grad_(True)
            lv = texture_leaves(scene)
            sc = scene.set_vertices(v).with_leaves(lv)
            zero_counts()
            img = mt.render(sc, spp=spp, seed=p + 1)
            loss = torch.mean(img ** 2)
            fwd = read_counts()
            zero_counts()
            grads = torch.autograd.grad(loss, [v, *lv.values()])
            bwd = read_counts()
            for k, n in expect.items():
                check(fwd[k] == n, f"textures mesh: {k} launched {fwd[k]} "
                      f"times in a forward, expected {n}")
            check(sum(bwd.values()) == 0,
                  f"textures mesh: the replay launched kernels: {bwd}")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        norms = {k: float(g.norm()) for k, g in
                 zip(("vertices", *lv), grads)}
        say(f"[textures mesh] {run}: {walls[-1]:.1f} ms for {passes} "
            f"passes, loss {float(loss):.6g}; |grad| "
            + ", ".join(f"{k} {n:.4g}" for k, n in norms.items()))
        check(len(norms) == 4, f"textures mesh: leaves {list(norms)}")
        for k, g in zip(("vertices", *lv), grads):
            check(bool(torch.isfinite(g).all()) and norms[k] > 0,
                  f"textures mesh: the gradient of {k} is not finite and "
                  "non-zero")
    CT.raise_on_overflow(scene.device)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ws = sorted(walls[1:])
    rays = res * res * spp * DEPTH * 2 * passes
    mrays = rays / (ws[1] / 1e3) / 1e6
    say(f"[textures mesh] cornell_box_mesh textured, {res}^2 x {spp} spp, "
        f"{passes} fwd+bwd passes: wall median {ws[1]:.1f} ms (range "
        f"{ws[0]:.1f}-{ws[-1]:.1f}); {mrays:.2f} physical Mrays/s fwd+bwd; "
        f"forward launches {fwd}; peak device memory {peak:.2f} GiB")
    return dict(median_ms=ws[1], range_ms=(ws[0], ws[-1]), mrays=mrays,
                counts=fwd, peak_gib=peak)


def textures_epsm_cell(files, res=EPSM_RES, spp=EPSM_SPP):
    """textures-epsm-mesh-128-8spp: the epsm-mesh cell with the bitmap
    reflectance and the normal map (``textured_mesh`` without the sphere's
    colours): a warm-up and one timed ``manifold`` iteration, ms by phase
    (CUDA events), K2/K3 launches exact, the gradient finite and
    non-zero, the peak memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    scene = mt.load_dict(textured_mesh(files, res, spp, sphere_colors=False))
    dev = scene.device
    with torch.no_grad():
        gt = mt.render(scene, spp=spp, seed=123,
                       integrator={"type": "path", "max_depth": DEPTH})
    gt_low = gt.reshape(-1, 3)
    matcher = Matcher(res)
    v0 = scene.vertices
    ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
    integ = {"type": "manifold", "max_depth": DEPTH}
    timer = epsm_backward_timer()

    def iteration(seed):
        theta = torch.tensor(0.01, device=dev, requires_grad=True)
        sc = scene.set_vertices(v0 + theta * ex)
        img = timer.wrap_call("forward render", lambda: mt.render(
            sc, spp=spp, seed=seed, integrator=integ))
        with torch.no_grad():
            g5 = timer.wrap_call("Sinkhorn match", lambda: (
                matcher.match_Sinkhorn(img[..., :3].reshape(-1, 3),
                                       gt_low))).reshape(res, res, 5)
        (g,) = timer.wrap_call("backward", lambda: torch.autograd.grad(
            torch.sum(img * g5), theta))
        return float(g)

    try:
        torch.cuda.reset_peak_memory_stats()
        for i, run in enumerate(("warm-up", "timed")):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = iteration(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            ms = split_phases(timer.read())
            say(f"[textures epsm] {run}: {wall:.1f} ms, dL/dtheta {g:.6g}; "
                + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                + f" ms; launches {counts}")
            check(math.isfinite(g) and g != 0.0,
                  f"textures epsm: gradient {g}")
            for k, n in {"bvh4_closest_hit": 4 * DEPTH + 1,
                         "bvh4_any_hit": 3 * DEPTH, "mt_closest_hit": 0,
                         "mt_any_hit": 0}.items():
                check(counts[k] == n, f"textures epsm: {k} launched "
                      f"{counts[k]} times, expected {n}")
            CT.raise_on_overflow(dev)
    finally:
        timer.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"[textures epsm] cornell_box_mesh textured, {res}^2 x {spp} spp, "
        f"one manifold iteration: {wall:.1f} ms; peak device memory "
        f"{peak:.2f} GiB")
    return dict(wall_ms=wall, phases=ms, counts=counts, peak_gib=peak)


def textures_card_vs_cpu(files, res=64, spp=4):
    """[textures card vs cpu] at 64^2 x 4 spp, depth 6, with the camera
    phase's gates: the box's and the mesh's images (<= 1e-3 of the mean)
    and PRB gradients (vertices, texels, reflectances, vertex colours;
    relative L2 <= 1e-3), and the manifold backward of the textured box.
    The texels' and vertex colours' gradients sum through ``index_add_``
    atomics on the card."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.integrators import epsm as ET
    for label, d in (("box", textured_box(files, res, spp)),
                     ("mesh", textured_mesh(files, res, spp))):
        got, imgs = {}, {}
        for dev in ("cuda", "cpu"):
            sc = vertex_colored(mt.load_dict(d, device=dev))
            v = sc.vertices.clone().requires_grad_(True)
            lv = texture_leaves(sc)
            img = mt.render(sc.set_vertices(v).with_leaves(lv), spp=spp,
                            seed=0, device=dev)
            gs = torch.autograd.grad((img ** 2).mean(), [v, *lv.values()])
            imgs[dev] = img.detach().cpu()
            got[dev] = dict(zip(("vertices", *lv), gs))
        diff = (imgs["cuda"] - imgs["cpu"]).abs()
        mad, mean = float(diff.mean()), float(imgs["cpu"].mean())
        within = float((diff.amax(-1) <= 1e-3).float().mean())
        errs = {k: rel_l2(got["cuda"][k].cpu(), g)
                for k, g in got["cpu"].items()}
        say(f"[textures card vs cpu] {label} {res}^2 x {spp} spp: mean "
            f"|gpu - cpu| {mad:.3g} (limit {1e-3 * mean:.3g} = 1e-3 x mean "
            f"{mean:.4f}); {100 * within:.2f} % of pixels within 1e-3 (limit "
            "99 %); PRB gradients |g_gpu - g_cpu| / |g_cpu| "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + "  [limit 1e-3 each]")
        check(mad <= 1e-3 * mean and within >= 0.99,
              f"textures {label}: card and CPU renders disagree")
        for k, e in errs.items():
            check(e <= 1e-3 and float(got["cpu"][k].abs().max()) > 0,
                  f"textures {label}: card and CPU gradients of {k} differ "
                  f"by {e} relative")
    d = textured_box(files, res, spp)
    g = torch.randn(res, res, 5, generator=torch.Generator().manual_seed(4))
    got = {}
    for dev in ("cuda", "cpu"):
        sc = mt.load_dict(d, device=dev)
        names = ("vertices", *texture_leaves(sc))
        got[dev] = ET.render_backward(sc, names, g.to(sc.device) * 0.05, 3,
                                      DEPTH, 5, False, -1, spp)
    errs = {k: rel_l2(got["cuda"][k].cpu(), got["cpu"][k]) for k in names}
    say(f"[textures card vs cpu] manifold backward, textured box {res}^2 x "
        f"{spp} spp: |g_gpu - g_cpu| / |g_cpu| "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + "  [limit 1e-3 each]")
    for k, e in errs.items():
        check(e <= 1e-3 and float(got["cpu"][k].abs().max()) > 0,
              f"textures: manifold backward {k} card vs cpu {e}")


def textures_phase():
    """[textures]: textured BSDFs, vertex colours, normal maps and
    tabulated spectra on every render path (K1 on the box, K2/K3 on the
    mesh and in the EPSM iteration), then the card against the CPU.
    Returns the numbers and the K1-K4 launches of the phase."""
    global _TALLY
    import tempfile
    zero_counts()
    _TALLY = {}
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            files = texture_files(tmp)
            for label, fn in (("box", textures_box_cell),
                              ("mesh", textures_mesh_cell),
                              ("epsm", textures_epsm_cell),
                              ("card vs cpu", textures_card_vs_cpu)):
                t0 = time.perf_counter()
                out[label] = fn(files)
                say(f"[textures] {label}: {time.perf_counter() - t0:.1f} s")
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    return out


# ---------------------------------------------------------------------------
# [bsdfs]: the remaining scalar BSDFs, mask and Beckmann on every path
# ---------------------------------------------------------------------------

#: [bsdfs]: texels a side of the albedo and opacity bitmaps.  A box render
#: takes 14-19 s (85,000 launches a pass) and a mesh fwd+bwd run 7-8 s:
#: each cell times one after a warm-up of one pass, so that the phase
#: stays within 120 s
BS_TEX = 256
#: [bsdfs]: the BSDF columns held as leaves beside the vertices
BS_LEAVES = ("bsdfs.alpha", "bsdfs.diffuse_reflectance", "bsdfs.reflectance",
             "bsdfs.blend_weight", "bsdfs.eta")


def bsdf_files(tmp):
    """The textures of [bsdfs], smooth fields (``smooth_field``) from the
    script's seed written as EXR: an albedo in [0.1, 0.9] (a plastic's
    ``reflectance``, which serves its diffuse reflectance) and an opacity
    in [0.3, 0.9] (the back wall's mask)."""
    import os
    import numpy as np
    from epsm_mitsuba3_torch.core.bitmap import write_image
    r = np.random.default_rng(14)
    out = {"albedo": os.path.join(tmp, "albedo.exr"),
           "opacity": os.path.join(tmp, "opacity.exr")}
    write_image(out["albedo"], 0.1 + 0.8 * smooth_field(r, BS_TEX, 3))
    write_image(out["opacity"], 0.3 + 0.6 * smooth_field(r, BS_TEX, 3))
    return out


def _quad(center, scale, bsdf, rot):
    from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
    return {"type": "rectangle", "bsdf": bsdf,
            "to_world": T.translate(center).rotate([0, 1, 0], rot)
            .scale(scale)}


def bsdf_box(files, res, spp, null_quads=True):
    """bsdfs-box: ``cornell_box(res, spp, DEPTH)`` with a Beckmann rough
    plastic floor, a principled back wall under a mask of textured
    opacity, a left wall blending a plastic of textured albedo with a
    Beckmann rough dielectric, a two-sided principledthin right wall, and
    quads: a thin dielectric and a null (``null_quads``), a pplastic and
    a GGX rough dielectric; 20 triangles, K1."""
    from epsm_mitsuba3_torch.scenes import cornell_box
    d = cornell_box(res=res, spp=spp, max_depth=DEPTH)
    d["floor"]["bsdf"] = {"type": "roughplastic", "distribution": "beckmann",
                          "alpha": 0.2, "int_ior": 1.6,
                          "diffuse_reflectance": [0.6, 0.55, 0.45]}
    d["back"]["bsdf"] = {
        "type": "mask", "opacity": {"type": "bitmap",
                                    "filename": files["opacity"]},
        "bsdf": {"type": "principled", "base_color": [0.7, 0.35, 0.2],
                 "metallic": 0.3, "roughness": 0.4, "clearcoat": 0.5,
                 "sheen": 0.3}}
    d["left"]["bsdf"] = {
        "type": "blendbsdf", "weight": 0.35,
        "a": {"type": "plastic", "reflectance": {
            "type": "bitmap", "filename": files["albedo"]}},
        "b": {"type": "roughdielectric", "alpha": 0.2,
              "distribution": "beckmann"}}
    d["right"]["bsdf"] = {"type": "twosided", "bsdf": {
        "type": "principledthin", "base_color": [0.2, 0.6, 0.25],
        "spec_trans": 0.3, "diff_trans": 0.8, "eta": 1.45,
        "roughness": 0.3}}
    if null_quads:
        d["sheet"] = _quad([-0.45, 0.6, 0.2], 0.3,
                           {"type": "thindielectric", "int_ior": 1.5}, 20.0)
        d["ghost"] = _quad([0.4, 0.5, 0.3], 0.25, {"type": "null"}, -30.0)
    d["panel"] = _quad([0.25, 1.25, -0.45], 0.3,
                       {"type": "pplastic", "alpha": 0.15,
                        "diffuse_reflectance": [0.3, 0.4, 0.7]}, 15.0)
    d["pane"] = _quad([-0.2, 1.3, 0.4], 0.2,
                      {"type": "twosided", "bsdf": {
                          "type": "roughdielectric", "alpha": 0.1}}, -10.0)
    return d


def bsdf_mesh(res, spp):
    """bsdfs-mesh: ``cornell_box_mesh(res, spp, DEPTH)`` with the sphere a
    Beckmann rough dielectric (outward normals, ``blob_normals``), a GGX
    rough plastic floor and a left wall blending a diffuse red with a
    rough conductor."""
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    d = blob_normals(cornell_box_mesh(res=res, spp=spp, max_depth=DEPTH))
    d["blob"]["bsdf"] = {"type": "roughdielectric", "alpha": 0.15,
                         "distribution": "beckmann", "int_ior": 1.5}
    d["floor"]["bsdf"] = {"type": "roughplastic", "alpha": 0.25,
                          "diffuse_reflectance": [0.6, 0.55, 0.45]}
    d["left"]["bsdf"] = {"type": "blendbsdf", "weight": 0.4,
                         "a": {"type": "diffuse",
                               "reflectance": [0.57, 0.043, 0.044]},
                         "b": {"type": "roughconductor", "alpha": 0.2}}
    return d


def bsdf_epsm_mesh(res, spp):
    """bsdfs-epsm: ``cornell_box_mesh(res, spp, DEPTH)`` with a rough
    plastic sphere (outward normals, ``blob_normals``; a glossy slot, so
    the alpha branch runs) and the back wall a mask of opacity 0.7 over
    the diffuse white."""
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    d = blob_normals(cornell_box_mesh(res=res, spp=spp, max_depth=DEPTH))
    d["blob"]["bsdf"] = {"type": "roughplastic", "alpha": 0.2,
                         "diffuse_reflectance": [0.55, 0.45, 0.3]}
    d["back"]["bsdf"] = {"type": "mask", "opacity": 0.7,
                         "bsdf": d["back"]["bsdf"]}
    return d


def bsdf_leaves(scene):
    """Copies that require grad of the BSDF columns BS_LEAVES."""
    return {k: v.clone().requires_grad_(True)
            for k, v in scene.leaves().items() if k in BS_LEAVES}


def bsdfs_box_cell(files, res=RES, spp=SPP, chunk=SPP_CHUNK):
    """bsdfs-box-512-64spp: the box with the new kinds at the box render
    cell's size (K1): a warm-up pass and one timed render, K1 launches of
    each exact, the image finite and not flat, one profiled pass, the
    peak memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.models import bsdf as B
    n_passes = spp // chunk
    expect = {"mt_closest_hit": DEPTH * n_passes,
              "mt_any_hit": DEPTH * n_passes, "bvh4_closest_hit": 0,
              "bvh4_any_hit": 0}
    scene = mt.load_dict(bsdf_box(files, res, chunk))
    kinds = scene.static.bsdf_kinds
    check(kinds == (0, 4, 5, 6, 7, 8, 9, 10, 11, 17,
                    B.KIND_SENTINEL_BECKMANN)
          and scene.faces.shape[0] <= 4096, f"bsdfs box: kinds {kinds}, "
          f"{scene.faces.shape[0]} triangles")
    torch.cuda.reset_peak_memory_stats()
    for run, n_spp in (("warm-up pass", chunk), ("timed render", spp)):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = mt.render(scene, spp=n_spp, spp_chunk=chunk, seed=0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        for k, n in expect.items():
            n = n * n_spp // spp
            check(counts[k] == n, f"bsdfs box: {k} launched {counts[k]} "
                  f"times in the {run}, expected {n}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean, std = float(img.mean()), float(img.std())
    check(tuple(img.shape) == (res, res, 3)
          and bool(torch.isfinite(img).all()) and mean > 0
          and std > 0.05 * mean, f"bsdfs box: image shape "
          f"{tuple(img.shape)}, mean {mean}, std {std}")
    prof = profile_pass(f"bsdfs box, one {chunk}-spp pass",
                        lambda: mt.render(scene, spp=chunk, seed=7),
                        ("mt_closest", "mt_any"), cpu=False, table=False)
    say(f"[bsdfs box] {res}^2 x {spp} spp in passes of {chunk}, kinds "
        f"{kinds}: wall {wall:.1f} ms; launches {counts}; image mean "
        f"{mean:.5f}, std {std:.5f}; peak device memory {peak:.2f} GiB; "
        "busy of a pass "
        + (f"{prof['busy']:.1f} of {prof['wall']:.1f} ms "
           f"({100 * prof['busy'] / prof['wall']:.1f} %), "
           f"{prof['launches']} launches" if prof else "not measured"))
    return dict(wall_ms=wall, counts=counts, mean=mean, peak_gib=peak,
                profile=prof)


def bsdfs_mesh_cell(res=RES, spp=MESH_CHUNK, passes=MESH_PASSES):
    """bsdfs-mesh-512-8spp-fwdbwd: the mesh with a Beckmann rough
    dielectric sphere and rough plastic and blend walls, a warm-up pass
    and one timed run of ``passes`` fwd+bwd passes (the loss
    ``mean(img^2)``): K2/K3 launches exact in each forward, none in the
    backward; the gradients of the vertices (through ``set_vertices``)
    and of BS_LEAVES finite and non-zero; one profiled pass."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    scene = mt.load_dict(bsdf_mesh(res, spp))
    expect = {"bvh4_closest_hit": DEPTH, "bvh4_any_hit": DEPTH,
              "bvh4_closest_hit_mp": 0, "mt_closest_hit": 0,
              "mt_any_hit": 0}

    def one_pass(seed):
        v = scene.vertices.clone().requires_grad_(True)
        lv = bsdf_leaves(scene)
        sc = scene.set_vertices(v).with_leaves(lv)
        zero_counts()
        img = mt.render(sc, spp=spp, seed=seed)
        loss = torch.mean(img ** 2)
        fwd = read_counts()
        zero_counts()
        grads = torch.autograd.grad(loss, [v, *lv.values()])
        return loss, dict(zip(("vertices", *lv), grads)), fwd, read_counts()

    torch.cuda.reset_peak_memory_stats()
    for run, n_passes in (("warm-up pass", 1), ("timed run", passes)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(n_passes):
            loss, grads, fwd, bwd = one_pass(p + 1)
            for k, n in expect.items():
                check(fwd[k] == n, f"bsdfs mesh: {k} launched {fwd[k]} "
                      f"times in a forward, expected {n}")
            check(sum(bwd.values()) == 0,
                  f"bsdfs mesh: the replay launched kernels: {bwd}")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        norms = {k: float(g.norm()) for k, g in grads.items()}
        say(f"[bsdfs mesh] {run}: {wall:.1f} ms for {n_passes} passes, "
            f"loss {float(loss):.6g}; |grad| "
            + ", ".join(f"{k} {n:.4g}" for k, n in norms.items()))
        check(len(norms) == 1 + len(BS_LEAVES),
              f"bsdfs mesh: leaves {list(norms)}")
        for k, g in grads.items():
            check(bool(torch.isfinite(g).all()) and norms[k] > 0,
                  f"bsdfs mesh: the gradient of {k} is not finite and "
                  "non-zero")
    CT.raise_on_overflow(scene.device)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_pass(f"bsdfs mesh, one {spp}-spp fwd+bwd pass",
                        lambda: one_pass(99), ("bvh4_closest", "bvh4_any"),
                        cpu=False, table=False)
    rays = res * res * spp * DEPTH * 2 * passes
    mrays = rays / (wall / 1e3) / 1e6
    say(f"[bsdfs mesh] cornell_box_mesh with the new kinds, {res}^2 x {spp} "
        f"spp, {passes} fwd+bwd passes: wall {wall:.1f} ms; {mrays:.2f} "
        f"physical Mrays/s fwd+bwd; forward launches {fwd}; peak device "
        f"memory {peak:.2f} GiB")
    return dict(wall_ms=wall, mrays=mrays, counts=fwd, peak_gib=peak,
                profile=prof)


def bsdfs_epsm_cell(res=EPSM_RES, spp=EPSM_SPP):
    """bsdfs-epsm-mesh-128-8spp: the epsm-mesh cell with a rough plastic
    sphere and a masked back wall: a warm-up and one timed ``manifold``
    iteration, ms by phase (CUDA events), K2/K3 launches exact (25 /
    18), the theta gradient and the alpha branch's gradient finite and
    non-zero, the peak memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    scene = mt.load_dict(bsdf_epsm_mesh(res, spp))
    dev = scene.device
    with torch.no_grad():
        gt = mt.render(scene, spp=spp, seed=123,
                       integrator={"type": "path", "max_depth": DEPTH})
    gt_low = gt.reshape(-1, 3)
    matcher = Matcher(res)
    v0 = scene.vertices
    ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
    integ = {"type": "manifold", "max_depth": DEPTH}
    timer = epsm_backward_timer()

    def iteration(seed):
        theta = torch.tensor(0.01, device=dev, requires_grad=True)
        alpha = scene.bsdfs["alpha"].clone().requires_grad_(True)
        sc = scene.set_vertices(v0 + theta * ex).with_leaves(
            {"bsdfs.alpha": alpha})
        img = timer.wrap_call("forward render", lambda: mt.render(
            sc, spp=spp, seed=seed, integrator=integ))
        with torch.no_grad():
            g5 = timer.wrap_call("Sinkhorn match", lambda: (
                matcher.match_Sinkhorn(img[..., :3].reshape(-1, 3),
                                       gt_low))).reshape(res, res, 5)
        g, ga = timer.wrap_call("backward", lambda: torch.autograd.grad(
            torch.sum(img * g5), [theta, alpha]))
        return float(g), ga

    try:
        torch.cuda.reset_peak_memory_stats()
        for i, run in enumerate(("warm-up", "timed")):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, ga = iteration(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            ms = split_phases(timer.read())
            say(f"[bsdfs epsm] {run}: {wall:.1f} ms, dL/dtheta {g:.6g}, "
                f"|dL/dalpha| {float(ga.norm()):.6g}; "
                + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                + f" ms; launches {counts}")
            check(math.isfinite(g) and g != 0.0
                  and bool(torch.isfinite(ga).all())
                  and float(ga.norm()) > 0,
                  f"bsdfs epsm: gradients {g}, {ga}")
            for k, n in {"bvh4_closest_hit": 4 * DEPTH + 1,
                         "bvh4_any_hit": 3 * DEPTH, "mt_closest_hit": 0,
                         "mt_any_hit": 0}.items():
                check(counts[k] == n, f"bsdfs epsm: {k} launched "
                      f"{counts[k]} times, expected {n}")
            CT.raise_on_overflow(dev)
    finally:
        timer.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"[bsdfs epsm] cornell_box_mesh, rough plastic sphere and a mask, "
        f"{res}^2 x {spp} spp, one manifold iteration: {wall:.1f} ms; peak "
        f"device memory {peak:.2f} GiB")
    return dict(wall_ms=wall, phases=ms, counts=counts, peak_gib=peak)


def bsdfs_card_vs_cpu(files, res=64, spp=4):
    """[bsdfs card vs cpu] at 64^2 x 4 spp, depth 6, with the camera
    phase's gates: the box's and the mesh's images (<= 1e-3 of the mean,
    99 % of pixels within 1e-3) and PRB gradients (the vertices and
    BS_LEAVES, relative L2 <= 1e-3), and the manifold backward of the
    box without its thin-dielectric and null quads (the vertices and
    alpha).  A path through a null lobe puts a singular half-vector
    constraint into the manifold solve: with those quads a 1e-7 change
    of the vertices moves the vertices' manifold gradient by 3-8 %
    (``ROADMAP.md`` queue 3), the card and the CPU then 4.8e-2 apart."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.integrators import epsm as ET
    for label, d in (("box", bsdf_box(files, res, spp)),
                     ("mesh", bsdf_mesh(res, spp))):
        got, imgs = {}, {}
        for dev in ("cuda", "cpu"):
            sc = mt.load_dict(d, device=dev)
            v = sc.vertices.clone().requires_grad_(True)
            lv = bsdf_leaves(sc)
            img = mt.render(sc.set_vertices(v).with_leaves(lv), spp=spp,
                            seed=0, device=dev)
            gs = torch.autograd.grad((img ** 2).mean(), [v, *lv.values()])
            imgs[dev] = img.detach().cpu()
            got[dev] = dict(zip(("vertices", *lv), gs))
        diff = (imgs["cuda"] - imgs["cpu"]).abs()
        mad, mean = float(diff.mean()), float(imgs["cpu"].mean())
        within = float((diff.amax(-1) <= 1e-3).float().mean())
        errs = {k: rel_l2(got["cuda"][k].cpu(), g)
                for k, g in got["cpu"].items()}
        say(f"[bsdfs card vs cpu] {label} {res}^2 x {spp} spp: mean "
            f"|gpu - cpu| {mad:.3g} (limit {1e-3 * mean:.3g} = 1e-3 x mean "
            f"{mean:.4f}); {100 * within:.2f} % of pixels within 1e-3 (limit "
            "99 %); PRB gradients |g_gpu - g_cpu| / |g_cpu| "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + "  [limit 1e-3 each]")
        check(mad <= 1e-3 * mean and within >= 0.99,
              f"bsdfs {label}: card and CPU renders disagree")
        for k, e in errs.items():
            check(e <= 1e-3 and float(got["cpu"][k].abs().max()) > 0,
                  f"bsdfs {label}: card and CPU gradients of {k} differ "
                  f"by {e} relative")
    d = bsdf_box(files, res, spp, null_quads=False)
    g = torch.randn(res, res, 5, generator=torch.Generator().manual_seed(4))
    names = ("vertices", "bsdfs.alpha")
    got = {}
    for dev in ("cuda", "cpu"):
        sc = mt.load_dict(d, device=dev)
        got[dev] = ET.render_backward(sc, names, g.to(sc.device) * 0.05, 3,
                                      DEPTH, 5, False, -1, spp)
    errs = {k: rel_l2(got["cuda"][k].cpu(), got["cpu"][k]) for k in names}
    say(f"[bsdfs card vs cpu] manifold backward, bsdfs box without the null "
        f"quads {res}^2 x {spp} spp: |g_gpu - g_cpu| / |g_cpu| "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + "  [limit 1e-3 each]")
    for k, e in errs.items():
        check(e <= 1e-3 and float(got["cpu"][k].abs().max()) > 0,
              f"bsdfs: manifold backward {k} card vs cpu {e}")


def bsdfs_phase():
    """[bsdfs]: the remaining scalar BSDFs, mask and Beckmann on every
    render path (K1 on the box, K2/K3 on the mesh and in the EPSM
    iteration), then the card against the CPU.  Returns the numbers and
    the K1-K4 launches of the phase."""
    global _TALLY
    import tempfile
    zero_counts()
    _TALLY = {}
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            files = bsdf_files(tmp)
            for label, fn in (("box", lambda: bsdfs_box_cell(files)),
                              ("mesh", bsdfs_mesh_cell),
                              ("epsm", bsdfs_epsm_cell),
                              ("card vs cpu",
                               lambda: bsdfs_card_vs_cpu(files))):
                t0 = time.perf_counter()
                out[label] = fn()
                say(f"[bsdfs] {label}: {time.perf_counter() - t0:.1f} s")
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    return out


# ---------------------------------------------------------------------------
# [human]: the SMPL pose experiment, its two-stage bridge, the launcher,
# checkpoints and resume
# ---------------------------------------------------------------------------

def check_pose_gradient(label, pg):
    """The pose gradient finite, non-zero on the perturbed joints 16-19
    and exactly zero on the leaf joints."""
    import torch
    by_joint = pg.detach().abs().reshape(24, 3).sum(1).cpu()
    say(f"[human] {label}: |dL/dpose| by joint "
        + ", ".join(f"{j} {float(x):.4g}" for j, x in enumerate(by_joint))
        + f"; non-zero on {int((by_joint > 0).sum())} joints")
    check(bool(torch.isfinite(pg).all()), f"{label}: pose gradient not "
          "finite")
    check(bool((by_joint[16:20] > 0).all()), f"{label}: zero gradient on "
          "a perturbed joint (16-19)")
    check(float(by_joint[list(HU_LEAVES)].max()) == 0, f"{label}: "
          "non-zero gradient on a leaf joint (10, 11, 22, 23)")


def human_expect_manifold(it, depth):
    """K1 launches of one ``run("manifold")`` iteration: the stage-1
    render (D + D), the EPSM pass (4 D + 1 closest, 3 D any), the ground
    truth's D + D in iteration 0."""
    gt = depth if it == 0 else 0
    return {"mt_closest_hit": gt + depth + 4 * depth + 1,
            "mt_any_hit": gt + depth + 3 * depth,
            "bvh4_closest_hit": 0, "bvh4_any_hit": 0,
            "bvh4_closest_hit_mp": 0}


def human_run(method="manifold", iters=HU_ITERS,
              expect=human_expect_manifold, tag="human"):
    """``optim_human.run(method)`` on ``human.make()`` at HU_SPP spp,
    512^2, match_res HU_MATCH, ``iters`` iterations: ms an iteration and by
    phase (CUDA events: the ground truth, the stage-1 render, the match,
    the stage-2 render and backward, the skinning's forward and VJP,
    Adam), K1 launches an iteration (each count exact, ``expect(it,
    depth)``), the peak memory of each phase (each pass unsplit), the busy
    share of the last iteration under the profiler (from the ground
    truth's end where there is one iteration), each pose gradient finite,
    non-zero on joints 16-19 and zero on the leaf joints.  Returns the
    rows, the launch totals and the experiment."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from epsm_mitsuba3_torch.app import optim_human as OH
    from epsm_mitsuba3_torch.app.exp import human
    depth = 3
    prof_it = iters - 1
    timer = PhaseTimer()
    timer.wrap(OH.Matcher, "match_Sinkhorn", "match")
    timer.wrap(OH, "vertex_gradient", "stage-2 render and backward")
    timer.wrap(OH, "pose_gradient", "pose_gradient")
    orig_render, orig_step, orig_make = OH.render, OH.Adam.step, human.make
    exps, rows, grads, total, peaks = [], [], [], {}, {}
    mark, prof = [None], [None]

    def peak_of(label, fn):
        """fn() with the peak device memory it reaches kept in peaks."""
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        peaks[label] = max(peaks.get(label, 0.0),
                           torch.cuda.max_memory_allocated() / 2 ** 30)
        return out

    match, vertex_gradient = OH.Matcher.match_Sinkhorn, OH.vertex_gradient
    OH.Matcher.match_Sinkhorn = lambda *a, **kw: peak_of(
        "match", lambda: match(*a, **kw))
    OH.vertex_gradient = lambda *a, **kw: peak_of(
        "stage-2 render and backward", lambda: vertex_gradient(*a, **kw))

    def make(**kw):
        t0 = time.perf_counter()
        exps.append(orig_make(**kw))
        torch.cuda.synchronize()
        say(f"[{tag}] human.make: {exps[-1]['scene'].faces.shape[0]} "
            f"triangles (K1), loaded in {time.perf_counter() - t0:.2f} s")
        zero_counts()
        mark[0] = time.perf_counter()
        return exps[-1]

    def start_profile():
        torch.cuda.synchronize()
        prof[0] = profile(activities=[ProfilerActivity.CUDA])
        prof[0].__enter__()

    def render(*a, **kw):
        if kw["integrator"]["type"] == "path":
            label = "ground truth"
        elif not torch.is_grad_enabled():
            label = "stage-1 render"
        else:
            return orig_render(*a, **kw)
        out = peak_of(label, lambda: timer.wrap_call(
            label, lambda: orig_render(*a, **kw)))
        if label == "ground truth" and prof_it == 0:
            start_profile()
        return out

    def step(self, g):
        grads.append(g["pose"].detach().clone())
        out = timer.wrap_call("Adam", lambda: orig_step(self, g))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - mark[0]) * 1e3
        counts = read_counts()
        zero_counts()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        rows.append(dict(it=len(rows), wall=wall, counts=counts,
                         phases=timer.read(), pose=self["pose"].clone()))
        if prof[0] is not None and len(rows) == prof_it + 1:
            prof[0].__exit__(None, None, None)
        elif len(rows) == prof_it:
            start_profile()
        mark[0] = time.perf_counter()
        return out

    OH.render, OH.Adam.step, human.make = render, step, make
    try:
        t0 = time.perf_counter()
        pose, losses = OH.run(method, iters=iters, resolution=RES,
                              spp=HU_SPP, match_res=HU_MATCH, verbose=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        OH.render, OH.Adam.step, human.make = orig_render, orig_step, \
            orig_make
        OH.Matcher.match_Sinkhorn, OH.vertex_gradient = match, \
            vertex_gradient
        timer.close()
    # every large allocation of the run is made inside one of the phases
    peak = max(peaks.values())
    kernels = _device_events(prof[0]) if prof[0] is not None else []
    busy = sum(ms for _, ms, _ in kernels)
    k1_ms = sum(ms for k, ms, _ in kernels if "mt_closest" in k
                or "mt_any" in k)
    n_launch = sum(n for _, _, n in kernels)
    for r, g, loss in zip(rows, grads, losses):
        ph = r["phases"]
        ph["LBS forward and VJP"] = ph.pop("pose_gradient", 0.0) - ph.get(
            "stage-2 render and backward", 0.0)
        ph["other"] = r["wall"] - sum(ph.values())
        want = expect(r["it"], depth)
        notes = [n for n, on in (("with the ground truth", r["it"] == 0),
                                 ("under the profiler", r["it"] == prof_it))
                 if on]
        say(f"[{tag}] iteration {r['it']} ({', '.join(notes) or 'timed'})"
            + f": {r['wall']:.1f} ms; loss {loss:.6g}; ms by phase "
            + ", ".join(f"{k} {v:.1f}" for k, v in ph.items())
            + f"; launches {r['counts']}")
        for k, n in want.items():
            check(r["counts"][k] == n, f"{tag}: {k} launched "
                  f"{r['counts'][k]} times in iteration {r['it']}, "
                  f"expected {n}")
        check(math.isfinite(loss), f"{tag}: loss not finite")
        check_pose_gradient(f"{method} run, iteration {r['it']}", g)
    exp = exps[0]
    moved = float((pose - exp["init_theta"]["pose"]).abs().max())
    check(bool(torch.isfinite(pose).all()) and moved > 0,
          f"{tag}: the pose did not move or is not finite")
    walls = [r["wall"] - r["phases"].get("ground truth", 0.0) for r in rows]
    say(f"[{tag}] {RES}^2 x {HU_SPP} spp (one pass), depth {depth}, "
        f"match_res {HU_MATCH}, {method}, {iters} iterations in "
        f"{run_s:.1f} s "
        "(the ground truth and the experiment's load included): ms an "
        "iteration without the ground truth "
        + ", ".join(f"{w:.1f}" for w in walls)
        + f"; peak device memory {peak:.2f} GiB (by phase: "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
        + f"); iteration {prof_it} under the profiler"
        + (" (after the ground truth)" if prof_it == 0 else "") + ": "
        + (f"device busy {busy:.1f} of {walls[prof_it]:.1f} ms "
           f"({100 * busy / walls[prof_it]:.1f} %), K1 {k1_ms:.1f} ms "
           f"({100 * k1_ms / walls[prof_it]:.1f} % of the iteration), "
           f"{n_launch} launches" if kernels
           else "the profiler saw no device time (not measured)")
        + f"; max |pose - init| {moved:.6g}; launches in all {total}")
    return dict(rows=rows, walls=walls, peak_gib=peak, peaks=peaks,
                total=total,
                busy=busy if kernels else None, k1_ms=k1_ms,
                launches=n_launch, exp=exp, run_s=run_s)


def synthetic_body(path):
    """A release-sized SMPL file at ``path``: a capsule a bone of HU_SEG
    rings of HU_RING vertices (the port's ``_capsule``), radii scaled by a
    draw from HU_SEED, the port's ``_blend_weights``, the rest joints and
    the tree, under the release's field names."""
    import numpy as np
    from epsm_mitsuba3_torch.models import smpl
    rng = np.random.default_rng(HU_SEED)
    verts, faces, off = [], [], 0
    for pj, a, b in smpl._bones():
        r = smpl._HEAD_RADIUS if pj == 15 else smpl._BONE_RADIUS.get(pj, 0.05)
        v, f = smpl._capsule(a, b, r * rng.uniform(0.9, 1.1), HU_SEG,
                             HU_RING)
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    v = np.concatenate(verts)
    np.savez(path, v_template=v, f=np.concatenate(faces),
             weights=smpl._blend_weights(v), J=smpl.rest_joints(),
             kintree_table=np.stack([np.asarray(smpl.SMPL_PARENTS),
                                     np.arange(24)]))
    return v.shape[0]


def human_release_body(gen):
    """One ``pose_gradient`` on the synthetic release-sized body through
    ``load_npz`` (a BVH scene): K2/K3 launches exact (a manifold pass of
    depth 3: 13 closest, 9 any hits), one refit in ``set_vertices``, the
    gradient's pattern; then K2 on the posed body against K1's brute
    force over the moved vertices."""
    import tempfile
    import torch
    from epsm_mitsuba3_torch.app import optim_human as OH
    from epsm_mitsuba3_torch.app.exp import human
    from epsm_mitsuba3_torch.ops import bvh as bvh_mod
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import intersect as I
    depth = 3
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/body.npz"
        n_v = synthetic_body(path)
        t0 = time.perf_counter()
        exp = human.make(resolution=RES, spp=HU_BODY_SPP,
                         match_res=HU_MATCH, smpl_npz=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    scene, model = exp["scene"], exp["model"]
    check(scene.bvh is not None, "release-sized body: no BVH")
    say(f"[human body] synthetic release-sized body: {n_v} vertices, "
        f"{model.faces.shape[0]} faces; the scene {scene.faces.shape[0]} "
        f"triangles, {scene.bvh_nodes.shape[0]} BVH4 records; loaded "
        f"through load_npz and built in {load_s:.2f} s")
    refits = []
    orig_refit = bvh_mod.refit

    def refit(*a, **kw):
        refits.append(1)
        return orig_refit(*a, **kw)

    g5 = torch.randn((RES, RES, 5), generator=gen, device=gen.device) * 1e-3
    bvh_mod.refit = refit
    try:
        zero_counts()
        t0 = time.perf_counter()
        pg, img = OH.pose_gradient(exp, exp["init_theta"]["pose"], g5,
                                   HU_BODY_SPP, depth, 1, 1, "manifold")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
    finally:
        bvh_mod.refit = orig_refit
    say(f"[human body] pose_gradient at {RES}^2 x {HU_BODY_SPP} spp: "
        f"{ms:.1f} ms; launches {counts}; refits {len(refits)}")
    expect = {"bvh4_closest_hit": 4 * depth + 1, "bvh4_any_hit": 3 * depth,
              "mt_closest_hit": 0, "mt_any_hit": 0, "bvh4_closest_hit_mp": 0}
    for k, n in expect.items():
        check(counts[k] == n, f"release-sized body: {k} launched "
              f"{counts[k]} times, expected {n}")
    check(len(refits) == 1, f"release-sized body: {len(refits)} refits in "
          "one pose_gradient, expected 1")
    check(bool(torch.isfinite(img).all()), "release-sized body: image not "
          "finite")
    check_pose_gradient("release-sized body", pg)
    posed = exp["set_verts"](scene, OH.smpl.lbs(model,
                                                exp["init_theta"]["pose"]))
    o, d, maxt = main_path_rays(posed, gen, 1)
    k = slice(0, 65536)
    t, slot, u, v = CT.closest_hit(posed.bvh_nodes, posed.bvh_tris, o[k],
                                   d[k], maxt[k])
    CT.raise_on_overflow(posed.device)
    prim = torch.where(slot >= 0, posed.bvh.order[slot.clamp(min=0).long()],
                       -1)
    tri = CI.pack_tris(posed.vertices, posed.faces)
    ref = I.ray_intersect_brute(tri, o[k], d[k], maxt[k])
    err = hold("human body: K2 on the posed, refit body vs K1 brute "
               "force", (t, prim, u, v, slot >= 0),
               (ref[0], ref[1].long(), ref[2], ref[3], ref[1] >= 0))
    return dict(ms=ms, counts=counts, err=err)


def human_launcher():
    """``run_experiments.main(["manifold", "human", "--small"])`` in a
    temporary directory (64^2, spp 8, 20 iterations, match 64; the
    ground truth at run's default 512 spp, in passes of 8): K1 launches
    exact, the logger's parameter dumps and metrics file; then
    ``optim.run`` with ``checkpoint_every`` 1 stopped after 2 iterations
    and resumed: the loaded variables, moments and t equal the saved ones
    bit for bit, on the card."""
    import os
    import tempfile
    import numpy as np
    import torch
    from epsm_mitsuba3_torch.ad.optimizers import Adam
    from epsm_mitsuba3_torch.app import optim
    from epsm_mitsuba3_torch.app import run_experiments as RX
    from epsm_mitsuba3_torch.app.exp import human
    from epsm_mitsuba3_torch.utils import checkpoint as ckpt
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            zero_counts()
            t0 = time.perf_counter()
            rc = RX.main(["manifold", "human", "--small"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            log = os.path.join(tmp, "results", "human", "manifold")
            params = sorted(os.listdir(os.path.join(log, "params")))
            last = np.load(os.path.join(log, "params", "param19.npy"),
                           allow_pickle=True).item()["pose"]
            has_metrics = os.path.exists(os.path.join(log, "metrics.jsonl"))
        finally:
            os.chdir(cwd)
        say(f"[human launcher] run_experiments manifold human --small: rc "
            f"{rc}, {secs:.1f} s; launches {counts}; {len(params)} "
            f"parameter dumps; metrics.jsonl {has_metrics}; final |pose| "
            f"{float(np.abs(last).mean()):.6g}")
        check(rc == 0, "run_experiments: non-zero return")
        check(params == sorted(f"param{i}.npy" for i in range(20))
              and has_metrics, "run_experiments: the logger's files")
        check(last.shape == (72,) and np.isfinite(last).all(),
              "run_experiments: the last pose dump")
        n_gt = -(-512 // 8)
        expect = {"mt_closest_hit": 20 * 13 + n_gt * 3,
                  "mt_any_hit": 20 * 9 + n_gt * 3}
        for k, n in expect.items():
            check(counts[k] == n, f"run_experiments: {k} launched "
                  f"{counts[k]} times, expected {n}")

        exp = human.make(resolution=64, spp=8, match_res=64)
        exp["gt_spp"] = 8
        log_dir = os.path.join(tmp, "resume")
        opt2, _ = optim.run("manifold", exp, iters=2, log_dir=log_dir,
                            checkpoint_every=1, verbose=False)
        fresh = Adam(lr=0.01)
        fresh["pose"] = exp["init_theta"]["pose"]
        start = ckpt.load_optimizer(os.path.join(log_dir, "ckpt"), fresh)
        same = (torch.equal(fresh["pose"], opt2["pose"])
                and all(torch.equal(a, b) for a, b in
                        zip(fresh.state["pose"], opt2.state["pose"]))
                and fresh.t == opt2.t)
        on_card = all(x.device.type == "cuda" for x in
                      (fresh["pose"], *fresh.state["pose"]))
        _, hist = optim.run("manifold", exp, iters=3, log_dir=log_dir,
                            resume=True, checkpoint_every=1, verbose=False)
        latest = ckpt.latest_step(os.path.join(log_dir, "ckpt"))
    say(f"[human resume] stopped after 2 iterations: resume at {start}; "
        f"variables, moments and t equal to the saved ones: {same}; on "
        f"the card: {on_card}; the resumed run ran {len(hist)} iteration, "
        f"latest checkpoint {latest}")
    check(start == 2 and same and on_card, "resume: the loaded optimizer "
          "is not the saved one")
    check(len(hist) == 1 and latest == 2, "resume: the run did not go on "
          "from its checkpoint")
    return dict(secs=secs, counts=counts)


def human_card_vs_cpu(res=64, spp=4):
    """``pose_gradient`` at 64^2 x 4 spp, depth 3, match_res 32, for one
    fixed 5-channel cotangent (seeded), on the card and on the CPU:
    relative L2 <= 1e-3."""
    import torch
    from epsm_mitsuba3_torch.app import optim_human as OH
    from epsm_mitsuba3_torch.app.exp import human
    g5 = torch.randn((res, res, 5), generator=torch.Generator().manual_seed(
        13)) * 0.05
    pgs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        exp = human.make(resolution=res, spp=spp, match_res=32, device=dev)
        pg, _ = OH.pose_gradient(exp, exp["init_theta"]["pose"], g5.to(dev),
                                 spp, 3, 1, 0, "manifold")
        pgs[dev] = pg.detach().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    a, b = pgs["cuda"], pgs["cpu"]
    err = rel_l2(a, b)
    say(f"[human, card vs cpu] dL/dpose at {res}^2 x {spp} spp, depth 3: "
        f"|g| {float(b.norm()):.6g}, joints 16-17 card "
        f"{[round(float(x), 7) for x in a[48:54]]} cpu "
        f"{[round(float(x), 7) for x in b[48:54]]}; |g_gpu - g_cpu| / "
        f"|g_cpu| {err:.3g}  [limit 1e-3]; card {secs['cuda']:.1f} s, cpu "
        f"{secs['cpu']:.1f} s")
    check_pose_gradient("card vs cpu, the card's", a)
    check(err <= 1e-3, f"human: card and CPU pose gradients differ by {err}")
    return err


def human_phase(gen):
    """[human]: the run at the published widths, K1 on a pass of the
    body's rays, the release-sized body through K2/K3, the launcher with
    its logs and a resumed run, the card against the CPU.  Returns the
    numbers and the K1-K4 launches of the phase."""
    global _TALLY
    secs, out = {}, {}
    zero_counts()
    _TALLY = {}
    try:
        for label, fn in (
                ("run", human_run),
                ("K1 on the body's rays", lambda: exp_rays_k1(
                    out["run"]["exp"], name="human", chunk=HU_RAYS_SPP)),
                ("release-sized body", lambda: human_release_body(gen)),
                ("launcher and resume", human_launcher),
                ("card vs cpu", human_card_vs_cpu)):
            t0 = time.perf_counter()
            out[label] = fn()
            secs[label] = time.perf_counter() - t0
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    out["run"].pop("exp")
    say("[human] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    out["secs"] = secs
    return out


# ---------------------------------------------------------------------------
# [reparam]: ray reparameterisation (prb_reparam) on the human experiment,
# the silhouette check, a BVH scene, the card against the CPU
# ---------------------------------------------------------------------------

def reparam_backward_launches(lanes, depth, num_rays=16):
    """Closest-hit launches of one prb_reparam backward: a warp of the
    incident direction at each bounce, of the shadow ray at each bounce
    but the last, and of the camera ray, ``num_rays`` launches each, in
    every lane chunk."""
    from epsm_mitsuba3_torch.ad import prb as PRB
    chunks = -(-lanes // PRB.REPARAM_CHUNK)
    return (depth + (depth - 1) + 1) * num_rays * chunks


def reparam_expect_human(it, depth):
    """K1 launches of one ``run("prb_reparam")`` iteration: the stage-1
    render D + D, the stage-2 recording forward D + D and its backward's
    auxiliary rays, the ground truth's D + D in iteration 0."""
    gt = depth if it == 0 else 0
    back = reparam_backward_launches(RES * RES * HU_SPP, depth)
    return {"mt_closest_hit": gt + 2 * depth + back,
            "mt_any_hit": gt + 2 * depth,
            "bvh4_closest_hit": 0, "bvh4_any_hit": 0,
            "bvh4_closest_hit_mp": 0}


def reparam_silhouette():
    """The JAX package's silhouette check (tests/test_reparam.py:44-75) on
    the card: the blocker moved by dx in x, d/ddx of sum(img * ramp) at
    dx = 0.  Detached PRB misses it (|g_prb| < 0.1 |fd|); prb_reparam has
    the finite difference's sign and lies within 0.3-3 times it."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import blocker_scene
    sc0 = mt.load_dict(blocker_scene(res=RP_SIL_RES, spp=RP_SIL_SPP))
    s, c = sc0.static.vertex_ranges[sc0.static.shape_names.index("blocker")]
    mask = torch.zeros_like(sc0.vertices)
    mask[s:s + c, 0] = 1.0
    ramp = torch.linspace(0, 1, RP_SIL_RES, device=sc0.device)[None, :, None]

    def loss(dx, kind, spp):
        sc = sc0.with_leaves({"vertices": sc0.vertices + dx * mask})
        img = mt.render(sc, spp=spp, seed=0,
                        integrator={"type": kind, "max_depth": 2})
        return torch.sum(img * ramp)

    with torch.no_grad():
        fd = float(loss(RP_SIL_EPS, "path", RP_SIL_FD_SPP)
                   - loss(-RP_SIL_EPS, "path", RP_SIL_FD_SPP)) / (
            2 * RP_SIL_EPS)
    g = {}
    for kind in ("prb", "prb_reparam"):
        dx = torch.zeros((), device=sc0.device, requires_grad=True)
        zero_counts()
        t0 = time.perf_counter()
        (g[kind],) = torch.autograd.grad(loss(dx, kind, RP_SIL_SPP), dx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        say(f"[reparam] silhouette {kind}: d/ddx {float(g[kind]):.6g}, "
            f"{ms:.1f} ms, launches {read_counts()}")
    g_prb, g_rep = float(g["prb"]), float(g["prb_reparam"])
    ratio = g_rep / fd if fd else float("nan")
    say(f"[reparam] silhouette {RP_SIL_RES}^2, depth 2: fd (path, "
        f"{RP_SIL_FD_SPP} spp, eps {RP_SIL_EPS}) {fd:.6g}; prb {g_prb:.6g} "
        f"(|g| / |fd| {abs(g_prb / fd):.3g}, limit < 0.1); prb_reparam "
        f"{g_rep:.6g} (g / fd {ratio:.3g}, limits 0.3-3)")
    check(abs(g_prb) < 0.1 * abs(fd), "silhouette: detached PRB should "
          "miss the moving shadow edge")
    check(0.3 <= ratio <= 3.0, "silhouette: prb_reparam's gradient is not "
          "within 0.3-3 times the finite difference, of its sign")
    return dict(fd=fd, prb=g_prb, reparam=g_rep)


def reparam_mesh_pass():
    """One prb_reparam fwd+bwd pass of cornell_box_mesh with sphere
    normals at 512^2 x RP_MESH_SPP spp, depth RP_MESH_DEPTH, after a
    warm-up pass: K2/K3 D / D in the forward, and the replay's auxiliary
    rays all K2 (``reparam_backward_launches``), no K3, no K1; the
    gradients finite and the vertices' non-zero; wall ms and peak
    memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    depth = RP_MESH_DEPTH
    scene = mt.load_dict(blob_normals(cornell_box_mesh(
        res=RES, spp=RP_MESH_SPP, max_depth=depth)))
    sc, leaves = trainable(scene)
    integ = {"type": "prb_reparam", "max_depth": depth}
    lanes = RES * RES * RP_MESH_SPP
    want_bwd = {"bvh4_closest_hit": reparam_backward_launches(lanes, depth),
                "bvh4_any_hit": 0, "bvh4_closest_hit_mp": 0,
                "mt_closest_hit": 0, "mt_any_hit": 0}
    want_fwd = {"bvh4_closest_hit": depth, "bvh4_any_hit": depth,
                "bvh4_closest_hit_mp": 0, "mt_closest_hit": 0,
                "mt_any_hit": 0}
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for run in ("warm-up", "timed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, fwd, bwd = fwd_bwd(sc, leaves, RP_MESH_SPP, 1, integ)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        for want, got, where in ((want_fwd, fwd, "forward"),
                                 (want_bwd, bwd, "backward")):
            for k, n in want.items():
                check(got[k] == n, f"reparam mesh: {k} launched {got[k]} "
                      f"times in the {where}, expected {n}")
    CT.raise_on_overflow(scene.device)
    norms = {k: float(g.norm()) for k, g in zip(leaves, grads)}
    say(f"[reparam] mesh {RES}^2 x {RP_MESH_SPP} spp, depth {depth}, "
        f"{scene.faces.shape[0]} triangles: fwd+bwd {walls[0]:.1f} ms "
        f"(warm-up), {walls[1]:.1f} ms; launches forward {fwd}, backward "
        f"{bwd}; |grad| " + ", ".join(f"{k} {v:.4g}" for k, v in
                                      norms.items())
        + f"; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "reparam mesh: gradients not finite")
    check(norms["vertices"] > 0, "reparam mesh: no vertex gradient")
    return dict(wall=walls[1], counts=bwd,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30)


def reparam_card_vs_cpu(res=64, spp=4):
    """prb_reparam on the card against the CPU at 64^2 x 4 spp, depth 3:
    the box with face normals and the blocker scene, the image (<= 1e-3
    x mean) and the gradients of the vertices, reflectances, radiance and
    sensor pose (relative L2 <= 1e-3 each)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import blocker_scene, cornell_box
    box = cornell_box(res=res, spp=spp, max_depth=3)
    for k in ("floor", "ceiling", "back", "left", "right"):
        box[k]["face_normals"] = True
    names = ("vertices", "bsdfs.reflectance", "emitters.radiance",
             "sensors.0.to_world")
    errs = {}
    for label, d in (("box", box), ("blocker", blocker_scene(res, spp))):
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            sc = mt.load_dict(d, device=dev)
            lv = {k: v.clone().requires_grad_(True)
                  for k, v in sc.leaves().items() if k in names}
            img = mt.render(sc.with_leaves(lv), spp=spp, seed=0, device=dev,
                            integrator={"type": "prb_reparam",
                                        "max_depth": 3})
            w = torch.linspace(0, 1, res, device=dev)[None, :, None]
            g = torch.autograd.grad((img * w).sum(), list(lv.values()))
            out[dev] = (img.detach().cpu(), [x.cpu() for x in g],
                        time.perf_counter() - t0)
        (ia, ga, ta), (ib, gb, tb) = out["cuda"], out["cpu"]
        mad, mean = float((ia - ib).abs().mean()), float(ib.mean())
        errs[label] = {k: rel_l2(a, b) for k, a, b in zip(names, ga, gb)}
        say(f"[reparam, card vs cpu] {label} {res}^2 x {spp} spp: image "
            f"mean |gpu - cpu| {mad:.3g} (limit {1e-3 * mean:.3g}); "
            "|g_gpu - g_cpu| / |g_cpu| "
            + ", ".join(f"{k} {e:.3g} (|g| {float(b.norm()):.4g})"
                        for (k, e), b in zip(errs[label].items(), gb))
            + f"  [limit 1e-3 each]; card {ta:.1f} s, cpu {tb:.1f} s")
        check(mad <= 1e-3 * mean, f"reparam {label}: card and CPU images "
              "disagree")
        for k, e in errs[label].items():
            check(e <= 1e-3, f"reparam {label}: card and CPU gradients of "
                  f"{k} differ by {e}")
    return errs


def reparam_phase():
    """[reparam]: the human run through prb_reparam at full width, the
    silhouette check, the BVH scene's pass, the card against the CPU.
    Returns the numbers and the K1-K4 launches of the phase."""
    global _TALLY
    secs, out = {}, {}
    zero_counts()
    _TALLY = {}
    try:
        for label, fn in (
                ("run", lambda: human_run("prb_reparam", RP_ITERS,
                                          reparam_expect_human, "reparam")),
                ("silhouette", reparam_silhouette),
                ("mesh pass", reparam_mesh_pass),
                ("card vs cpu", reparam_card_vs_cpu)):
            t0 = time.perf_counter()
            out[label] = fn()
            secs[label] = time.perf_counter() - t0
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    out["run"].pop("exp")
    say("[reparam] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    out["secs"] = secs
    return out


# ---------------------------------------------------------------------------
# [forward]: render_forward (forward-mode PRB) at the fwd+bwd cells' widths
# ---------------------------------------------------------------------------

def seeded_tangents(scene, names, seed):
    """A seeded normal tangent (made on the CPU, so that every device gets
    the same) for each leaf of ``names``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    leaves = scene.leaves()
    return {k: torch.randn(leaves[k].shape, generator=gen).to(scene.device)
            for k in names}


def x_ramp(scene):
    """The weight image W of the JAX package's forward-mode checks: a
    ramp over the columns, 0.25 to 1."""
    import torch
    sensor = scene.sensors[0]
    return (torch.linspace(0.25, 1.0, sensor.width,
                           device=scene.device)[None, :, None]
            * torch.ones((sensor.height, sensor.width, 3),
                         device=scene.device))


def forward_vs_backward(scene, tangents, spp, integrator, seed=FW_SEED):
    """(<dimg, W>, d/dtheta <img, W> of the backward at the same seed,
    theta moving the leaves along ``tangents``, the backward's ms)."""
    import torch
    import epsm_mitsuba3_torch as mt
    W = x_ramp(scene)
    lv = {k: scene.leaves()[k].clone().requires_grad_(True)
          for k in tangents}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = mt.render(scene.with_leaves(lv), spp=spp, seed=seed,
                    integrator=integrator)
    g = torch.autograd.grad((img * W).sum(), list(lv.values()))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (sum(float((gk * tangents[k]).sum()) for k, gk in zip(lv, g)),
            ms)


def forward_cell(label, scene, spp, integrator, tangents, expect, rtol):
    """One ``render_forward`` cell: a warm-up and a timed call, launches
    exact (``expect``: the recording primal's, and under prb_reparam the
    replay's auxiliary rays), the image tangent finite and not all zero,
    <dimg, W> against the backward's within ``rtol``; wall ms, peak
    memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for run in ("warm-up", "timed"):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dimg = mt.render_forward(scene, tangents, spp=spp, seed=FW_SEED,
                                 integrator=integrator)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        for k, n in expect.items():
            check(counts[k] == n, f"{label}: {k} launched {counts[k]} times "
                  f"in a render_forward ({run}), expected {n}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    CT.raise_on_overflow(scene.device)
    check(bool(torch.isfinite(dimg).all()), f"{label}: dimg not finite")
    check(float(dimg.abs().max()) > 0, f"{label}: dimg all zero")
    g_fwd = float((dimg * x_ramp(scene)).sum())
    g_bwd, bwd_ms = forward_vs_backward(scene, tangents, spp, integrator)
    rel = abs(g_fwd - g_bwd) / max(abs(g_bwd), 1e-30)
    sensor = scene.sensors[0]
    say(f"[forward] {label} {sensor.width}^2 x {spp} spp, "
        f"{integrator['type']}, depth {integrator['max_depth']}, tangents "
        f"on {', '.join(tangents)}: render_forward {walls[0]:.1f} ms "
        f"(warm-up), {walls[1]:.1f} ms; peak {peak:.2f} GiB; launches "
        f"{counts}; <dimg, W> {g_fwd:.8g}, backward d/dtheta <img, W> "
        f"{g_bwd:.8g} (fwd+bwd {bwd_ms:.1f} ms), relative {rel:.3g} "
        f"[limit {rtol:g}]; max |dimg| {float(dimg.abs().max()):.6g}")
    check(rel <= rtol, f"{label}: forward and backward disagree by {rel}")
    return dict(wall=walls[1], peak=peak, counts=counts, rel=rel,
                bwd_ms=bwd_ms)


def forward_card_vs_cpu(res=64, spp=4):
    """render_forward on the card against the CPU at 64^2 x 4 spp, depth
    3: the box through prb (tangents on the reflectances and the
    radiance) and through prb_reparam with face normals (the vertices and
    the sensor pose); dimg's relative L2 <= 1e-3."""
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    box = cornell_box(res=res, spp=spp, max_depth=3)
    rp_box = cornell_box(res=res, spp=spp, max_depth=3)
    for k in ("floor", "ceiling", "back", "left", "right"):
        rp_box[k]["face_normals"] = True
    errs = {}
    for label, d, kind, names in (
            ("box prb", box, "prb",
             ("bsdfs.reflectance", "emitters.radiance")),
            ("box prb_reparam", rp_box, "prb_reparam",
             ("vertices", "sensors.0.to_world"))):
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            sc = mt.load_dict(d, device=dev)
            out[dev] = (mt.render_forward(
                sc, seeded_tangents(sc, names, 11), spp=spp, seed=0,
                device=dev, integrator={"type": kind, "max_depth": 3}).cpu(),
                time.perf_counter() - t0)
        (a, ta), (b, tb) = out["cuda"], out["cpu"]
        errs[label] = rel_l2(a, b)
        say(f"[forward, card vs cpu] {label} {res}^2 x {spp} spp: |dimg_gpu "
            f"- dimg_cpu| / |dimg_cpu| {errs[label]:.3g} (|dimg| "
            f"{float(b.norm()):.4g}) [limit 1e-3]; card {ta:.1f} s, cpu "
            f"{tb:.1f} s")
        check(errs[label] <= 1e-3, f"forward {label}: card and CPU image "
              "tangents differ")
    return errs


def forward_phase():
    """[forward]: render_forward on the box (K1), the mesh (K2/K3) and the
    prb_reparam mesh pass (its auxiliary rays through K2), the card
    against the CPU.  Returns the numbers and the phase's launches."""
    global _TALLY
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh
    none = {"mt_closest_hit": 0, "mt_any_hit": 0, "bvh4_closest_hit": 0,
            "bvh4_any_hit": 0, "bvh4_closest_hit_mp": 0}
    box = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK, max_depth=DEPTH))
    mesh = mt.load_dict(blob_normals(cornell_box_mesh(
        res=RES, spp=MESH_CHUNK, max_depth=DEPTH)))
    rp_mesh = mt.load_dict(blob_normals(cornell_box_mesh(
        res=RES, spp=RP_MESH_SPP, max_depth=RP_MESH_DEPTH)))
    aux = reparam_backward_launches(RES * RES * RP_MESH_SPP, RP_MESH_DEPTH)
    cells = (
        ("box", box, SPP_CHUNK, {"type": "prb", "max_depth": DEPTH},
         ("bsdfs.reflectance", "emitters.radiance"),
         {**none, "mt_closest_hit": DEPTH, "mt_any_hit": DEPTH}, FW_RTOL),
        ("mesh", mesh, MESH_CHUNK, {"type": "prb", "max_depth": DEPTH},
         ("vertices",),
         {**none, "bvh4_closest_hit": DEPTH, "bvh4_any_hit": DEPTH},
         FW_RTOL),
        ("reparam mesh", rp_mesh, RP_MESH_SPP,
         {"type": "prb_reparam", "max_depth": RP_MESH_DEPTH}, ("vertices",),
         {**none, "bvh4_closest_hit": RP_MESH_DEPTH + aux,
          "bvh4_any_hit": RP_MESH_DEPTH}, FW_RTOL_RP))
    secs, out = {}, {}
    zero_counts()
    _TALLY = {}
    try:
        for i, (label, scene, spp, integ, names, expect, rtol) in enumerate(
                cells):
            t0 = time.perf_counter()
            out[label] = forward_cell(label, scene, spp, integ,
                                      seeded_tangents(scene, names, 7 + i),
                                      expect, rtol)
            secs[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["card vs cpu"] = forward_card_vs_cpu()
        secs["card vs cpu"] = time.perf_counter() - t0
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    say("[forward] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    out["secs"] = secs
    return out


# ---------------------------------------------------------------------------
# [direct]: direct, direct_reparam and emission_reparam
# ---------------------------------------------------------------------------

def direct_reparam_launches(lanes, num_rays=16, emitter_samples=1,
                            bsdf_samples=1, emission=False):
    """(closest, any) hit launches of one direct_reparam (or, with
    ``emission``, emission_reparam) backward: in every lane chunk of
    ``ad/prb.py`` REPARAM_CHUNK, the unwarped pass's camera, BSDF and
    shadow rays, then the attached pass's, and ``num_rays`` auxiliary
    rays at each reparameterisation site."""
    from epsm_mitsuba3_torch.ad import prb as PRB
    chunks = -(-lanes // PRB.REPARAM_CHUNK)
    if emission:
        return chunks * (2 + num_rays), 0
    sites = 1 + emitter_samples + bsdf_samples
    return (chunks * (2 * (1 + bsdf_samples) + sites * num_rays),
            chunks * 2 * emitter_samples)


def emitter_quad(res, spp):
    """The JAX package's moving-emitter scene (tests/test_reparam.py:
    117-133): a 1 x 1 area light at z = 0 facing a camera at z = 3, a box
    filter, nothing else."""
    from epsm_mitsuba3_torch.core.transform import ScalarTransform4f as T
    return {"type": "scene",
            "sensor": {"type": "perspective", "fov": 45.0,
                       "to_world": T.look_at(origin=[0, 0, 3],
                                             target=[0, 0, 0], up=[0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": res,
                                "height": res, "rfilter": {"type": "box"}},
                       "sampler": {"type": "independent",
                                   "sample_count": spp}},
            "light": {"type": "rectangle", "to_world": T.scale(0.5),
                      "emitter": {"type": "area",
                                  "radiance": {"type": "rgb", "value": 5.0}}}}


def direct_render(label, scene, spp, chunk, integrator, expect):
    """A warm-up pass and one timed render of ``spp`` in passes of
    ``chunk``, launches exact; the image finite and not flat.  Returns
    (image, wall ms)."""
    import torch
    import epsm_mitsuba3_torch as mt
    zero_counts()
    mt.render(scene, spp=chunk, seed=99, integrator=integrator)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = mt.render(scene, spp=spp, seed=0, spp_chunk=chunk,
                    integrator=integrator)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    for k, n in expect.items():
        check(counts[k] == n, f"{label}: {k} launched {counts[k]} times, "
              f"expected {n}")
    check(bool(torch.isfinite(img).all()), f"{label}: image not finite")
    check(float(img.std()) > 0, f"{label}: image flat")
    say(f"[direct] {label} {scene.sensors[0].width}^2 x {spp} spp in passes "
        f"of {chunk}, {integrator['type']}: {ms:.1f} ms; launches {counts}; "
        f"mean {float(img.mean()):.6g}")
    return img, ms


def direct_pass(label, scene, spp, integrator, names, expect_fwd,
                expect_bwd):
    """One fwd+bwd pass of a reparameterised direct integrator at full
    width, the loss mean(img^2): launches exact in the forward and the
    backward, the gradients finite and the vertices' non-zero; wall ms
    and peak memory."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    lv = {k: v.clone().requires_grad_(True)
          for k, v in scene.leaves().items() if k in names}
    sc = scene.with_leaves(lv)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = mt.render(sc, spp=spp, seed=1, integrator=integrator)
    loss = torch.mean(img ** 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = read_counts()
    zero_counts()
    grads = torch.autograd.grad(loss, list(lv.values()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bwd = read_counts()
    CT.raise_on_overflow(scene.device)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for want, got, where in ((expect_fwd, fwd, "forward"),
                             (expect_bwd, bwd, "backward")):
        for k, n in want.items():
            check(got[k] == n, f"{label}: {k} launched {got[k]} times in "
                  f"the {where}, expected {n}")
    norms = {k: float(g.norm()) for k, g in zip(lv, grads)}
    say(f"[direct] {label} {scene.sensors[0].width}^2 x {spp} spp, "
        f"{integrator['type']}, {scene.faces.shape[0]} triangles: forward "
        f"{(t1 - t0) * 1e3:.1f} ms, backward {(t2 - t1) * 1e3:.1f} ms; "
        f"launches forward {fwd}, backward {bwd}; |grad| "
        + ", ".join(f"{k} {v:.4g}" for k, v in norms.items())
        + f"; peak {peak:.2f} GiB")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          f"{label}: gradients not finite")
    check(norms["vertices"] > 0, f"{label}: no vertex gradient")
    return dict(fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3, peak=peak,
                fwd=fwd, bwd=bwd)


def silhouette(label, d, shape, kinds, fd_kind, fd_spp, spp=64, eps=0.05):
    """d/ddx of sum(img * ramp) at dx = 0, ``shape`` moved by dx in x, for
    each integrator of ``kinds`` (autograd) and by a central difference of
    ``fd_kind`` at ``fd_spp``."""
    import torch
    import epsm_mitsuba3_torch as mt
    sc0 = mt.load_dict(d)
    s, c = sc0.static.vertex_ranges[sc0.static.shape_names.index(shape)]
    mask = torch.zeros_like(sc0.vertices)
    mask[s:s + c, 0] = 1.0
    res = sc0.sensors[0].width
    ramp = torch.linspace(0, 1, res, device=sc0.device)[None, :, None]

    def loss(dx, kind, n):
        sc = sc0.with_leaves({"vertices": sc0.vertices + dx * mask})
        return torch.sum(mt.render(sc, spp=n, seed=0,
                                   integrator={"type": kind}) * ramp)

    with torch.no_grad():
        fd = float(loss(eps, fd_kind, fd_spp)
                   - loss(-eps, fd_kind, fd_spp)) / (2 * eps)
    g = {}
    for kind in kinds:
        dx = torch.zeros((), device=sc0.device, requires_grad=True)
        zero_counts()
        t0 = time.perf_counter()
        (gk,) = torch.autograd.grad(loss(dx, kind, spp), dx)
        torch.cuda.synchronize()
        g[kind] = float(gk)
        say(f"[direct] silhouette {label} {kind}: d/ddx {g[kind]:.6g} "
            f"(g / fd {g[kind] / fd if fd else float('nan'):.3g}), "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms, launches "
            f"{read_counts()}")
    say(f"[direct] silhouette {label} {res}^2 x {spp} spp: fd ({fd_kind}, "
        f"{fd_spp} spp, eps {eps}) {fd:.6g}")
    return fd, g


def direct_silhouettes():
    """The JAX package's checks (tests/test_reparam.py:78-157) on the
    card: plain direct misses the blocker's moving shadow edge (|g| < 0.1
    |fd|), direct_reparam lies within 0.3-3 times the finite difference,
    of its sign; emission_reparam has the sign of the moving light's
    finite difference."""
    from epsm_mitsuba3_torch.scenes import blocker_scene
    fd, g = silhouette("blocker", blocker_scene(res=24, spp=16), "blocker",
                       ("direct", "direct_reparam"), "direct",
                       DI_SIL_FD_SPP)
    ratio = g["direct_reparam"] / fd
    say(f"[direct] silhouette blocker: direct {g['direct']:.6g} (|g| / "
        f"|fd| {abs(g['direct'] / fd):.3g}, limit < 0.1); direct_reparam "
        f"g / fd {ratio:.3g} (limits 0.3-3)")
    check(abs(g["direct"]) < 0.1 * abs(fd), "silhouette: plain direct "
          "should miss the moving shadow edge")
    check(0.3 <= ratio <= 3.0, "silhouette: direct_reparam's gradient is "
          "not within 0.3-3 times the finite difference, of its sign")
    fd_em, g_em = silhouette("light", emitter_quad(24, 16), "light",
                             ("emission_reparam",), "emission_reparam",
                             DI_EM_FD_SPP)
    r_em = g_em["emission_reparam"] / fd_em
    say(f"[direct] silhouette light: emission_reparam g / fd {r_em:.3g} "
        "(limit: the sign of fd)")
    check(r_em > 0, "silhouette: emission_reparam's gradient does not have "
          "the finite difference's sign")
    return dict(fd=fd, direct=g["direct"], direct_reparam=g["direct_reparam"],
                fd_em=fd_em, emission_reparam=g_em["emission_reparam"])


def direct_card_vs_cpu(res=64, spp=4):
    """The card against the CPU at 64^2 x 4 spp on the box with face
    normals: direct's image, and direct_reparam's and emission_reparam's
    images and gradients of the vertices, reflectances, radiance and
    sensor pose (images <= 1e-3 x mean, gradients relative L2 <= 1e-3
    each; emission_reparam gives the reflectances none)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    box = cornell_box(res=res, spp=spp)
    for k in ("floor", "ceiling", "back", "left", "right"):
        box[k]["face_normals"] = True
    names = ("vertices", "bsdfs.reflectance", "emitters.radiance",
             "sensors.0.to_world")
    errs = {}
    for kind in ("direct", "direct_reparam", "emission_reparam"):
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            sc = mt.load_dict(box, device=dev)
            lv = {k: v.clone().requires_grad_(True)
                  for k, v in sc.leaves().items() if k in names}
            img = mt.render(sc.with_leaves(lv), spp=spp, seed=0, device=dev,
                            integrator={"type": kind})
            w = torch.linspace(0, 1, res, device=dev)[None, :, None]
            g = ([] if kind == "direct" else torch.autograd.grad(
                (img * w).sum(), list(lv.values())))
            out[dev] = (img.detach().cpu(), [x.cpu() for x in g],
                        time.perf_counter() - t0)
        (ia, ga, ta), (ib, gb, tb) = out["cuda"], out["cpu"]
        mad, mean = float((ia - ib).abs().mean()), float(ib.mean())
        errs[kind] = {k: rel_l2(a, b) for k, a, b in zip(names, ga, gb)
                      if float(b.norm()) > 0}
        say(f"[direct, card vs cpu] {kind} {res}^2 x {spp} spp: image mean "
            f"|gpu - cpu| {mad:.3g} (limit {1e-3 * mean:.3g}); "
            "|g_gpu - g_cpu| / |g_cpu| "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs[kind].items())
            + f"  [limit 1e-3 each]; card {ta:.1f} s, cpu {tb:.1f} s")
        check(mad <= 1e-3 * mean, f"{kind}: card and CPU images disagree")
        for k, e in errs[kind].items():
            check(e <= 1e-3, f"{kind}: card and CPU gradients of {k} differ "
                  f"by {e}")
        if kind != "direct":
            check(len(errs[kind]) >= 3, f"{kind}: too few non-zero "
                  "gradients")
    return errs


def direct_phase():
    """[direct]: direct on the box (K1) and the mesh (K2/K3) at 512^2, the
    box against path at depth 2; a direct_reparam fwd+bwd pass of the
    mesh and an emission_reparam pass of the box at full width; the
    silhouette checks; the card against the CPU.  Returns the numbers and
    the phase's launches."""
    global _TALLY
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh
    none = {"mt_closest_hit": 0, "mt_any_hit": 0, "bvh4_closest_hit": 0,
            "bvh4_any_hit": 0, "bvh4_closest_hit_mp": 0}
    lanes = RES * RES * DI_MESH_SPP
    secs, out = {}, {}
    zero_counts()
    _TALLY = {}
    try:
        t0 = time.perf_counter()
        box = mt.load_dict(cornell_box(res=RES, spp=DI_BOX_SPP))
        n_box = DI_BOX_SPP // SPP_CHUNK
        img_d, ms_d = direct_render(
            "box", box, DI_BOX_SPP, SPP_CHUNK, {"type": "direct"},
            {**none, "mt_closest_hit": 2 * n_box, "mt_any_hit": n_box})
        img_p, ms_p = direct_render(
            "box", box, DI_BOX_SPP, SPP_CHUNK,
            {"type": "path", "max_depth": 2},
            {**none, "mt_closest_hit": 2 * n_box, "mt_any_hit": 2 * n_box})
        rel = abs(float(img_d.mean() - img_p.mean())) / float(img_p.mean())
        say(f"[direct] box: mean direct {float(img_d.mean()):.6g}, path at "
            f"depth 2 {float(img_p.mean()):.6g}: relative {rel:.3g} [limit "
            f"{DI_PATH_REL}]")
        check(rel < DI_PATH_REL, "direct and path at depth 2 disagree")
        mesh = mt.load_dict(blob_normals(cornell_box_mesh(
            res=RES, spp=MESH_CHUNK)))
        n_mesh = DI_MESH_SPP // MESH_CHUNK
        _, ms_m = direct_render(
            "mesh", mesh, DI_MESH_SPP, MESH_CHUNK, {"type": "direct"},
            {**none, "bvh4_closest_hit": 2 * n_mesh,
             "bvh4_any_hit": n_mesh})
        out["renders"] = dict(box_ms=ms_d, path_ms=ms_p, mesh_ms=ms_m,
                              rel=rel)
        secs["renders"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ch, an = direct_reparam_launches(lanes)
        out["direct_reparam mesh"] = direct_pass(
            "direct_reparam mesh", mesh, DI_MESH_SPP,
            {"type": "direct_reparam"}, TRAIN_LEAVES,
            {**none, "bvh4_closest_hit": 2, "bvh4_any_hit": 1},
            {**none, "bvh4_closest_hit": ch, "bvh4_any_hit": an})
        del mesh
        box_fn = cornell_box(res=RES, spp=DI_MESH_SPP)
        for k in ("floor", "ceiling", "back", "left", "right"):
            box_fn[k]["face_normals"] = True
        ch, _ = direct_reparam_launches(lanes, emission=True)
        out["emission_reparam box"] = direct_pass(
            "emission_reparam box", mt.load_dict(box_fn), DI_MESH_SPP,
            {"type": "emission_reparam"},
            ("vertices", "emitters.radiance", "sensors.0.to_world"),
            {**none, "mt_closest_hit": 1}, {**none, "mt_closest_hit": ch})
        secs["passes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["silhouettes"] = direct_silhouettes()
        secs["silhouettes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["card vs cpu"] = direct_card_vs_cpu()
        secs["card vs cpu"] = time.perf_counter() - t0
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    say("[direct] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    out["secs"] = secs
    return out

# ---------------------------------------------------------------------------
# [outputs]: depth, aov, moment, ptracer and the spectral family
# ---------------------------------------------------------------------------

def output_render(label, scene, spp, chunk, integrator, expect, seed=0):
    """A warm-up pass and one timed render of ``spp`` in passes of
    ``chunk``, launches exact, the image finite.  Returns (image, wall
    ms, peak GiB)."""
    import torch
    import epsm_mitsuba3_torch as mt
    zero_counts()
    mt.render(scene, spp=chunk, seed=99, integrator=integrator)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = mt.render(scene, spp=spp, seed=seed, spp_chunk=chunk,
                    integrator=integrator)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = read_counts()
    for k, n in expect.items():
        check(counts[k] == n, f"{label}: {k} launched {counts[k]} times, "
              f"expected {n}")
    check(bool(torch.isfinite(img).all()), f"{label}: image not finite")
    say(f"[outputs] {label} {scene.sensors[0].width}^2 x {spp} spp in "
        f"passes of {chunk}, {integrator}: {ms:.1f} ms; peak {peak:.2f} "
        f"GiB; launches {counts}; image {tuple(img.shape)}, mean "
        f"{float(img.mean()):.6g}")
    return img, ms, peak


def connection_rays(scene, spp, depth, module):
    """The arguments of every any-hit call one ptracer pass of ``scene``
    (``spp`` spp, ``max_depth`` ``depth``) makes through ``module``
    (cuda_intersect or cuda_traverse): the camera connections of the
    emitter vertices, then of each bounce's."""
    import torch
    import epsm_mitsuba3_torch as mt
    with torch.no_grad():
        rec = _record_rays(module, ("any_hit",), lambda: mt.render(
            scene, spp=spp, seed=5,
            integrator={"type": "ptracer", "max_depth": depth}))
    torch.cuda.synchronize()
    check(len(rec["any_hit"]) == depth, f"a ptracer pass made "
          f"{len(rec['any_hit'])} any-hit calls, expected {depth}")
    return rec["any_hit"]


def _row(d, n, live, ms, bound, by, plain_rays, plain_ms):
    return dict(depth=d, rays=n, live=live, ms=ms, bound_ms=bound,
                bound_by=by, plain_rays=plain_rays, plain_ms=plain_ms)


def connection_rays_k1(quad):
    """K1's any hit on the camera-connection rays of one ptracer pass of
    the quad (512^2 x SPP_CHUNK spp, depth 2): each call bit for bit the
    plain version on all its rays, timed on the device alone beside its
    bound (each live ray's tests up to its first hit) and the plain
    version."""
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import intersect as I
    out = []
    for d, (args, _) in enumerate(connection_rays(quad, SPP_CHUNK, 2, CI)):
        tri, o, dd, maxt = args
        got = CI.any_hit(tri, o, dd, maxt)
        ref, plain_ms = timed(lambda: I.ray_test_brute(tri, o, dd, maxt))
        n_diff = int((got != ref).sum())
        check(n_diff == 0, f"ptracer connections {d}: K1's any hit differs "
              f"from the plain version on {n_diff} rays")
        ms = device_ms(lambda: CI.any_hit(tri, o, dd, maxt), 10)
        b, by = k1_bound(tri, o, dd, maxt, True)
        live = int((maxt > 1e-6).sum())
        out.append(_row(d, o.shape[0], live, ms, b, by, o.shape[0],
                        plain_ms))
        say(f"[outputs rays K1] ptracer connections {d}: {tri.shape[0]} "
            f"tris x {o.shape[0]} rays ({live} live, {int(got.sum())} "
            f"occluded): any {ms:.4f} ms (bound {b:.4f} by {by}, "
            f"{b / ms:.1%}); plain {plain_ms:.1f} ms; bit for bit equal")
    return out


def connection_rays_k3(mesh):
    """K3 on the camera-connection rays of one ptracer pass of the mesh
    (512^2 x MESH_CHUNK spp, depth 6): the first OUT_K3_DEPTHS calls held
    bit for bit against the plain version on OUT_SUBSET rays, timed on
    the device alone beside the bound from the plain version's work on
    all of them."""
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import traverse as TR
    calls = connection_rays(mesh, MESH_CHUNK, DEPTH, CT)
    nodes, tri = mesh.bvh_nodes, mesh.bvh_tris
    out = []
    for d, (args, kw) in enumerate(calls[:OUT_K3_DEPTHS]):
        o, dd, maxt = args[2:5]
        got = CT.any_hit(nodes, tri, o, dd, maxt, **kw)
        CT.raise_on_overflow(mesh.device)
        k = slice(0, OUT_SUBSET)
        ref, plain_ms = timed(lambda: TR.bvh_ray_test_plain(
            nodes, tri, o[k], dd[k], maxt[k]))
        n_diff = int((got[k] != ref).sum())
        check(n_diff == 0, f"ptracer connections {d}: K3 differs from the "
              f"plain version on {n_diff} rays")
        ms = device_ms(lambda: CT.any_hit(nodes, tri, o, dd, maxt, **kw), 10)
        b, by = bound_ms(*bvh_work(maxt, bvh_plain_work(
            nodes, tri, o, dd, maxt, True), True))
        live = int((maxt > 1e-6).sum())
        out.append(_row(d, o.shape[0], live, ms, b, by, OUT_SUBSET,
                        plain_ms))
        say(f"[outputs rays K3] ptracer connections {d}: {tri.shape[0]} "
            f"tris, {o.shape[0]} rays ({live} live, {int(got.sum())} "
            f"occluded): K3 {ms:.4f} ms (bound {b:.4f} by {by}, "
            f"{b / ms:.1%}); plain on {OUT_SUBSET} of them {plain_ms:.1f} "
            "ms; bit for bit equal there")
    return out


def fit_share(fn):
    """The sigmoid fit's share of one spectral pass ``fn``: the pass under
    torch.profiler (device activity only: host events would take the
    profiler seconds to collect), its ``core/spectral.py``
    ``fit_reflectance`` inputs kept, then those fits alone under the
    profiler; the share is their device busy time over the pass's.
    Returns a dict, or None where the profiler saw no device time."""
    from epsm_mitsuba3_torch.core import spectral as SP
    fit, inputs = SP.fit_reflectance, []

    def keep(rgb):
        inputs.append(rgb.clone())
        return fit(rgb)

    SP.fit_reflectance = keep
    try:
        prof = profile_pass("spectral pass", fn, ("mt_",), cpu=False,
                            table=False)
    finally:
        SP.fit_reflectance = fit
    alone = profile_pass(f"the pass's {len(inputs)} fits alone",
                         lambda: [fit(x) for x in inputs], ("gemm",),
                         cpu=False, table=False)
    if prof is None or alone is None:
        return None
    share = alone["busy"] / prof["busy"]
    say(f"[outputs] fit share of one spectral pass: {len(inputs)} fits, "
        f"{alone['busy']:.2f} ms of the pass's {prof['busy']:.2f} ms device "
        f"busy ({share:.1%}); the pass's wall {prof['wall']:.1f} ms")
    return dict(fits=len(inputs), fit_ms=alone["busy"],
                busy_ms=prof["busy"], wall_ms=prof["wall"],
                launches=prof["launches"], fit_launches=alone["launches"])


def gray_box(res, spp):
    """cornell_box with every wall grey (the JAX package's
    tests/test_spectral.py:40-46)."""
    from epsm_mitsuba3_torch.scenes import cornell_box
    d = cornell_box(res=res, spp=spp, max_depth=4)
    for v in d.values():
        if isinstance(v, dict) and "bsdf" in v:
            v["bsdf"]["reflectance"]["value"] = [0.5, 0.5, 0.5]
    return d


#: the seven types held card against CPU, with their settings
OUTPUT_KINDS = (("depth", {}), ("aov", {"max_depth": 2}),
                ("moment", {"max_depth": 4}), ("ptracer", {"max_depth": 3}),
                ("spectral", {"max_depth": 3}),
                ("spectral_mono", {"max_depth": 3}),
                ("spectral_spec", {"max_depth": 3, "n_bins": 8}))


def outputs_card_vs_cpu(res=64, spp=2):
    """The box at 64^2 x 2 spp through each of the seven types on the card
    and on the CPU: images within 1e-3 x the mean on average, the
    particle tracer's film within 1e-5 of its largest entry (a
    scatter-add with float atomics on the card, as ``splat``)."""
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    d = cornell_box(res=res, spp=spp)
    out = {}
    for kind, extra in OUTPUT_KINDS:
        integ = {"type": kind, **extra}
        ia, ib = (mt.render(mt.load_dict(d, device=dev), spp=spp, seed=0,
                            device=dev, integrator=integ).cpu()
                  for dev in ("cuda", "cpu"))
        diff = (ia - ib).abs()
        mad, mean, mx = float(diff.mean()), float(ib.abs().mean()), float(
            diff.max())
        out[kind] = dict(mean_abs=mad, max_abs=mx)
        if kind == "ptracer":
            lim = 1e-5 * float(ib.abs().max())
            ok = mx <= lim
            bar = f"max |gpu - cpu| {mx:.3g} (limit {lim:.3g})"
        else:
            ok = mad <= 1e-3 * mean
            bar = f"mean |gpu - cpu| {mad:.3g} (limit {1e-3 * mean:.3g})"
        say(f"[outputs, card vs cpu] {kind} {res}^2 x {spp} spp "
            f"{tuple(ia.shape)}: {bar}")
        check(ok and bool(ia.isfinite().all()),
              f"{kind}: card and CPU images disagree")
    return out


def outputs_phase():
    """[outputs]: depth, aov, moment (and the Z-test), ptracer and the
    spectral family at full width through K1, K2 and K3, launches exact,
    the JAX package's bars, K1 and K3 on ptracer's connection rays, the
    fit's share, the card against the CPU.  Returns the numbers and the
    phase's launches."""
    global _TALLY
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import (cornell_box, cornell_box_mesh,
                                            single_quad_direct)
    from epsm_mitsuba3_torch.utils.image import render_z_test
    none = {"mt_closest_hit": 0, "mt_any_hit": 0, "bvh4_closest_hit": 0,
            "bvh4_any_hit": 0, "bvh4_closest_hit_mp": 0}
    n4, n16 = OUT_SPP // SPP_CHUNK, SPP // SPP_CHUNK
    lo, hi = OUT_DEPTH
    secs, out = {}, {}
    zero_counts()
    _TALLY = {}
    try:
        t0 = time.perf_counter()
        box = mt.load_dict(cornell_box(res=RES, spp=OUT_SPP))
        img, ms, peak = output_render(
            "depth box", box, OUT_SPP, SPP_CHUNK, {"type": "depth"},
            {**none, "mt_closest_hit": n4})
        c = float(img[RES // 2, RES // 2, 0])
        img_a, ms_a, peak_a = output_render(
            "aov box", box, OUT_SPP, SPP_CHUNK,
            {"type": "aov", "max_depth": 2},
            {**none, "mt_closest_hit": 3 * n4, "mt_any_hit": 2 * n4})
        ca = float(img_a[RES // 2, RES // 2, 3])
        say(f"[outputs] centre depth: depth {c:.6g}, aov {ca:.6g} (limits "
            f"{lo}-{hi}); aov channels {img_a.shape[-1]}")
        check(lo < c < hi and lo < ca < hi, "centre depth out of range")
        check(img_a.shape[-1] == 13 and float(img.std()) > 0,
              "aov channels or a flat depth")
        mesh = mt.load_dict(cornell_box_mesh(res=RES, spp=MESH_CHUNK,
                                             max_depth=DEPTH))
        _, ms_dm, _ = output_render(
            "depth mesh", mesh, MESH_SPP, MESH_CHUNK, {"type": "depth"},
            {**none, "bvh4_closest_hit": MESH_SPP // MESH_CHUNK})
        out["depth aov"] = dict(depth_ms=ms, depth_peak=peak, aov_ms=ms_a,
                                aov_peak=peak_a, centre=c, mesh_ms=ms_dm)
        secs["depth aov"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        box_m = mt.load_dict(cornell_box(res=RES, spp=SPP, max_depth=4))
        img_m, ms_m, peak_m = output_render(
            "moment box", box_m, SPP, SPP_CHUNK,
            {"type": "moment", "max_depth": 4},
            {**none, "mt_closest_hit": 4 * n16, "mt_any_hit": 4 * n16})
        var_min = float((img_m[..., 3:] - img_m[..., :3] ** 2).min())
        path = mt.render(box_m, spp=SPP, seed=0, spp_chunk=SPP_CHUNK,
                         integrator={"type": "path", "max_depth": 4})
        d_path = float((img_m[..., :3] - path).abs().max())
        ref = mt.render(box_m, spp=SPP, seed=1, spp_chunk=SPP_CHUNK,
                        integrator={"type": "path", "max_depth": 4})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t1 = time.perf_counter()
        passed, p_min, fails = render_z_test(box_m, spp=SPP, seed=0,
                                             max_depth=4, reference=ref)
        ms_z = (time.perf_counter() - t1) * 1e3
        peak_z = torch.cuda.max_memory_allocated() / 2 ** 30
        counts_z = read_counts()
        say(f"[outputs] moment: var min {var_min:.3g} (limit >= -1e-4); "
            f"mean vs path at the same seed max |diff| {d_path:.3g} (limit "
            f"{1e-4 * float(path.max()):.3g}); render_z_test, one "
            f"{SPP}-spp pass against path at seed 1: {ms_z:.1f} ms, peak "
            f"{peak_z:.2f} GiB, launches {counts_z}; passed {passed}, "
            f"least p {p_min:.3g}, fail fraction {fails:.4%} (limit < 1 %)")
        check(var_min >= -1e-4, "moment: second moment below mean^2")
        check(d_path <= 1e-4 * float(path.max()),
              "moment's mean and path's image differ")
        check(fails < 0.01, "render_z_test: too many pixels fail")
        check(counts_z["mt_closest_hit"] == 4 and counts_z["mt_any_hit"] == 4,
              f"render_z_test launched {counts_z}")
        out["moment"] = dict(ms=ms_m, peak=peak_m, var_min=var_min,
                             path_diff=d_path, z_ms=ms_z, z_peak=peak_z,
                             z_fail=fails, z_passed=passed)
        del box_m, img_m, path, ref
        secs["moment"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        quad = mt.load_dict(single_quad_direct(res=RES, spp=OUT_SPP))
        img_q, ms_q, peak_q = output_render(
            "ptracer quad", quad, OUT_SPP, SPP_CHUNK,
            {"type": "ptracer", "max_depth": 2},
            {**none, "mt_closest_hit": n4, "mt_any_hit": 2 * n4})
        path_q = mt.render(quad, spp=OUT_SPP, seed=0, spp_chunk=SPP_CHUNK,
                           integrator={"type": "path", "max_depth": 2})
        rel_q = abs(float(img_q.mean() - path_q.mean())) / float(
            path_q.mean())
        say(f"[outputs] ptracer quad: mean {float(img_q.mean()):.6g}, path "
            f"at depth 2 {float(path_q.mean()):.6g}: relative {rel_q:.3g} "
            f"[limit {OUT_PT_REL}]")
        check(rel_q < OUT_PT_REL, "ptracer and path disagree on the quad")
        conn_k1 = connection_rays_k1(quad)
        img_pm, ms_pm, peak_pm = output_render(
            "ptracer mesh", mesh, MESH_CHUNK, MESH_CHUNK,
            {"type": "ptracer", "max_depth": DEPTH},
            {**none, "bvh4_closest_hit": DEPTH - 1, "bvh4_any_hit": DEPTH})
        check(float(img_pm.std()) > 0, "ptracer mesh: image flat")
        conn_k3 = connection_rays_k3(mesh)
        out["ptracer"] = dict(quad_ms=ms_q, quad_peak=peak_q, rel=rel_q,
                              mesh_ms=ms_pm, mesh_peak=peak_pm,
                              k1_rays=conn_k1, k3_rays=conn_k3)
        del mesh
        secs["ptracer"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        gray = mt.load_dict(gray_box(RES, OUT_SPP))
        spec = {**none, "mt_closest_hit": 4 * n4, "mt_any_hit": 4 * n4}
        img_s, ms_s, peak_s = output_render(
            "spectral gray box", gray, OUT_SPP, SPP_CHUNK,
            {"type": "spectral", "max_depth": 4}, spec)
        rgb = mt.render(gray, spp=OUT_SPP, seed=0, spp_chunk=SPP_CHUNK,
                        integrator={"type": "path", "max_depth": 4})
        rel_s = abs(float(img_s.mean() - rgb.mean())) / float(rgb.mean())
        img_mo, ms_mo, _ = output_render(
            "spectral_mono gray box", gray, OUT_SPP, SPP_CHUNK,
            {"type": "spectral_mono", "max_depth": 4}, spec)
        lum = rgb @ torch.tensor([0.2126, 0.7152, 0.0722], device=rgb.device)
        rel_mo = abs(float(img_mo.mean() - lum.mean())) / float(lum.mean())
        img_sp, ms_sp, _ = output_render(
            "spectral_spec box", box, OUT_SPP, SPP_CHUNK,
            {"type": "spectral_spec", "max_depth": 4, "n_bins": 8}, spec)
        band = img_sp[:, RES * 2 // 24:RES * 3 // 24].mean((0, 1))
        long_e, short_e = float(band[4:6].sum()), float(band[1:3].sum())
        say(f"[outputs] spectral: mean {float(img_s.mean()):.6g} against "
            f"the RGB render's {float(rgb.mean()):.6g}, relative "
            f"{rel_s:.3g} [limit {OUT_SPEC_REL}]; mono "
            f"{float(img_mo.mean()):.6g} against the luminance "
            f"{float(lum.mean()):.6g}, relative {rel_mo:.3g} [limit "
            f"{OUT_MONO_REL}]; spec ({img_sp.shape[-1]} bins) on the red "
            f"wall: long {long_e:.6g}, short {short_e:.6g} [long > short]")
        check(rel_s < OUT_SPEC_REL, "spectral and RGB renders disagree")
        check(rel_mo < OUT_MONO_REL, "spectral_mono and luminance disagree")
        check(img_sp.shape[-1] == 8 and long_e > short_e,
              "spectral_spec: the red wall is not red")
        fit = fit_share(lambda: mt.render(gray, spp=SPP_CHUNK, seed=7,
                                          integrator={"type": "spectral",
                                                      "max_depth": 4}))
        out["spectral"] = dict(ms=ms_s, pass_ms=ms_s / n4, peak=peak_s,
                               rel=rel_s, mono_ms=ms_mo, mono_rel=rel_mo,
                               spec_ms=ms_sp, long=long_e, short=short_e,
                               fit=fit)
        del gray, box
        secs["spectral"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        out["card vs cpu"] = outputs_card_vs_cpu()
        secs["card vs cpu"] = time.perf_counter() - t0
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    say("[outputs] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    out["secs"] = secs
    return out


# ---------------------------------------------------------------------------
# [plugins]: the analytic sphere, the measured BSDF, the numpy-built BVH,
# the double variant and the six plugin registries
# ---------------------------------------------------------------------------

#: the analytic sphere of the [plugins] box: on the floor, left of centre
PL_BALL = {"type": "sphere", "analytic": True, "radius": 0.3,
           "center": [-0.35, 0.3, 0.2],
           "bsdf": {"type": "diffuse",
                    "reflectance": {"type": "rgb", "value": [0.2, 0.4, 0.8]}}}
#: the synthetic measured material (the JAX package's
#: tests/test_measured.py:38-95 ``_synth_bsdf``): Beckmann alpha 0.3
PL_ALPHA = 0.3
#: spp of the mesh, double and registry renders (passes of SPP_CHUNK, the
#: mesh's of MESH_CHUNK); the chi-square draws; K2/K3 held on this many
#: of the numpy tree's rays; the double variant's bar (JAX's own,
#: tests/test_double_variant.py:62)
PL_SPP, PL_CHI2_DRAWS, PL_SUBSET, PL_DOUBLE_REL = 16, 2 ** 20, 2 ** 18, 2e-3
#: the reference's FD check (tests/test_quadric.py:107): its ball lit by
#: a rectangle at 512^2 x 4 spp, prb depth 2, eps 1e-2
PL_FD_SPP, PL_FD_EPS = 4, 1e-2
#: the phong exponent of the registered BSDF (tests/test_register_bsdf.py)
PL_PHONG = 8.0


def _beckmann_d(theta_m):
    import numpy as np
    c2 = np.cos(theta_m) ** 2
    t2 = np.tan(theta_m) ** 2
    return np.exp(-t2 / PL_ALPHA ** 2) / (np.pi * PL_ALPHA ** 2 * c2 ** 2)


def _beckmann_sigma(theta_i):
    import numpy as np
    tm = np.linspace(0, np.pi / 2 - 1e-3, 256)
    pm = np.linspace(0, 2 * np.pi, 128, endpoint=False)
    TM, PM = np.meshgrid(tm, pm, indexing="ij")
    m_ = np.stack([np.sin(TM) * np.cos(PM), np.sin(TM) * np.sin(PM),
                   np.cos(TM)], -1)
    dA = (tm[1] - tm[0]) * (pm[1] - pm[0])
    out = []
    for ti in np.atleast_1d(theta_i):
        wi = np.array([np.sin(ti), 0, np.cos(ti)])
        out.append(np.sum(_beckmann_d(TM) * np.clip(m_ @ wi, 0, None)
                          * np.sin(TM)) * dA)
    return np.asarray(out)


def synth_measured(path):
    """An RGL tensor file of an analytic Beckmann material, as the JAX
    package's tests write it (no RGL download)."""
    import numpy as np
    from epsm_mitsuba3_torch.models import measured as MT
    res_t, res_p = 64, 16
    u_t = np.linspace(0, 1, res_t)
    theta_m = (u_t ** 2) * (np.pi / 2)
    theta_i = np.asarray([0.0, 0.35, 0.7, 1.0, 1.3], np.float32)
    ndf = np.tile(_beckmann_d(theta_m)[None, :], (res_p, 1))
    sigma = np.tile(_beckmann_sigma(theta_m)[None, :], (res_p, 1))
    vndf = np.zeros((1, len(theta_i), res_p, res_t), np.float32)
    phis = np.linspace(-np.pi, np.pi, res_p)
    for k, ti in enumerate(theta_i):
        wi = np.array([np.sin(ti), 0, np.cos(ti)])
        TM, PM = np.meshgrid(theta_m, phis, indexing="xy")
        m_ = np.stack([np.sin(TM) * np.cos(PM), np.sin(TM) * np.sin(PM),
                       np.cos(TM)], -1)
        jac = np.sin(TM) * (np.pi * np.maximum(u_t[None, :], 1e-3))
        vndf[0, k] = _beckmann_d(TM) * np.clip(m_ @ wi, 0, None) * jac
    MT.write_tensor_file(path, {
        "theta_i": theta_i, "phi_i": np.asarray([0.0], np.float32),
        "ndf": ndf, "sigma": sigma, "vndf": vndf,
        "spectra": np.full((1, len(theta_i), 4, res_p, res_t), 0.8),
        "luminance": np.ones((1, len(theta_i), res_p, res_t)),
        "wavelengths": np.linspace(400, 700, 4),
        "jacobian": np.asarray([1], np.uint8)})


def plugins_box(measured, res, spp, ball=True):
    """cornell_box with the analytic sphere and a measured back wall."""
    from epsm_mitsuba3_torch.scenes import cornell_box
    d = cornell_box(res=res, spp=spp, max_depth=DEPTH)
    d["back"]["bsdf"] = {"type": "measured", "filename": measured}
    if ball:
        d["ball"] = dict(PL_BALL)
    return d


def ball_scene(res):
    """The JAX package's tests/test_quadric.py ``_ball_scene``: a
    sphere lit by a rectangle light."""
    import epsm_mitsuba3_torch as mt
    T = mt.ScalarTransform4f
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 30,
                   "to_world": T.look_at(origin=[0, 0.35, 1.2],
                                         target=[0, 0.35, 0], up=[0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res,
                            "height": res}},
        "light": {"type": "rectangle",
                  "to_world": T.look_at(origin=[1.2, 1.2, 1.2],
                                        target=[0, 0.35, 0], up=[0, 1, 0])
                  .scale([0.4, 0.4, 1.0]),
                  "emitter": {"type": "area", "radiance": {
                      "type": "rgb", "value": [8.0] * 3}}},
        "ball": {"type": "sphere", "radius": 0.35, "center": [0, 0.35, 0],
                 "analytic": True,
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "rgb", "value": [0.5] * 3}}}}


def plugin_render(label, scene, spp, chunk, expect, integrator=None,
                  seed=0):
    """One render of ``spp`` in passes of ``chunk``, the counts set to 0
    before and read after, each as ``expect`` says; the image finite.
    Returns (image, wall ms, counts)."""
    import torch
    import epsm_mitsuba3_torch as mt
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = mt.render(scene, spp=spp, seed=seed, spp_chunk=chunk,
                    integrator=integrator)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    say(f"[plugins] {label}: {scene.sensors[0].width}^2 x {spp} spp in "
        f"passes of {chunk}: {ms:.1f} ms; launches {counts}; dtype "
        f"{img.dtype}, mean {float(img.mean()):.6g}")
    for k, n in expect.items():
        check(counts[k] == n, f"{label}: {k} launched {counts[k]} times, "
              f"expected {n}")
    check(bool(torch.isfinite(img).all()), f"{label}: image not finite")
    return img, ms, counts


def bsdf_chi2(label, sample, pdf, device, draws=PL_CHI2_DRAWS, res=31):
    """The chi-square test (``utils/chi2.py``) of a BSDF's sampling on
    ``draws`` draws on the card, at the reference's 1 % level."""
    from epsm_mitsuba3_torch.utils.chi2 import ChiSquareTest, SphericalDomain
    t0 = time.perf_counter()
    test = ChiSquareTest(SphericalDomain(), sample, pdf, sample_count=draws,
                         res=res, ires=8, device=device)
    ok = test.run()
    say(f"[plugins] chi2 {label}, {draws} draws: {test.messages} "
        f"[pass: p > 0.01] in {time.perf_counter() - t0:.1f} s")
    check(ok, f"{label}: chi-square test failed ({test.messages})")
    return dict(p=test.p_value, message=test.messages)


def slot_chi2(scene, kind, label, res=31):
    """The sampling of the scene's first BSDF slot of ``kind`` against its
    pdf, both through the BSDF table's dispatch (``B.sample`` /
    ``B.eval_pdf`` on the scene's kinds)."""
    import torch
    from epsm_mitsuba3_torch.models import bsdf as B
    dev = scene.device
    slot = int((scene.bsdfs["kind"] == kind).nonzero()[0])
    wi0 = torch.tensor([0.3, -0.2, 0.933], device=dev)
    wi0 = wi0 / wi0.norm()
    tex = scene.bsdf_textures()
    gen = torch.Generator(device=dev).manual_seed(3)
    kinds = scene.static.bsdf_kinds

    def lanes(n):
        return (torch.full((n,), slot, dtype=torch.int32, device=dev),
                wi0.expand(n, 3).contiguous(),
                torch.zeros((n, 2), device=dev))

    def sample(n):
        idx, wi, uv = lanes(n)
        bs, _, ok = B.sample(scene.bsdfs, kinds, idx, wi,
                             torch.rand(n, generator=gen, device=dev),
                             torch.rand((n, 2), generator=gen, device=dev),
                             textures=tex, uv=uv)
        return bs.wo[ok]

    def pdf(dirs):
        wo = dirs.reshape(-1, 3)
        idx, wi, uv = lanes(wo.shape[0])
        return B.eval_pdf(scene.bsdfs, kinds, idx, wi, wo, textures=tex,
                          uv=uv)[1].reshape(dirs.shape[:-1])

    return bsdf_chi2(label, sample, pdf, dev, res=res)


def measured_chi2(scene):
    """The measured slot's GGX-proxy sampling against its pdf."""
    from epsm_mitsuba3_torch.models import bsdf as B
    return slot_chi2(scene, B.KIND_MEASURED, "measured slot (GGX proxy)")


def sphere_pixels(scene):
    """The pixels whose centre ray hits an analytic sphere."""
    import torch
    from epsm_mitsuba3_torch.models import sensors as sns
    from epsm_mitsuba3_torch.models.records import Ray
    s = scene.sensors[0]
    dev = scene.device
    y, x = torch.meshgrid(torch.arange(s.height, device=dev),
                          torch.arange(s.width, device=dev), indexing="ij")
    pos = torch.stack([(x.reshape(-1) + 0.5) / s.width,
                       (y.reshape(-1) + 0.5) / s.height], -1)
    ray, _ = sns.sample_ray_differential(s, pos)
    pi = scene.ray_intersect_preliminary(Ray.make(ray.o, ray.d))
    return (pi.prim_index >= scene.faces.shape[0]).reshape(s.height, s.width)


def sphere_gradient_fd(label):
    """The reference's check on its ball scene at 512^2: PRB's centre and
    radius gradients non-zero, each with the sign of a central
    difference; and ``render_forward`` of a centre tangent against the
    backward's directional derivative (relative FW_RTOL)."""
    import torch
    import epsm_mitsuba3_torch as mt
    sc = mt.load_dict(ball_scene(RES))
    integ = {"type": "prb", "max_depth": 2}

    def loss(sph):
        return mt.render(sc.with_leaves({"sph_data": sph}), spp=PL_FD_SPP,
                         seed=3, integrator=integ).mean()

    sph = sc.sph_data.clone().requires_grad_(True)
    zero_counts()
    g = torch.autograd.grad(loss(sph), sph)[0][0].tolist()
    counts = read_counts()
    fd = []
    with torch.no_grad():
        for k in range(4):
            e = torch.zeros_like(sph)
            e[0, k] = PL_FD_EPS
            fd.append(float(loss(sc.sph_data + e) - loss(sc.sph_data - e))
                      / (2 * PL_FD_EPS))
    say(f"[plugins] {label}: PRB d mean(img) / d(cx, cy, cz, r) "
        f"{[round(x, 6) for x in g]}; central differences (eps "
        f"{PL_FD_EPS}) {[round(x, 6) for x in fd]}; fwd+bwd launches "
        f"{counts} [each non-zero, signs equal]")
    for k, (a, b) in enumerate(zip(g, fd)):
        check(math.isfinite(a) and a != 0.0 and (a > 0) == (b > 0),
              f"{label}: component {k}: gradient {a}, difference {b}")
    tan = torch.zeros_like(sc.sph_data)
    tan[0, :3] = torch.tensor([0.6, -0.3, 0.8])
    W = x_ramp(sc)
    dimg = mt.render_forward(sc, {"sph_data": tan}, spp=PL_FD_SPP,
                             seed=FW_SEED, integrator=integ)
    fwd = float((dimg * W).sum())
    bwd, _ = forward_vs_backward(sc, {"sph_data": tan}, PL_FD_SPP, integ)
    rel = abs(fwd - bwd) / max(abs(bwd), 1e-30)
    say(f"[plugins] {label}: render_forward of a centre tangent <dimg, W> "
        f"{fwd:.8g}, the backward's {bwd:.8g}: relative {rel:.3g} [limit "
        f"{FW_RTOL}]")
    check(rel <= FW_RTOL and bwd != 0.0,
          f"{label}: forward and backward disagree")
    return dict(grad=g, fd=fd, fwd=fwd, bwd=bwd, rel=rel)


def plugins_box_cell(measured):
    """The box with the sphere and the measured slot at full width."""
    import torch
    import epsm_mitsuba3_torch as mt
    n16 = SPP // SPP_CHUNK
    t0 = time.perf_counter()
    box = mt.load_dict(plugins_box(measured, RES, SPP_CHUNK))
    img, ms, _ = plugin_render(
        "box + sphere + measured", box, SPP, SPP_CHUNK,
        {"mt_closest_hit": DEPTH * n16, "mt_any_hit": DEPTH * n16,
         "bvh4_closest_hit": 0, "bvh4_any_hit": 0})
    plain = mt.render(mt.load_dict(plugins_box(measured, RES, SPP_CHUNK,
                                               ball=False)),
                      spp=SPP, seed=0, spp_chunk=SPP_CHUNK)
    mask = sphere_pixels(box)
    diff = (img - plain).abs().mean(-1)
    on, off = float(diff[mask].mean()), float(diff[~mask].mean())
    say(f"[plugins] the sphere covers {int(mask.sum())} pixels: mean "
        f"|img - img without it| {on:.6g} there, {off:.6g} elsewhere "
        f"[> 2 % of the image; sphere pixels differ: > 0.05 x the mean "
        f"{float(plain.mean()):.4g} and > 4x elsewhere]")
    check(float(mask.float().mean()) > 0.02
          and on > 0.05 * float(plain.mean()) and on > 4 * off,
          "the sphere's pixels do not differ")
    t1 = time.perf_counter()
    chi2 = measured_chi2(box)
    del plain
    t2 = time.perf_counter()
    fd = sphere_gradient_fd("ball scene")
    secs = {"load, renders": t1 - t0, "chi2": t2 - t1,
            "gradients": time.perf_counter() - t2}
    say("[plugins] box seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return dict(ms=ms, sphere_pixels=int(mask.sum()), diff_on=on,
                diff_off=off, chi2=chi2, fd=fd, secs=secs)


def plugins_mesh_cell():
    """cornell_box_mesh on the numpy-built tree: the build against the
    native one's, K2/K3 against their plain versions on it, the render
    against the native tree's, once more with an analytic sphere."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import bvh as BT
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.ops import traverse as TR
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    d = cornell_box_mesh(res=RES, spp=MESH_CHUNK, max_depth=DEPTH)
    mesh = mt.load_dict(d)
    v, f = mesh.vertices.detach().cpu().numpy(), mesh.faces.cpu().numpy()
    builds = {}
    for name in ("native", "numpy"):
        t0 = time.perf_counter()
        bvh = BT.build(v, f, device=mesh.device, builder=name)
        builds[name] = dict(s=time.perf_counter() - t0,
                            nodes=int(bvh.meta.shape[0]),
                            levels=int(bvh.n_levels), bvh=bvh)
    mesh_np = mesh.with_bvh(builds["numpy"]["bvh"])
    records = {"native": int(mesh.bvh_nodes.shape[0]),
               "numpy": int(mesh_np.bvh_nodes.shape[0])}
    say(f"[plugins] {mesh.faces.shape[0]} triangles: native build "
        f"{builds['native']['s']:.3f} s, {builds['native']['nodes']} binary "
        f"nodes over {builds['native']['levels']} levels, "
        f"{records['native']} BVH4 records; numpy build "
        f"{builds['numpy']['s']:.3f} s, {builds['numpy']['nodes']} nodes "
        f"over {builds['numpy']['levels']} levels, {records['numpy']} "
        "records")
    gen = torch.Generator(device=mesh.device).manual_seed(4)
    o, dd, maxt = (x[:PL_SUBSET].contiguous()
                   for x in main_path_rays(mesh_np, gen, MESH_CHUNK))
    args = (mesh_np.bvh_nodes, mesh_np.bvh_tris, o, dd, maxt)
    hit = CT.closest_hit(*args, tri_k=mesh_np.bvh_tris_k)
    occ = CT.any_hit(*args, tri_k=mesh_np.bvh_tris_k)
    ref = TR.bvh_ray_intersect_plain(*args)
    occ_ref = TR.bvh_ray_test_plain(*args)
    torch.cuda.synchronize()
    CT.raise_on_overflow(mesh.device)
    diff = [int((a != b).sum()) for a, b in zip(hit, ref)]
    say(f"[plugins] K2/K3 on the numpy tree against their plain versions "
        f"on {PL_SUBSET} rays: t, slot, u, v lanes differing {diff}, any "
        f"hit {int((occ != occ_ref).sum())} [limit 0]")
    check(all(torch.equal(a, b) for a, b in zip(hit, ref))
          and torch.equal(occ, occ_ref), "K2/K3 on the numpy tree differ "
          "from their plain versions")
    n = MESH_SPP // MESH_CHUNK
    expect = {"bvh4_closest_hit": DEPTH * n, "bvh4_any_hit": DEPTH * n,
              "mt_closest_hit": 0, "mt_any_hit": 0}
    img_np, ms_np, _ = plugin_render("mesh, numpy tree", mesh_np, MESH_SPP,
                                     MESH_CHUNK, expect)
    img_nat, ms_nat, _ = plugin_render("mesh, native tree", mesh, MESH_SPP,
                                       MESH_CHUNK, expect)
    delta = (img_np - img_nat).abs()
    mad = float(delta.mean())
    parted = float((delta.amax(-1) > 1e-5).float().mean())
    say(f"[plugins] numpy tree against native: mean |diff| {mad:.3g} "
        f"[limit {1e-4 * float(img_nat.mean()):.3g}]; pixels apart by > 1e-5:"
        f" {parted:.4%} [limit 0.1 %: tie rays]")
    check(mad <= 1e-4 * float(img_nat.mean()) and parted <= 1e-3,
          "the numpy tree's render differs from the native tree's")
    d["ball"] = dict(PL_BALL)
    mesh_ball = mt.load_dict(d).with_bvh(builds["numpy"]["bvh"])
    img_b, ms_b, _ = plugin_render("mesh + sphere, numpy tree", mesh_ball,
                                   MESH_SPP, MESH_CHUNK, expect)
    check(float((img_b - img_np).abs().mean()) > 1e-4,
          "the sphere does not show in the mesh")
    return dict(build_native_s=builds["native"]["s"],
                build_numpy_s=builds["numpy"]["s"], records=records,
                ms_numpy=ms_np, ms_native=ms_nat, ms_sphere=ms_b,
                mean_abs=mad, parted=parted)


def plugins_epsm_cell():
    """One ``manifold`` iteration of the epsm-mesh cell with an analytic
    sphere: finite, launches exact, and every logged vertex on the sphere
    has ismesh 0, so its chain stops there."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.integrators import epsm as ET
    from epsm_mitsuba3_torch.ops.sinkhorn import Matcher
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    d = cornell_box_mesh(res=EPSM_RES, spp=EPSM_SPP, max_depth=DEPTH)
    d["ball"] = dict(PL_BALL)
    scene = mt.load_dict(d)
    dev = scene.device
    with torch.no_grad():
        gt = mt.render(scene, spp=EPSM_SPP, seed=123,
                       integrator={"type": "path", "max_depth": DEPTH})
    theta = torch.tensor(0.01, device=dev, requires_grad=True)
    sc = scene.set_vertices(scene.vertices + theta * torch.tensor(
        [1.0, 0.0, 0.0], device=dev))
    logs = []
    orig = ET.sample_path_logged

    def keep(*a, **kw):
        out = orig(*a, **kw)
        logs.append(out[2])
        return out

    ET.sample_path_logged = keep
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = mt.render(sc, spp=EPSM_SPP, seed=1,
                        integrator={"type": "manifold", "max_depth": DEPTH})
        with torch.no_grad():
            g5 = Matcher(EPSM_RES).match_Sinkhorn(
                img[..., :3].reshape(-1, 3), gt.reshape(-1, 3)).reshape(
                    EPSM_RES, EPSM_RES, 5)
        (g,) = torch.autograd.grad(torch.sum(img * g5), theta)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        ET.sample_path_logged = orig
    counts = read_counts()
    check(len(logs) > 0, "epsm + sphere: no logged pass")
    nf = scene.faces.shape[0]
    on_sph = [lg.active & (lg.prim_index >= nf) for lg in logs]
    n_sph = sum(int(m.sum()) for m in on_sph)
    mesh_left = sum(int((lg.ismesh[m] != 0).sum())
                    for lg, m in zip(logs, on_sph))
    say(f"[plugins] epsm mesh + sphere, one manifold iteration at "
        f"{EPSM_RES}^2 x {EPSM_SPP} spp: {wall:.1f} ms, dL/dtheta "
        f"{float(g):.6g}, launches {counts}; {n_sph} logged vertices on "
        f"the sphere, {mesh_left} of them with ismesh != 0 [limit 0]")
    check(math.isfinite(float(g)) and float(g) != 0.0
          and bool(torch.isfinite(img).all()), "epsm + sphere: not finite")
    check(n_sph > 0 and mesh_left == 0,
          "epsm + sphere: the sphere's vertices do not stop their chains")
    for k, n in {"bvh4_closest_hit": 4 * DEPTH + 1,
                 "bvh4_any_hit": 3 * DEPTH, "mt_closest_hit": 0,
                 "mt_any_hit": 0}.items():
        check(counts[k] == n, f"epsm + sphere: {k} launched {counts[k]} "
              f"times, expected {n}")
    return dict(wall_ms=wall, grad=float(g), sphere_vertices=n_sph)


def plugins_double_cell():
    """The box at 512^2 x PL_SPP spp under float32 and under the double
    variant: the same K1 launches, the float64 image within PL_DOUBLE_REL
    of the float32 one; a PRB fwd+bwd pass in float64."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    n = PL_SPP // SPP_CHUNK
    expect = {"mt_closest_hit": DEPTH * n, "mt_any_hit": DEPTH * n}
    out = {}
    try:
        for name in ("cuda_ad_rgb", "cuda_ad_rgb_double"):
            mt.set_variant(name)
            box = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK,
                                           max_depth=DEPTH))
            img, ms, counts = plugin_render(f"box, {name}", box, PL_SPP,
                                            SPP_CHUNK, expect)
            out[name] = (img, ms, counts, box)
        img64, _, _, box64 = out["cuda_ad_rgb_double"]
        refl = box64.bsdfs["reflectance"].clone().requires_grad_(True)
        zero_counts()
        img_g = mt.render(box64.with_leaves({"bsdfs.reflectance": refl}),
                          spp=SPP_CHUNK, seed=5,
                          integrator={"type": "prb", "max_depth": DEPTH})
        (g,) = torch.autograd.grad((img_g ** 2).mean(), refl)
        counts_g = read_counts()
        fd_small, fd_large = double_precision_fd(mt.load_dict(cornell_box(
            res=128, spp=SPP_CHUNK, max_depth=DEPTH)))
    finally:
        mt.set_variant("cuda_ad_rgb")
    img32 = out["cuda_ad_rgb"][0]
    rel = float((img64 - img32).abs().mean() / img32.mean())
    say(f"[plugins] double variant: image {img64.dtype}, relative mean "
        f"|f64 - f32| {rel:.3g} [limit {PL_DOUBLE_REL}]; K1 launches "
        f"{out['cuda_ad_rgb_double'][2]} against {out['cuda_ad_rgb'][2]}; "
        f"PRB gradient {g.dtype}, |g| {float(g.norm()):.6g}, launches "
        f"{counts_g}; central differences of the reflectance at 128^2, "
        f"h 1e-8 {fd_small!r} against h 1e-3 {fd_large!r} [limit 1e-4 "
        f"relative]")
    check(img64.dtype == torch.float64 and rel < PL_DOUBLE_REL,
          "double: the image is not float64 or strays from float32's")
    check(out["cuda_ad_rgb_double"][2] == out["cuda_ad_rgb"][2],
          "double: launches differ from float32's")
    check(g.dtype == torch.float64 and bool(torch.isfinite(g).all())
          and float(g.abs().sum()) > 0, "double: gradient")
    check(fd_large > 1.0 and abs(fd_small - fd_large) < 1e-4 * fd_large,
          "double: shading or film lost float64 precision")
    return dict(rel=rel, ms32=out["cuda_ad_rgb"][1],
                ms64=out["cuda_ad_rgb_double"][1], grad_norm=float(g.norm()),
                fd_small=fd_small, fd_large=fd_large)


def double_precision_fd(box64):
    """The image's central difference in every reflectance at h = 1e-8
    (below float32's spacing) and at h = 1e-3, under the double variant:
    equal where shading and film run in float64; 0 or quantised where
    any step between the leaf and the film runs in float32."""
    import epsm_mitsuba3_torch as mt
    r = box64.bsdfs["reflectance"]

    def fd(h):
        lo, hi = (mt.render(box64.with_leaves({"bsdfs.reflectance": r + s}),
                            spp=SPP_CHUNK, seed=3, device=box64.device)
                  for s in (-h, h))
        return float((hi - lo).sum()) / (2.0 * h)

    return fd(1e-8), fd(1e-3)


# -- the registered plugins: each a torch function, as a user writes one ----

def _phong_eval_pdf(p, wi, wo):
    import torch
    r = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    cos_a = torch.clamp((r * wo).sum(-1), 0.0, 1.0)
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    lobe = (PL_PHONG + 2.0) / (2.0 * math.pi) * cos_a ** PL_PHONG
    val = p["reflectance"] * (lobe * torch.clamp(wo[..., 2], min=0.0))[
        ..., None]
    pdf = (PL_PHONG + 1.0) / (2.0 * math.pi) * cos_a ** PL_PHONG
    return torch.where(up[..., None], val, 0.0), torch.where(up, pdf, 0.0)


def _phong_sample(p, wi, s1, s2):
    import torch
    from epsm_mitsuba3_torch.core import math as mm
    from epsm_mitsuba3_torch.models.bsdf import BSDFFlags
    from epsm_mitsuba3_torch.models.records import BSDFSample
    cos_a = s2[..., 0] ** (1.0 / (PL_PHONG + 1.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = 2.0 * math.pi * s2[..., 1]
    r = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    s_, t_ = mm.coordinate_system(r)
    wo = (s_ * (sin_a * torch.cos(phi))[..., None]
          + t_ * (sin_a * torch.sin(phi))[..., None] + r * cos_a[..., None])
    val, pdf = _phong_eval_pdf(p, wi, wo)
    ok = (pdf > 0) & (wi[..., 2] > 0)
    w = torch.where(ok[..., None],
                    val / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    return BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                      sampled_type=torch.full(
                          pdf.shape, BSDFFlags.GlossyReflection,
                          dtype=torch.int32, device=wi.device),
                      hf=torch.zeros_like(wo)), w, ok


def _point_sample(row, ref_p, s2):
    import torch
    from epsm_mitsuba3_torch.models.records import DirectionSample
    dvec = row["position"] - ref_p
    dist2 = (dvec * dvec).sum(-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    dn = dvec / dist[..., None]
    return DirectionSample(
        p=row["position"], n=-dn, uv=s2, d=dn, dist=dist,
        pdf=torch.ones_like(dist),
        delta=torch.ones(dist.shape, dtype=torch.bool, device=dist.device),
        emitter_index=torch.zeros(dist.shape, dtype=torch.int32,
                                  device=dist.device)), \
        row["intensity"] / torch.clamp(dist2, min=1e-20)[..., None]


def _pyramid(props):
    import numpy as np
    s = float(props.get("size", 1.0))
    v = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
                  [0, 1.5 * s, 0]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [0, 1, 4], [1, 2, 4], [2, 3, 4],
                  [3, 0, 4]], np.int32)
    return {"vertices": v, "faces": f}


def _flipped(sensor, pos01):
    import torch
    aspect = sensor.width / sensor.height
    th = math.tan(math.radians(sensor.fov_x) * 0.5)
    u, v = 1.0 - pos01[..., 0], pos01[..., 1]
    d_cam = torch.stack([(1 - 2 * u) * th, (1 - 2 * v) * th / aspect,
                         torch.ones_like(u)], -1)
    d = d_cam @ sensor.to_world[:3, :3].T
    return sensor.to_world[:3, 3].expand(d.shape), d, None


def _uv_gradient(tex, uv, pos):
    import torch
    t = torch.clamp(uv[..., 0:1], 0.0, 1.0)
    return tex.color1 * t + tex.color0 * (1.0 - t)


def _halfshift(sampler):
    import torch
    from epsm_mitsuba3_torch.models import samplers as smp
    s, x = smp._next_1d_f32(sampler)
    return s, torch.remainder(x + 0.5, 1.0)


def register_plugins():
    """One plugin of each registry (the JAX package's test plugins,
    tests/test_register_*.py, written in torch), once a process."""
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.models import bsdf as B
    from epsm_mitsuba3_torch.models import emitters as E
    from epsm_mitsuba3_torch.models import samplers as S
    from epsm_mitsuba3_torch.models import scene as SC
    from epsm_mitsuba3_torch.models import sensors as SN
    from epsm_mitsuba3_torch.models import textures as TX
    if "pl_phong" not in B.KIND_NAMES:
        mt.register_bsdf("pl_phong", eval_pdf_fn=_phong_eval_pdf,
                         sample_fn=_phong_sample,
                         flags=B.BSDFFlags.GlossyReflection
                         | B.BSDFFlags.FrontSide)
    if "pl_point" not in E.KIND_NAMES:
        mt.register_emitter("pl_point", sample_fn=_point_sample)
    if "pl_pyramid" not in SC._CUSTOM_SHAPE_FNS:
        mt.register_shape("pl_pyramid", _pyramid)
    if "pl_flipped" not in SN._CUSTOM_SENSOR_FNS:
        mt.register_sensor("pl_flipped", _flipped)
    if "pl_uv_gradient" not in TX._CUSTOM_TEXTURE_FNS:
        mt.register_texture("pl_uv_gradient", _uv_gradient)
    if "pl_halfshift" not in S._CUSTOM_SAMPLER_FNS:
        mt.register_sampler("pl_halfshift", _halfshift)


def registry_box(res, spp):
    """cornell_box with a registered BSDF on the back wall, a registered
    texture on the floor, a registered shape, a registered point light
    beside the area light, seen by a registered sensor through a
    registered sampler."""
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    T = mt.ScalarTransform4f
    d = cornell_box(res=res, spp=spp, max_depth=DEPTH)
    d["back"]["bsdf"] = {"type": "pl_phong", "reflectance": {
        "type": "rgb", "value": [0.8, 0.6, 0.2]}}
    d["floor"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "pl_uv_gradient", "color0": [0.1, 0.1, 0.1],
        "color1": [0.9, 0.9, 0.9]}}
    d["pyr"] = {"type": "pl_pyramid", "size": 0.3,
                "to_world": T.translate([0.4, 0.0, 0.3]),
                "bsdf": {"type": "diffuse", "reflectance": {
                    "type": "rgb", "value": 0.6}}}
    d["bulb"] = {"type": "pl_point", "position": [0.0, 1.5, 0.5],
                 "intensity": {"type": "rgb", "value": [1.5] * 3}}
    for k, v in list(d.items()):
        if isinstance(v, dict) and v.get("type") == "perspective":
            v = {**v, "type": "pl_flipped"}
            v["sampler"] = {"type": "pl_halfshift", "sample_count": spp}
            d[k] = v
    return d


def phong_chi2(scene):
    """The registered BSDF's slot, through the custom-kind dispatch."""
    from epsm_mitsuba3_torch.models import bsdf as B
    return slot_chi2(scene, B.KIND_NAMES["pl_phong"], "registered phong",
                     res=21)


def plugins_registry_cell():
    """The box with one plugin of each registry at 512^2 x PL_SPP spp:
    launches exact, the plugins' kinds in the scene, the registered
    BSDF's chi-square test."""
    import epsm_mitsuba3_torch as mt
    register_plugins()
    sc = mt.load_dict(registry_box(RES, SPP_CHUNK))
    check(sc.static.sampler_kind == "pl_halfshift"
          and sc.sensors[0].kind == "pl_flipped"
          and any(t.kind == "pl_uv_gradient" for t in sc.textures)
          and "pyr" in sc.static.shape_names
          and max(sc.static.bsdf_kinds) >= 1000
          and max(sc.static.emitter_kinds) >= 1000,
          "registries: a plugin is missing from the scene")
    n = PL_SPP // SPP_CHUNK
    img, ms, counts = plugin_render(
        "registries box", sc, PL_SPP, SPP_CHUNK,
        {"mt_closest_hit": DEPTH * n, "mt_any_hit": DEPTH * n,
         "bvh4_closest_hit": 0, "bvh4_any_hit": 0})
    check(float(img.mean()) > 0.01, "registries: image dark")
    chi2 = phong_chi2(sc)
    return dict(ms=ms, chi2=chi2)


def plugins_card_vs_cpu(measured, res=64, spp=4):
    """Each [plugins] case at 64^2 on the card and on the CPU: images
    within 1e-3 x the mean on average; the sphere's PRB gradient and the
    manifold backward's vertex gradient on the box with the sphere
    within 1e-3 (relative L2)."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.ops import bvh as BT
    from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh
    register_plugins()
    tree = {}

    def numpy_tree(dev):
        sc = mt.load_dict(cornell_box_mesh(res=res, spp=2, max_depth=DEPTH),
                          device=dev)
        if not tree:
            tree["bvh"] = BT.build(sc.vertices, sc.faces, builder="numpy")
        bvh = tree["bvh"]
        return sc.with_bvh(bvh.replace(**{
            k: getattr(bvh, k).to(sc.device) for k in BT.ARRAY_FIELDS}))

    cases = {
        "box + sphere + measured": lambda dev: mt.load_dict(
            plugins_box(measured, res, spp), device=dev),
        "mesh, numpy tree": numpy_tree,
        "registries": lambda dev: mt.load_dict(registry_box(res, spp),
                                               device=dev),
        "box, double": lambda dev: mt.load_dict(
            cornell_box(res=res, spp=spp, max_depth=DEPTH), device=dev)}
    out = {}
    for label, make in cases.items():
        imgs = []
        try:
            if label == "box, double":
                mt.set_variant("cuda_ad_rgb_double")
            for dev in ("cuda", "cpu"):
                sc = make(dev)
                imgs.append(mt.render(sc, spp=2 if "mesh" in label else spp,
                                      seed=0, device=dev).cpu())
        finally:
            mt.set_variant("cuda_ad_rgb")
        a, b = imgs
        mad, mean = float((a - b).abs().mean()), float(b.abs().mean())
        out[label] = mad
        say(f"[plugins, card vs cpu] {label} {res}^2: mean |gpu - cpu| "
            f"{mad:.3g} (limit {1e-3 * mean:.3g}); dtype {a.dtype}")
        check(mad <= 1e-3 * mean and bool(torch.isfinite(a).all())
              and a.dtype == b.dtype, f"{label}: card and CPU disagree")
    grads = []
    for dev in ("cuda", "cpu"):
        sc = mt.load_dict(plugins_box(measured, res, spp), device=dev)
        sph = sc.sph_data.clone().requires_grad_(True)
        v = sc.vertices.clone().requires_grad_(True)
        sc = sc.with_leaves({"sph_data": sph, "vertices": v})
        img = mt.render(sc, spp=spp, seed=0, device=dev,
                        integrator={"type": "prb", "max_depth": 3})
        (gs,) = torch.autograd.grad((img ** 2).mean(), sph)
        img5 = mt.render(sc, spp=2, seed=0, device=dev,
                         integrator={"type": "manifold", "max_depth": 3})
        w = torch.linspace(-1.0, 1.0, img5.numel(),
                           device=img5.device).reshape(img5.shape)
        (gv,) = torch.autograd.grad((img5 * w).sum(), v)
        grads.append((gs.cpu(), gv.cpu()))
    for name, a, b in zip(("sphere PRB", "manifold vertices"), *grads):
        err = rel_l2(a, b)
        out[name] = err
        say(f"[plugins, card vs cpu] {name} gradient: relative L2 "
            f"{err:.3g} [limit 1e-3]")
        check(err <= 1e-3 and float(b.abs().sum()) > 0,
              f"{name}: card and CPU gradients disagree")
    return out


def plugins_phase():
    """[plugins]: the box with an analytic sphere and a measured slot at
    full width, cornell_box_mesh on the numpy-built tree, a manifold
    iteration with a sphere, the double variant, the six registries, the
    card against the CPU.  Returns the numbers and the phase's
    launches."""
    global _TALLY
    import tempfile
    secs, out = {}, {}
    zero_counts()
    _TALLY = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            measured = f"{tmp}/synth.bsdf"
            synth_measured(measured)
            t0 = time.perf_counter()
            out["box"] = plugins_box_cell(measured)
            secs["box"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["mesh"] = plugins_mesh_cell()
            secs["mesh"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["epsm"] = plugins_epsm_cell()
            secs["epsm"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["double"] = plugins_double_cell()
            secs["double"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["registries"] = plugins_registry_cell()
            secs["registries"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["card vs cpu"] = plugins_card_vs_cpu(measured)
            secs["card vs cpu"] = time.perf_counter() - t0
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    say("[plugins] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    out["secs"] = secs
    return out


# ---------------------------------------------------------------------------
# [stokes]: polarized transport (integrators/polarized.py), the
# polarization elements and the measured polarized BSDF
# ---------------------------------------------------------------------------

#: the [stokes] integrator, at the box's depth
ST_INTEG = {"type": "stokes", "max_depth": DEPTH}
#: the box's conductor (the right wall) and the plate's polarizer angle
ST_CONDUCTOR = {"type": "conductor",
                "eta": {"type": "rgb", "value": [0.2, 0.9, 1.1]},
                "k": {"type": "rgb", "value": [3.0, 2.5, 2.2]}}
ST_THETA = 30.0
#: Malus's law through two plates (JAX tests/test_polarized.py:112-151):
#: the second plate's angles, the film and spp of those renders, the bar
#: on S0 against 0.5 cos^2 and on the crossed plates' S0
ST_MALUS_ANGLES, ST_MALUS_RES, ST_MALUS_SPP = (0.0, 30.0, 60.0, 90.0), 64, 8
ST_MALUS_TOL, ST_CROSSED = 0.01, 1e-3
#: the plate's pixels' degree of polarization (the JAX package's bar on
#: an ideal polarizer, :112) and the conductor wall's least
ST_PLATE_DOP, ST_CONDUCTOR_DOP = 0.98, 1e-3
#: the pBSDF box: spp (passes of SPP_CHUNK); the direction pairs on which
#: the polarizing table's degree of linear polarization is held near 1
#: (JAX tests/test_measured_polarized.py:127, within 1e-3)
ST_PB_SPP, ST_PB_PAIRS = 16, 2 ** 20


def stokes_box(res, spp, plate=True, pbsdf=None):
    """cornell_box with a linear polarizer plate in front of the back
    wall (ST_THETA) and a conductor right wall; with ``pbsdf``, the back
    wall is that measured_polarized table."""
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    d = cornell_box(res=res, spp=spp, max_depth=DEPTH)
    if plate:
        d["plate"] = {"type": "rectangle",
                      "to_world": mt.ScalarTransform4f.translate(
                          [0.0, 1.0, 0.2]).scale(0.35),
                      "bsdf": {"type": "polarizer", "theta": ST_THETA}}
        d["right"]["bsdf"] = dict(ST_CONDUCTOR)
    if pbsdf:
        d["back"]["bsdf"] = {"type": "measured_polarized",
                             "filename": pbsdf, "alpha_sample": 0.3}
    return d


def stokes_mesh(res, spp):
    """cornell_box_mesh with the plate (its K2/K3 cell)."""
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box_mesh
    d = cornell_box_mesh(res=res, spp=spp, max_depth=DEPTH)
    d["plate"] = {"type": "rectangle",
                  "to_world": mt.ScalarTransform4f.translate(
                      [0.0, 1.0, 0.2]).scale(0.35),
                  "bsdf": {"type": "polarizer", "theta": ST_THETA}}
    return d


def synth_pbsdf(path):
    """A pBSDF tensor file whose every bin is an ideal linear polarizer
    scaled by 0.6 (as the JAX package's tests/test_measured_polarized.py
    writes its tables; no download)."""
    import numpy as np
    from epsm_mitsuba3_torch.models import measured_polarized as MP
    pd = np.linspace(-np.pi, np.pi, 9).astype(np.float32)
    td = np.linspace(0, np.pi / 2, 7).astype(np.float32)
    th = np.linspace(0, np.pi / 2, 8).astype(np.float32)
    P = 0.3 * np.array([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0],
                        [0, 0, 0, 0]], np.float32)
    M = np.broadcast_to(P, (9, 7, 8, 5, 4, 4)).copy()
    MP.synthesize_tensor_file(path, M, pd, td, th,
                              np.asarray([450, 500, 550, 600, 650]))


def stokes_render(label, scene, spp, chunk, expect, integrator=ST_INTEG,
                  seed=0):
    """One render of ``spp`` in passes of ``chunk``, the counts set to 0
    before and read after, each as ``expect`` says; the image finite.
    Returns (image, wall ms, peak GiB, counts)."""
    import torch
    import epsm_mitsuba3_torch as mt
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = mt.render(scene, spp=spp, seed=seed, spp_chunk=chunk,
                    integrator=integrator)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = read_counts()
    say(f"[stokes] {label}: {scene.sensors[0].width}^2 x {spp} spp in "
        f"passes of {chunk}, {integrator}: {ms:.1f} ms; peak {peak:.2f} "
        f"GiB; launches {counts}; image {tuple(img.shape)}, mean "
        f"{float(img.mean()):.6g}")
    for k, n in expect.items():
        check(counts[k] == n, f"{label}: {k} launched {counts[k]} times, "
              f"expected {n}")
    check(bool(torch.isfinite(img).all()), f"{label}: image not finite")
    return img, ms, peak, counts


def dop(img):
    """The degree of linear polarization of a stokes image, pixel by
    pixel, from the mean of the RGB channels of S0, S1 and S2."""
    s0, s1, s2 = (img[..., k:k + 3].mean(-1) for k in (3, 6, 9))
    return (s1 ** 2 + s2 ** 2).sqrt() / s0.clamp(min=1e-12)


def first_hit_mask(scene, names):
    """The pixels whose centre ray first hits one of the shapes
    ``names``."""
    import torch
    from epsm_mitsuba3_torch.models import sensors as sns
    from epsm_mitsuba3_torch.models.records import Ray
    s = scene.sensors[0]
    dev = scene.device
    y, x = torch.meshgrid(torch.arange(s.height, device=dev),
                          torch.arange(s.width, device=dev), indexing="ij")
    pos = torch.stack([(x.reshape(-1) + 0.5) / s.width,
                       (y.reshape(-1) + 0.5) / s.height], -1)
    ray, _ = sns.sample_ray_differential(s, pos)
    pi = scene.ray_intersect_preliminary(Ray.make(ray.o, ray.d))
    shape = scene.face_shape[pi.prim_index.clamp(min=0).long()]
    ids = [scene.static.shape_names.index(n) for n in names]
    hit = pi.valid & torch.isin(shape, torch.tensor(ids, device=dev))
    return hit.reshape(s.height, s.width)


def stokes_box_cell():
    """The plate-and-conductor box at full width through K1: the plate's
    pixels fully polarized, the conductor's partly; and on the diffuse
    box S0 equal to path's image at the same seed."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.scenes import cornell_box
    n16 = SPP // SPP_CHUNK
    box = mt.load_dict(stokes_box(RES, SPP_CHUNK))
    img, ms, peak, _ = stokes_render(
        "box + plate + conductor", box, SPP, SPP_CHUNK,
        {"mt_closest_hit": DEPTH * n16, "mt_any_hit": DEPTH * n16,
         "bvh4_closest_hit": 0, "bvh4_any_hit": 0})
    prof = profile_pass(f"stokes box, one {SPP_CHUNK}-spp pass",
                        lambda: mt.render(box, spp=SPP_CHUNK, seed=7,
                                          integrator=ST_INTEG),
                        ("mt_closest", "mt_any"), table=False)
    p = dop(img)
    on_plate, on_right = (first_hit_mask(box, [n]) for n in ("plate",
                                                             "right"))
    # the plate's inner pixels (its edges mix the wall behind it)
    inner = on_plate & torch.roll(on_plate, 2, 0) & torch.roll(
        on_plate, -2, 0) & torch.roll(on_plate, 2, 1) & torch.roll(
        on_plate, -2, 1)
    dop_plate = float(p[inner].mean())
    dop_right = float(p[on_right].mean())
    dop_left = float(p[first_hit_mask(box, ["left"])].mean())
    s3 = float(img[..., 12:15].abs().max())
    say(f"[stokes] box: mean DOP on the plate's {int(inner.sum())} inner "
        f"pixels {dop_plate:.6f} [> {ST_PLATE_DOP}], on the conductor "
        f"wall's {int(on_right.sum())} {dop_right:.6g} [> "
        f"{ST_CONDUCTOR_DOP}], on the diffuse left wall's "
        f"{dop_left:.6g}; max |S3| {s3:.3g} (the conductor's phase turns "
        "the plate's S2 into S3)")
    check(int(inner.sum()) > 100 and dop_plate > ST_PLATE_DOP,
          "the plate's pixels are not fully polarized")
    check(dop_right > ST_CONDUCTOR_DOP, "the conductor does not polarize")
    del img

    diffuse = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK,
                                       max_depth=DEPTH))
    img_d, ms_d, _, _ = stokes_render(
        "diffuse box", diffuse, SPP_CHUNK, SPP_CHUNK,
        {"mt_closest_hit": DEPTH, "mt_any_hit": DEPTH})
    path = mt.render(diffuse, spp=SPP_CHUNK, seed=0,
                     integrator={"type": "path", "max_depth": DEPTH})
    d_max = float((img_d[..., 3:6] - path).abs().max())
    d_mean = abs(float(img_d[..., 3:6].mean() - path.mean()))
    pol = float(img_d[..., 6:].abs().max())
    say(f"[stokes] diffuse box, {SPP_CHUNK} spp: S0 against path at the "
        f"same seed: max |diff| {d_max:.3g} (limit "
        f"{1e-5 * float(path.max()):.3g}), |mean diff| {d_mean:.3g} "
        f"(limit {1e-5 * float(path.mean()):.3g}); max |S1..S3| {pol:.3g} "
        f"[< 1e-5: every lobe depolarizes]")
    check(d_max <= 1e-5 * float(path.max())
          and d_mean <= 1e-5 * float(path.mean()),
          "S0 of the diffuse box is not path's image")
    check(pol < 1e-5, "a diffuse box polarizes")
    return dict(ms=ms, peak=peak, profile=prof, dop_plate=dop_plate,
                dop_right=dop_right,
                dop_left=dop_left, s0_path_max=d_max, s0_path_mean=d_mean,
                diffuse_ms=ms_d)


def malus_cell():
    """Malus's law through two plates against a constant white light (the
    JAX package's tests/test_polarized.py:82-151): S0 = 0.5 cos^2 of the
    angle between them, the crossed plates dark."""
    import math
    import epsm_mitsuba3_torch as mt
    T = mt.ScalarTransform4f
    out = {}
    for ang in ST_MALUS_ANGLES:
        d = {"type": "scene",
             "light": {"type": "constant",
                       "radiance": {"type": "rgb", "value": [1.0] * 3}},
             "plate": {"type": "rectangle",
                       "to_world": T.translate([0, 0, 2.0]).scale(8.0),
                       "bsdf": {"type": "polarizer", "theta": 0.0}},
             "plate2": {"type": "rectangle",
                        "to_world": T.translate([0, 0, 1.0]).scale(8.0),
                        "bsdf": {"type": "polarizer", "theta": ang}},
             "sensor": {"type": "perspective", "fov": 40,
                        "to_world": T.look_at(origin=[0, 0, 0],
                                              target=[0, 0, 1],
                                              up=[0, 1, 0]),
                        "film": {"type": "hdrfilm", "width": ST_MALUS_RES,
                                 "height": ST_MALUS_RES,
                                 "rfilter": {"type": "box"}}}}
        img, _, _, _ = stokes_render(
            f"two plates at {ang:g} degrees", mt.load_dict(d),
            ST_MALUS_SPP, ST_MALUS_SPP, {"mt_closest_hit": 5,
                                         "mt_any_hit": 5},
            integrator={"type": "stokes", "max_depth": 5})
        c = ST_MALUS_RES // 2
        s0 = float(img[c - 2:c + 2, c - 2:c + 2, 3:6].mean())
        want = 0.5 * math.cos(math.radians(ang)) ** 2
        out[ang] = s0
        say(f"[stokes] Malus: plates 0 and {ang:g} degrees: centre S0 "
            f"{s0:.6f}, 0.5 cos^2 {want:.6f} [within {ST_MALUS_TOL}"
            + (f"; crossed < {ST_CROSSED}" if ang == 90.0 else "") + "]")
        check(abs(s0 - want) < ST_MALUS_TOL, f"Malus's law at {ang}")
        if ang == 90.0:
            check(s0 < ST_CROSSED, "crossed plates pass light")
    return out


def stokes_mesh_cell():
    """cornell_box_mesh with the plate through K2/K3."""
    import epsm_mitsuba3_torch as mt
    n = MESH_SPP // MESH_CHUNK
    mesh = mt.load_dict(stokes_mesh(RES, MESH_CHUNK))
    img, ms, peak, _ = stokes_render(
        "mesh + plate", mesh, MESH_SPP, MESH_CHUNK,
        {"bvh4_closest_hit": DEPTH * n, "bvh4_any_hit": DEPTH * n,
         "mt_closest_hit": 0, "mt_any_hit": 0, "bvh4_closest_hit_mp": 0})
    check(float(img[..., 6:12].abs().max()) > 0, "mesh: no polarization")
    return dict(ms=ms, peak=peak)


def pbsdf_cell(pbsdf):
    """The box with a polarizing pBSDF back wall through K1; the table's
    degree of linear polarization on 2^20 direction pairs on the card."""
    import torch
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.core import mueller as mu
    from epsm_mitsuba3_torch.models import measured_polarized as MP
    box = mt.load_dict(stokes_box(RES, SPP_CHUNK, plate=False, pbsdf=pbsdf))
    n4 = ST_PB_SPP // SPP_CHUNK
    img, ms, peak, _ = stokes_render(
        "box, pBSDF back wall", box, ST_PB_SPP, SPP_CHUNK,
        {"mt_closest_hit": DEPTH * n4, "mt_any_hit": DEPTH * n4})
    back = first_hit_mask(box, ["back"])
    dop_back = float(dop(img)[back].mean())
    tex = next(t for t in box.textures if t.kind == "pbsdf")
    dev = box.device
    gen = torch.Generator(device=dev).manual_seed(5)
    wi, wo = (torch.randn((ST_PB_PAIRS, 3), generator=gen, device=dev)
              for _ in range(2))
    wi[:, 2], wo[:, 2] = wi[:, 2].abs() + 0.2, wo[:, 2].abs() + 0.2
    wi, wo = wi / wi.norm(dim=-1, keepdim=True), wo / wo.norm(dim=-1,
                                                              keepdim=True)
    M, ok = MP.eval_mueller_local(tex, wi, wo)
    s_in = torch.zeros((ST_PB_PAIRS, 4, 3), device=dev)
    s_in[:, 0, :] = 1.0
    s = mu.matvec(M, s_in)
    dolp = (s[:, 1] ** 2 + s[:, 2] ** 2).sqrt() / s[:, 0].clamp(min=1e-12)
    err = float((dolp - 1.0).abs().max())
    say(f"[stokes] pBSDF: mean DOP on the back wall's {int(back.sum())} "
        f"pixels {dop_back:.6g}; the table's DOLP on {ST_PB_PAIRS} pairs: "
        f"max |DOLP - 1| {err:.3g} [limit 1e-3], S0 {float(s[:, 0].mean()):.6f}"
        f" [0.3], valid {bool(ok.all())}")
    check(bool(ok.all()) and err < 1e-3, "the polarizing table's DOLP")
    check(dop_back > 0.05, "the pBSDF wall does not polarize")
    return dict(ms=ms, peak=peak, dop_back=dop_back, dolp_err=err)


def stokes_prb_cell():
    """One prb fwd+bwd pass through the plate at full width: K1 DEPTH
    times each in the forward, nothing in the backward, the reflectances'
    gradient finite and non-zero."""
    import torch
    import epsm_mitsuba3_torch as mt
    sc = mt.load_dict(stokes_box(RES, SPP_CHUNK))
    refl = sc.bsdfs["reflectance"].clone().requires_grad_(True)
    sc = sc.with_leaves({"bsdfs.reflectance": refl})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, (g,), fwd, bwd = fwd_bwd(sc, {"r": refl}, SPP_CHUNK, 0,
                                   {"type": "prb", "max_depth": DEPTH})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    say(f"[stokes] prb fwd+bwd through the plate, {RES}^2 x {SPP_CHUNK} "
        f"spp: {ms:.1f} ms; loss {float(loss.detach()):.6g}; launches fwd "
        f"{fwd}, bwd {bwd}; |grad| {float(g.norm()):.6g}")
    check(fwd["mt_closest_hit"] == DEPTH and fwd["mt_any_hit"] == DEPTH
          and sum(bwd.values()) == 0, "prb through the plate: launches")
    check(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0,
          "prb through the plate: gradient")
    return dict(ms=ms, counts_fwd=fwd)


def stokes_card_vs_cpu(pbsdf, res=64, spp=4):
    """Each [stokes] scene at 64^2 on the card and on the CPU: images
    within 1e-3 x the mean on average; the PRB gradient of the box's
    reflectances through the plate within 1e-3 (relative L2)."""
    import torch
    import epsm_mitsuba3_torch as mt
    cases = {"box + plate + conductor": (stokes_box(res, spp), spp),
             "mesh + plate": (stokes_mesh(res, 2), 2),
             "box, pBSDF back wall": (stokes_box(res, spp, plate=False,
                                                 pbsdf=pbsdf), spp)}
    out = {}
    for label, (d, n) in cases.items():
        a, b = (mt.render(mt.load_dict(d, device=dev), spp=n, seed=0,
                          device=dev, integrator=ST_INTEG).cpu()
                for dev in ("cuda", "cpu"))
        mad, mean = float((a - b).abs().mean()), float(b.abs().mean())
        out[label] = mad
        say(f"[stokes, card vs cpu] {label} {res}^2: mean |gpu - cpu| "
            f"{mad:.3g} (limit {1e-3 * mean:.3g})")
        check(mad <= 1e-3 * mean and bool(torch.isfinite(a).all()),
              f"{label}: card and CPU disagree")
    grads = []
    for dev in ("cuda", "cpu"):
        sc = mt.load_dict(stokes_box(res, spp), device=dev)
        refl = sc.bsdfs["reflectance"].clone().requires_grad_(True)
        img = mt.render(sc.with_leaves({"bsdfs.reflectance": refl}),
                        spp=spp, seed=0, device=dev,
                        integrator={"type": "prb", "max_depth": DEPTH})
        grads.append(torch.autograd.grad((img ** 2).mean(), refl)[0].cpu())
    err = rel_l2(*grads)
    out["prb through the plate"] = err
    say(f"[stokes, card vs cpu] prb gradient of the reflectances through "
        f"the plate: relative L2 {err:.3g} [limit 1e-3]")
    check(err <= 1e-3 and float(grads[1].abs().sum()) > 0,
          "prb through the plate: card and CPU gradients disagree")
    return out


def stokes_phase():
    """[stokes]: the polarized pipeline at full width through K1 (the
    plate-and-conductor box, the diffuse box against path, Malus's law,
    a pBSDF back wall) and K2/K3 (the mesh with the plate), a prb pass
    through the plate, the card against the CPU.  Returns the numbers and
    the phase's launches."""
    global _TALLY
    import tempfile
    secs, out = {}, {}
    zero_counts()
    _TALLY = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            pbsdf = f"{tmp}/polarizer.pbsdf"
            synth_pbsdf(pbsdf)
            for key, fn in (("box", stokes_box_cell), ("malus", malus_cell),
                            ("mesh", stokes_mesh_cell),
                            ("pbsdf", lambda: pbsdf_cell(pbsdf)),
                            ("prb", stokes_prb_cell),
                            ("card vs cpu",
                             lambda: stokes_card_vs_cpu(pbsdf))):
                t0 = time.perf_counter()
                out[key] = fn()
                secs[key] = time.perf_counter() - t0
        zero_counts()
        out["total"], _TALLY = _TALLY, None
    finally:
        _TALLY = None
    say("[stokes] seconds by step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} s in all")
    out["secs"] = secs
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 1
    start = time.perf_counter()
    import epsm_mitsuba3_torch as mt
    from epsm_mitsuba3_torch.models import mesh_io as MIO
    from epsm_mitsuba3_torch.ops import _native
    from epsm_mitsuba3_torch.ops import bvh as BT
    from epsm_mitsuba3_torch.ops import cuda_intersect as CI
    from epsm_mitsuba3_torch.ops import cuda_traverse as CT
    from epsm_mitsuba3_torch.scenes import cornell_box, cornell_box_mesh

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    say(f"[device] {gpu} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name} x{torch.cuda.device_count()}")
    laps = [time.perf_counter()]

    def lap(label):
        """Print the seconds since the last lap: the script's time by
        phase, against its limit."""
        laps.append(time.perf_counter())
        say(f"[phase] {label}: {laps[-1] - laps[-2]:.1f} s")

    # -- 1. build: every compiler at once ----------------------------------
    t0 = time.perf_counter()
    _native.build([CI.SPEC, CT.SPEC, BT.SPEC, MIO.SPEC])
    CI.build()
    CT.build()
    say(f"[build] K1, K2/K4/K3 (nvcc), the BVH builder and the OBJ parser "
        f"(g++) built in {time.perf_counter() - t0:.1f} s")
    for lib in (CI.SPEC.name, CT.SPEC.name):
        for line in _native.build_logs.get(lib, "").splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line or "stack frame" in line:
                say(f"[build] {lib}: {line.strip()}")
    k4_regs = k4_registers(_native.build_logs.get(CT.SPEC.name, ""))
    for key, use in k4_regs.items():
        say(f"[build] K4 {key}: {use}")

    lap("1 build")

    # -- 2. K1 against its plain version, at three shapes -----------------
    gen = torch.Generator(device=dev).manual_seed(1)
    box = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK, max_depth=DEPTH))
    tri_box = CI.pack_tris(box.vertices, box.faces)
    rays_box = main_path_rays(box, gen, SPP_CHUNK)
    shapes = {
        "i": ("Cornell-box shape", tri_box, *rays_box),
        "ii": ("largest shape", *soup_rays(4096, 65536, gen, dev)),
        "iii": ("largest shape, a user's pass",
                *soup_rays(4096, 2 ** 20, gen, dev))}
    k1_err, k1_times = {}, {}
    for key, (label, *args) in shapes.items():
        k1_err[key] = compare_k1(label, *args)
        k1_times[key] = time_k1(*args, iters={"i": 50, "ii": 20,
                                              "iii": 5}[key],
                                plain=key != "iii")
    del rays_box, shapes
    k1_render = render_rays_k1(box, SPP_CHUNK)
    k1_sweep = k1_rule_sweep(gen, dev)
    times = k1_times["i"]
    c3 = k1_times["iii"]["mt_closest_hit"]
    ratio = {key: t["mt_any_hit"]["ms"] / t["mt_closest_hit"]["ms"]
             for key, t in k1_times.items()}
    say(f"[speed] closest hit at shape iii: {c3['bound_ms'] / c3['ms']:.1%} "
        "of its bound (aim >= 60 %); any / closest at ii and iii: "
        f"{ratio['ii']:.3f}, {ratio['iii']:.3f} (aim <= 0.25)")

    lap("2 K1")

    # -- 3. the Cornell box at full width ----------------------------------
    scene = mt.load_dict(cornell_box(res=RES, spp=SPP, max_depth=DEPTH))
    n_passes = SPP // SPP_CHUNK
    _, counts_box = render_phase(
        "render box", scene, SPP, SPP_CHUNK,
        {"mt_closest_hit": DEPTH * n_passes, "mt_any_hit": DEPTH * n_passes,
         "bvh4_closest_hit": 0, "bvh4_any_hit": 0})
    profile_pass(f"render box, one {SPP_CHUNK}-spp pass",
                 lambda: mt.render(scene, spp=SPP_CHUNK, seed=7),
                 ("mt_closest", "mt_any"))
    del scene

    lap("3 render box")

    # -- 4. K2/K3 against their plain versions --------------------------------
    t0 = time.perf_counter()
    mesh = mt.load_dict(cornell_box_mesh(res=RES, spp=MESH_CHUNK,
                                         max_depth=DEPTH))
    torch.cuda.synchronize()
    say(f"[mesh] cornell_box_mesh: {mesh.faces.shape[0]} triangles, "
        f"{mesh.bvh.meta.shape[0]} binary nodes over {mesh.bvh.n_levels} "
        f"levels, {mesh.bvh_nodes.shape[0]} BVH4 records; loaded with its "
        f"BVH in {time.perf_counter() - t0:.2f} s")
    rays_mesh = main_path_rays(mesh, gen, MESH_CHUNK)
    bvh = compare_bvh(mesh, *rays_mesh)

    # -- 5. K4 against its plain version, K2 and the brute force; times ------
    k4 = compare_k4(mesh, *rays_mesh)
    bvh_times = time_bvh(mesh, *rays_mesh, bvh["plain_ms"], bvh["work"], k4)
    k4_steps = time_k4_steps(mesh, *rays_mesh,
                             bvh_times["bvh4_closest_hit"]["bound_ms"])
    steps = time_steps(mesh, *rays_mesh)
    lanes = lane_utilisation(mesh, *rays_mesh)
    del rays_mesh
    per_depth = render_rays(mesh, MESH_CHUNK)

    lap("4-5 K2/K3/K4")

    # -- 6. the BVH slice at full width ------------------------------------
    n_mesh = MESH_SPP // MESH_CHUNK
    _, counts_mesh = render_phase(
        "render mesh", mesh, MESH_SPP, MESH_CHUNK,
        {"mt_closest_hit": 0, "mt_any_hit": 0,
         "bvh4_closest_hit": DEPTH * n_mesh, "bvh4_any_hit": DEPTH * n_mesh})
    profile_pass(f"render mesh, one {MESH_CHUNK}-spp pass",
                 lambda: mt.render(mesh, spp=MESH_CHUNK, seed=7),
                 ("bvh4_closest", "bvh4_any"))
    del mesh

    lap("6 render mesh")

    # -- 7. card against CPU --------------------------------------------------
    card_vs_cpu("cornell_box", cornell_box(res=64, spp=4, max_depth=DEPTH), 4)
    card_vs_cpu("cornell_box_mesh",
                cornell_box_mesh(res=64, spp=4, max_depth=DEPTH), 4)

    lap("7 card vs cpu")

    # -- 8. fwd+bwd at full width: bench.py's toy and bvh cells -------------
    box = mt.load_dict(cornell_box(res=RES, spp=SPP_CHUNK, max_depth=DEPTH))
    _, _, train_box, (sc_box, lv_box) = train_phase(
        "train box", box, SPP_CHUNK, BOX_PASSES,
        {"mt_closest_hit": DEPTH, "mt_any_hit": DEPTH,
         "bvh4_closest_hit": 0, "bvh4_any_hit": 0})
    profile_pass(f"train box, one {SPP_CHUNK}-spp fwd+bwd pass",
                 lambda: fwd_bwd(sc_box, lv_box, SPP_CHUNK, 99),
                 ("mt_closest", "mt_any"))
    del box, sc_box, lv_box
    mesh = mt.load_dict(cornell_box_mesh(res=RES, spp=MESH_CHUNK,
                                         max_depth=DEPTH))
    _, _, train_mesh, (sc_mesh, lv_mesh) = train_phase(
        "train mesh", mesh, MESH_CHUNK, MESH_PASSES,
        {"bvh4_closest_hit": DEPTH, "bvh4_closest_hit_mp": 0,
         "bvh4_any_hit": DEPTH, "mt_closest_hit": 0, "mt_any_hit": 0})
    profile_pass(f"train mesh, one {MESH_CHUNK}-spp fwd+bwd pass",
                 lambda: fwd_bwd(sc_mesh, lv_mesh, MESH_CHUNK, 99),
                 ("bvh4_closest", "bvh4_any"))
    mp = {"multi_pop": 4}
    _, _, train_mp, _ = train_phase(
        "train mesh K4", mesh, MESH_CHUNK, MESH_PASSES,
        {"bvh4_closest_hit": 0, "bvh4_closest_hit_mp": DEPTH,
         "bvh4_any_hit": DEPTH, "mt_closest_hit": 0, "mt_any_hit": 0}, mp)
    profile_pass(f"train mesh K4, one {MESH_CHUNK}-spp fwd+bwd pass",
                 lambda: fwd_bwd(sc_mesh, lv_mesh, MESH_CHUNK, 99, mp),
                 ("bvh4_closest", "bvh4_any"))
    l2, g2, _, _ = fwd_bwd(sc_mesh, lv_mesh, MESH_CHUNK, 1)
    l4, g4, _, _ = fwd_bwd(sc_mesh, lv_mesh, MESH_CHUNK, 1, mp)
    errs = {k: rel_l2(a, b) for k, a, b in zip(TRAIN_LEAVES, g4, g2)}
    say(f"[train mesh K4] one pass, seed 1: loss K4 {float(l4):.8g}, K2 "
        f"{float(l2):.8g}; |g_K4 - g_K2| / |g_K2| "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + "  [limit 1e-4 each: only tie rays may differ]")
    for k, e in errs.items():
        check(e <= 1e-4, f"K4 and K2 gradients of {k} differ by {e}")
    del mesh, sc_mesh, lv_mesh

    lap("8 fwd+bwd")

    # -- 9. Adam on the mesh, through set_vertices -----------------------------
    adam_phase(cornell_box_mesh(res=RES, spp=MESH_CHUNK, max_depth=DEPTH),
               gen)

    lap("9 adam")

    # -- 10. gradients on the card against the CPU -----------------------------
    box64 = cornell_box(res=64, spp=4, max_depth=DEPTH)
    for k in ("floor", "ceiling", "back", "left", "right"):
        box64[k]["face_normals"] = True
    grad_card_vs_cpu("cornell_box (face normals)", box64, 4)
    grad_card_vs_cpu("cornell_box_mesh (sphere normals)", blob_normals(
        cornell_box_mesh(res=64, spp=4, max_depth=DEPTH)), 4)

    lap("10 gradients card vs cpu")

    # -- 11-13. the EPSM leg: bench.py's manifold_iter on the mesh, the
    # cornellbox experiment at its widths, card against CPU ------------------
    epsm_mesh = epsm_mesh_phase()
    epsm_cb = epsm_cornellbox_phase()
    epsm_card_vs_cpu(epsm_mesh["x"], epsm_mesh["y"])
    epsm_launches = {"launches_epsm_mesh_iteration": epsm_mesh["counts"],
                     "launches_epsm_cornellbox_run": epsm_cb["total"]}

    lap("11-13 epsm mesh, cornellbox, card vs cpu")

    # -- 14. [epsm experiments]: glass, rough metal and many objects --------
    epsm_exp = epsm_experiments_phase()
    epsm_launches["launches_epsm_experiments_runs"] = epsm_exp["total"]

    lap("14 epsm experiments")

    # -- 15. [scene files]: XML + PLY/OBJ/serialized, the CLI, traverse ------
    t0 = time.perf_counter()
    sf = scene_files_phase(gen)
    epsm_launches["launches_scene_files_phase"] = sf["total"]
    say(f"[scene files] phase {time.perf_counter() - t0:.1f} s")

    lap("15 scene files")

    # -- 16. [glassslab]: the normal-field experiment at its widths ----------
    t0 = time.perf_counter()
    gs = glassslab_phase()
    epsm_launches["launches_glassslab_run"] = gs["total"]
    say(f"[glassslab] phase {time.perf_counter() - t0:.1f} s")

    lap("16 glassslab")

    # -- 17. [camera]: filters, samplers and sensors on every path ----------
    t0 = time.perf_counter()
    cam = camera_phase()
    epsm_launches["launches_camera_phase"] = cam["total"]
    say(f"[camera] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{cam['total']}")

    lap("17 camera")

    # -- 18. [emitters]: every emitter kind on every render path -----------
    t0 = time.perf_counter()
    em = emitters_phase()
    epsm_launches["launches_emitters_phase"] = em["total"]
    say(f"[emitters] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{em['total']}")

    lap("18 emitters")

    # -- 19. [textures]: textured BSDFs, normal maps, spectra ----------------
    t0 = time.perf_counter()
    tx = textures_phase()
    epsm_launches["launches_textures_phase"] = tx["total"]
    say(f"[textures] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{tx['total']}")

    lap("19 textures")

    # -- 20. [bsdfs]: the remaining scalar BSDFs, mask, Beckmann -------------
    t0 = time.perf_counter()
    bs = bsdfs_phase()
    epsm_launches["launches_bsdfs_phase"] = bs["total"]
    say(f"[bsdfs] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{bs['total']}")

    lap("20 bsdfs")

    # -- 21. [human]: SMPL skinning, the pose bridge, the application layer --
    t0 = time.perf_counter()
    hu = human_phase(gen)
    epsm_launches["launches_human_phase"] = hu["total"]
    say(f"[human] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{hu['total']}")

    lap("21 human")

    # -- 22. [reparam]: prb_reparam on the human run, a silhouette, the BVH --
    t0 = time.perf_counter()
    rp = reparam_phase()
    epsm_launches["launches_reparam_phase"] = rp["total"]
    say(f"[reparam] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{rp['total']}")

    lap("22 reparam")

    # -- 23. [forward]: render_forward on the box, the mesh, prb_reparam -----
    t0 = time.perf_counter()
    fw = forward_phase()
    epsm_launches["launches_forward_phase"] = fw["total"]
    say(f"[forward] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{fw['total']}")

    lap("23 forward")

    # -- 24. [direct]: direct, direct_reparam, emission_reparam --------------
    t0 = time.perf_counter()
    di = direct_phase()
    epsm_launches["launches_direct_phase"] = di["total"]
    say(f"[direct] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{di['total']}")

    lap("24 direct")

    # -- 25. [outputs]: depth, aov, moment, ptracer, the spectral family ----
    t0 = time.perf_counter()
    ou = outputs_phase()
    epsm_launches["launches_outputs_phase"] = ou["total"]
    say(f"[outputs] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{ou['total']}")

    lap("25 outputs")

    # -- 26. [plugins]: the analytic sphere, the measured BSDF, the numpy
    # tree, the double variant and the six registries ----------------------
    t0 = time.perf_counter()
    pl = plugins_phase()
    epsm_launches["launches_plugins_phase"] = pl["total"]
    say(f"[plugins] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{pl['total']}")

    lap("26 plugins")

    # -- 27. [stokes]: polarized transport, the polarization elements and
    # the measured polarized BSDF ---------------------------------------
    t0 = time.perf_counter()
    sk = stokes_phase()
    epsm_launches["launches_stokes_phase"] = sk["total"]
    say(f"[stokes] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{sk['total']}")

    lap("27 stokes")

    # -- kernels line: launches of the fwd+bwd cells' last timed run ----------
    kernels = []
    for i, k in enumerate(("mt_closest_hit", "mt_any_hit")):
        v = times[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "epsm_mitsuba3_torch/csrc/mt_intersect.cu",
            "replaces": "epsm_mitsuba3_tpu/ops/pallas_intersect.py:25",
            "launches": train_box[k],
            "max_abs_err": max(e[i] for e in k1_err.values()),
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None,
            "steps_ms": {key: t[k]["steps_ms"]
                         for key, t in k1_times.items()},
            "ms_4096": {"65536": k1_times["ii"][k]["ms"],
                        "1048576": k1_times["iii"][k]["ms"]},
            "bound_ms_4096": {"65536": k1_times["ii"][k]["bound_ms"],
                              "1048576": k1_times["iii"][k]["bound_ms"]},
            "plain_ms_4096": {"65536": k1_times["ii"][k]["plain_ms"]},
            "render_rays_ms": [r["closest main" if i == 0 else "any main"]
                               for r in k1_render],
            "sweep_ms": {key: {"rule": row[k]["rule"], **row[k]["ms"]}
                         for key, row in k1_sweep.items()}})
    ref = bvh_times["bvh4_closest_hit_ref"]
    for i, (k, line, kk) in enumerate((("bvh4_closest_hit", 164, "K2"),
                                       ("bvh4_any_hit", 446, "K3"))):
        v = bvh_times[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "epsm_mitsuba3_torch/csrc/bvh_traverse.cu",
            "replaces": f"epsm_mitsuba3_tpu/ops/pallas_traverse.py:{line}",
            "launches": train_mesh[k], "max_abs_err": bvh["err"][i],
            "ms": v["ms"], "ms_unsorted": v["ms_unsorted"],
            "device_ms": v["device_ms"],
            "ms_sorted": v["ms_sorted"], "ms_presorted": v["ms_presorted"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None,
            "steps_ms": {n: {kind.split(" ", 1)[1]: t
                             for kind, t in ms.items()
                             if kind.startswith(kk)}
                         for n, ms in steps.items()},
            "render_rays_ms": [r[f"{kk}_ms"] for r in per_depth]})
    kernels[2].update({
        "reference_ms": ref["ms_unsorted"],
        "reference_ms_sorted": ref["ms_sorted"],
        "reference_ms_presorted": ref["ms_presorted"],
        "reference_render_rays_ms": [r["reference_ms"] for r in per_depth],
        "lane_utilisation": {k: v for k, v in lanes.items()
                             if not k.startswith("K4")}})
    v, v2 = bvh_times["bvh4_closest_hit_mp P=4"], bvh_times[
        "bvh4_closest_hit_mp P=2"]
    kernels.append({
        "name": "bvh4_closest_hit_mp", "route": "cuda",
        "source": "epsm_mitsuba3_torch/csrc/bvh_traverse.cu",
        "replaces": "epsm_mitsuba3_tpu/ops/pallas_traverse.py:308",
        "multi_pop": 4, "launches": train_mp["bvh4_closest_hit_mp"],
        "max_abs_err": k4[4]["err"], "tie_rays": k4[4]["ties"],
        "ms": v["ms"], "ms_sorted": v["ms_sorted"],
        "ms_presorted": v["ms_presorted"],
        "ms_p2": v2["ms"], "ms_p2_sorted": v2["ms_sorted"],
        "ms_p2_presorted": v2["ms_presorted"], "plain_ms": v["plain_ms"],
        "device_ms": v["device_ms"], "device_ms_p2": v2["device_ms"],
        "plain_ms_p2": v2["plain_ms"],
        "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
        "schedule_pops_per_ray": k4[4]["work"][0] / (RES * RES * MESH_CHUNK),
        "schedule_tests_per_ray": k4[4]["work"][1] / (RES * RES * MESH_CHUNK),
        "schedule_p2_pops_per_ray": k4[2]["work"][0] / (RES * RES
                                                        * MESH_CHUNK),
        "schedule_p2_tests_per_ray": k4[2]["work"][1] / (RES * RES
                                                         * MESH_CHUNK),
        "launch": dataclasses.asdict(CT.K4_SCHEDULE),
        "steps_ms": {k: t for k, t in k4_steps.items() if k.startswith("P=")},
        "k2_ms_beside_steps": k4_steps["K2"],
        "registers": k4_regs,
        "lane_utilisation": {k: v for k, v in lanes.items()
                             if k.startswith("K4")},
        "render_rays_ms": [r["K4 P=4_ms"] for r in per_depth],
        "render_rays_ms_p2": [r["K4 P=2_ms"] for r in per_depth],
        "library_ms": None})
    for entry in kernels:
        for key, counts in epsm_launches.items():
            entry[key] = counts.get(entry["name"], 0)
    for entry, kind in ((kernels[0], "closest"), (kernels[1], "any")):
        entry["human_rays"] = [
            {"depth": r["depth"], "rays": r["rays"],
             "live": r[f"live_{kind}"], "ms": r[f"{kind}_ms"],
             "bound_ms": r[f"{kind}_bound_ms"],
             "bound_by": r[f"{kind}_bound_by"],
             "plain_ms": r[f"{kind}_plain_ms"],
             "plain_rays": r["plain_rays"]}
            for r in hu["K1 on the body's rays"]]
        entry["human_iteration_launches"] = [
            r["counts"][entry["name"]] for r in hu["run"]["rows"]]
        entry["reparam_human_iteration_launches"] = [
            r["counts"][entry["name"]] for r in rp["run"]["rows"]]
    kernels[2]["reparam_mesh_backward_launches"] = rp["mesh pass"]["counts"][
        "bvh4_closest_hit"]
    kernels[2]["forward_reparam_mesh_launches"] = fw["reparam mesh"][
        "counts"]["bvh4_closest_hit"]
    kernels[2]["direct_reparam_mesh_backward_launches"] = di[
        "direct_reparam mesh"]["bwd"]["bvh4_closest_hit"]
    kernels[0]["emission_reparam_box_backward_launches"] = di[
        "emission_reparam box"]["bwd"]["mt_closest_hit"]
    kernels[1]["ptracer_connection_rays"] = ou["ptracer"]["k1_rays"]
    kernels[3]["ptracer_connection_rays"] = ou["ptracer"]["k3_rays"]
    # each kernel on the experiments' own rays: K1 at egg's 3,972
    # triangles, K2/K3 on shadow's 1,587,204
    for entry, rows, kind in ((kernels[0], epsm_exp["k1"], "closest"),
                              (kernels[1], epsm_exp["k1"], "any"),
                              (kernels[2], epsm_exp["k23"], "closest"),
                              (kernels[3], epsm_exp["k23"], "any")):
        scene = "egg" if entry["name"].startswith("mt_") else "shadow"
        entry[f"{scene}_rays"] = [
            {"depth": r["depth"], "rays": r["rays"],
             "live": r[f"live_{kind}"], "ms": r[f"{kind}_ms"],
             "bound_ms": r[f"{kind}_bound_ms"],
             "bound_by": r[f"{kind}_bound_by"],
             "plain_ms": r[f"{kind}_plain_ms"],
             "plain_rays": r["plain_rays"]} for r in rows]
    say(f"[time] chip_smoke.py ran {time.perf_counter() - start:.1f} s, "
        f"the kernels' build included")
    say(json.dumps({"kernels": kernels}))
    say(f"[device] {gpu}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

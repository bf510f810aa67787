"""Command-line renderer (counterpart of ``cli.py``, the ``mitsuba`` CLI of
src/mitsuba/mitsuba.cpp:162-177).

  python -m epsm_mitsuba3_torch.cli scene.xml -o out.exr -s 0 \
      -D key=value --spp 64 --integrator path --depth 6 [--device cpu]

Loads an XML scene (``core/xmlparse.py``) with -D parameter
substitution under the variant ``-m`` (``config.py`` ``set_variant``),
renders any sensor with the spp, integrator and depth
given, and writes EXR, PFM, NPY or (with PIL) PNG.  The render runs on
the GPU unless ``--device`` names another device; without CUDA the
default raises.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="epsm-mitsuba3-torch",
        description="Differentiable path tracer (EPSM), PyTorch/CUDA")
    ap.add_argument("scene", help="scene .xml file")
    ap.add_argument("-o", "--output", default="output.exr")
    ap.add_argument("-s", "--sensor", type=int, default=0)
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value", help="scene parameter substitution")
    ap.add_argument("--spp", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--integrator", default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("-m", "--mode", default="cuda_ad_rgb",
                    help="variant name (set_variant): a *_double name "
                    "renders in float64")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    from .ad.render import render
    from .config import set_variant
    from .core.bitmap import write_image
    from .core.device import resolve_device
    from .core.xmlparse import load_file

    device = resolve_device(args.device)
    set_variant(args.mode)
    params = dict(d.split("=", 1) for d in args.define)
    t0 = time.time()
    scene = load_file(args.scene, parameters=params or None, device=device)
    print(f"[epsm-mi3-torch] loaded '{args.scene}' "
          f"({len(scene.static.shape_names)} shapes, "
          f"{scene.faces.shape[0]} triangles) in {time.time() - t0:.2f}s")

    integrator = None
    if args.integrator or args.depth:
        integrator = {}
        if args.integrator:
            integrator["type"] = args.integrator
        if args.depth:
            integrator["max_depth"] = args.depth

    t0 = time.time()
    img = render(scene, spp=args.spp, seed=args.seed, sensor=args.sensor,
                 integrator=integrator, device=device)
    img = img.detach().cpu().numpy()
    h, w = img.shape[:2]
    print(f"[epsm-mi3-torch] rendered {w}x{h} in {time.time() - t0:.2f}s")

    write_image(args.output, img[..., :3])
    print(f"[epsm-mi3-torch] wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

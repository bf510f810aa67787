"""Experiment launcher (counterpart of ``app/run_experiments.py``, the
reference's ``EPSM/all.sh`` and ``test.sh``).

  python -m epsm_mitsuba3_torch.app.run_experiments METHOD EXP [--small]
      [--device DEVICE]

METHOD in {manifold, manifold_caustic, manifold_hybrid,
manifold_caustic_hybrid, prb, prb_reparam, path}; EXP in the exp/ module
list.  ``--small`` shrinks resolutions and iterations for smoke runs.
Logs go to ``results/EXP/METHOD`` under the working directory.  The run
is on the GPU unless ``--device`` names another device.
NOTE: the reference's all.sh also lists ``manifold_shadow``, which the
reference never registers either; it is rejected here.
"""
from __future__ import annotations

import importlib
import sys

EXPERIMENTS = ("bathroom", "bedroom", "bunny", "cornellbox", "egg",
               "glassslab", "glossyball", "highlight", "shadow", "human")
METHODS = ("manifold", "manifold_caustic", "manifold_hybrid",
           "manifold_caustic_hybrid", "prb", "prb_reparam", "path")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    method, exp_name = argv[0], argv[1]
    small = "--small" in argv
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs a value")
        device = argv[i + 1]
    if method not in METHODS:
        raise SystemExit(f"unknown METHOD '{method}' (choose {METHODS})")
    if exp_name not in EXPERIMENTS:
        raise SystemExit(f"unknown EXP '{exp_name}' (choose {EXPERIMENTS})")

    mod = importlib.import_module(f"epsm_mitsuba3_torch.app.exp.{exp_name}")
    kwargs = {"device": device}
    if small:
        kwargs.update(resolution=64, spp=8, it=20, match_res=64)
        if exp_name in ("shadow",):
            kwargs["n_objects"] = 16
    exp = mod.make(**kwargs)
    from . import optim
    opt, history = optim.run(method, exp,
                             log_dir=f"results/{exp_name}/{method}")
    print("final:", exp["output"](dict(opt.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

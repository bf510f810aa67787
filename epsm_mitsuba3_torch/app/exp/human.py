"""The human pose experiment (counterpart of ``app/exp/human.py``, the
reference's ``EPSM/exp/human.py`` and ``optim_human.py``): a 72-d SMPL
pose, turned into the body's vertices by linear blend skinning
(``models/smpl.py``), is the latent.  The default body is the procedural
capsule body; ``smpl_npz=`` loads a real SMPL release file instead.

Budgets (EPSM/exp/human.py:6-11): 512^2, 64 spp, depth 3, 1000
iterations, ``match_res`` 256, a 72-d pose.  ``app/optim_human.run``
drives it: its two-stage bridge needs the returned ``model`` and
``set_verts``.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ...core.transform import ScalarTransform4f as T
from ...models import smpl
from ...models.scene import load_dict
from . import common as C

N_JOINTS = smpl.N_JOINTS
POSE_DIM = smpl.POSE_DIM       # 72, as in the reference

# joints perturbed in the initial pose (shoulders and elbows), axis-angle
_PERTURB = (16, 17, 18, 19)


def make(resolution=512, spp=64, it=1000, thres=10 ** 9, max_depth=3,
         match_res=256, smpl_npz: str = None, device=None):
    """The experiment dict of ``app/optim_human.run`` (and of
    ``app/optim.run``); ``device=None`` means the GPU."""
    model = (smpl.load_npz(smpl_npz, device=device) if smpl_npz
             else smpl.procedural_template(device=device))
    template_v = model.template.cpu().numpy()

    d = {"type": "scene",
         "integrator": {"type": "manifold", "max_depth": max_depth}}
    d.update(C.three_sensors(T, [0, 1.0, 3.5], [0, 0.9, 0], [0, 1, 0],
                             resolution, match_res, spp))
    d["floor"] = {"type": "rectangle",
                  "to_world": T.scale(4).rotate([1, 0, 0], -90),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "rgb", "value": 0.7}}}
    d["light"] = {"type": "rectangle",
                  "to_world": T.look_at(origin=[1.5, 3, 2],
                                        target=[0, 1, 0],
                                        up=[0, 1, 0]).scale(0.4),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb", "value": 25.0}}}
    # the template as an OBJ, which the scene builder reads (as the
    # reference does)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "human.obj")
        with open(path, "w") as f:
            for v in template_v:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for tri in model.faces + 1:
                f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
        d["human"] = {"type": "obj", "filename": path,
                      "bsdf": {"type": "diffuse",
                               "reflectance": {"type": "rgb",
                                               "value": [0.8, 0.6, 0.5]}}}
        scene = load_dict(d, device=model.template.device)
    dev = scene.device
    s, c = C.shape_range(scene, "human")

    def set_verts(scene, v):
        """The scene with the body's rows s:s+c replaced by ``v``
        (differentiable in it)."""
        vs = scene.vertices
        return scene.set_vertices(torch.cat([vs[:s], v.to(vs.dtype),
                                             vs[s + c:]]))

    def apply(scene, theta):
        return set_verts(scene, smpl.lbs(model, theta["pose"]))

    rng = np.random.default_rng(5)
    init_pose = np.zeros(POSE_DIM, np.float32)
    for j in _PERTURB:
        init_pose[3 * j: 3 * j + 3] = rng.uniform(-0.35, 0.35, 3)

    return {
        "scene": scene,
        "model": model,                       # for the optim_human bridge
        "set_verts": set_verts,
        "it": it, "spp": spp, "resolution": resolution, "thres": thres,
        "max_depth": max_depth, "match_res": match_res,
        "init_theta": {"pose": torch.from_numpy(init_pose).to(dev)},
        "target_theta": {"pose": torch.zeros(POSE_DIM, device=dev)},
        "apply": apply,
        "output": lambda th: "|pose|={:.4f}".format(float(
            torch.as_tensor(th["pose"]).abs().mean())),
    }

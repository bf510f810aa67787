"""SMPL-compatible articulated body model, linear blend skinning
(counterpart of ``models/smpl.py``; the reference drives a real SMPL body
through ``smplpytorch``, EPSM/exp/human.py:197-265).

The standard 24-joint SMPL tree, a 72-d axis-angle pose and the
homogeneous-transform skinning of SMPL's eq. 2-4.  The learned SMPL data
is not shipped with the reference either; ``procedural_template`` builds a
capsule body in the rest pose with smooth blend weights (host numpy, the
same arrays as the JAX package's, bit for bit), and ``load_npz`` reads a
release file the user brings (its field names).  ``from_numpy`` wraps
arrays of another model, e.g. the JAX package's, as this one's.

``lbs`` runs its products in full float32: on the card a TF32 product
would move the vertices by about 1e-3 of their size.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.sinkhorn import full_f32_matmul
from ..utils.rotation import so3_exp

# The standard SMPL joint hierarchy (smplpytorch's kintree_table)
SMPL_JOINT_NAMES = (
    "pelvis", "l_hip", "r_hip", "spine1", "l_knee", "r_knee", "spine2",
    "l_ankle", "r_ankle", "spine3", "l_foot", "r_foot", "neck",
    "l_collar", "r_collar", "head", "l_shoulder", "r_shoulder",
    "l_elbow", "r_elbow", "l_wrist", "r_wrist", "l_hand", "r_hand",
)
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21)
N_JOINTS = 24
POSE_DIM = N_JOINTS * 3          # 72, as in the reference (optim_human.py)

# T-pose joint offsets from the parent (meters, y up, left = -x, arms
# along x)
_OFFSETS = np.array([
    (0.00, 0.95, 0.00),    # pelvis (world)
    (-0.09, -0.06, 0.00),  # l_hip
    (0.09, -0.06, 0.00),   # r_hip
    (0.00, 0.11, 0.00),    # spine1
    (0.00, -0.38, 0.00),   # l_knee
    (0.00, -0.38, 0.00),   # r_knee
    (0.00, 0.12, 0.00),    # spine2
    (0.00, -0.40, 0.00),   # l_ankle
    (0.00, -0.40, 0.00),   # r_ankle
    (0.00, 0.12, 0.00),    # spine3
    (0.00, -0.06, 0.12),   # l_foot
    (0.00, -0.06, 0.12),   # r_foot
    (0.00, 0.09, 0.00),    # neck
    (-0.08, 0.04, 0.00),   # l_collar
    (0.08, 0.04, 0.00),    # r_collar
    (0.00, 0.11, 0.00),    # head
    (-0.10, 0.00, 0.00),   # l_shoulder
    (0.10, 0.00, 0.00),    # r_shoulder
    (-0.26, 0.00, 0.00),   # l_elbow
    (0.26, 0.00, 0.00),    # r_elbow
    (-0.25, 0.00, 0.00),   # l_wrist
    (0.25, 0.00, 0.00),    # r_wrist
    (-0.08, 0.00, 0.00),   # l_hand
    (0.08, 0.00, 0.00),    # r_hand
], np.float32)

# capsule radius per bone (indexed by the bone's *parent* joint)
_BONE_RADIUS = {
    0: 0.11, 1: 0.07, 2: 0.07, 3: 0.11, 4: 0.055, 5: 0.055, 6: 0.115,
    7: 0.045, 8: 0.045, 9: 0.10, 12: 0.05, 13: 0.05, 14: 0.05,
    16: 0.045, 17: 0.045, 18: 0.035, 19: 0.035, 20: 0.03, 21: 0.03,
}
_HEAD_RADIUS = 0.105


class SMPLModel(NamedTuple):
    """Static model data: tensors on one device, the faces and the tree
    on the host."""
    template: torch.Tensor     # (V, 3) rest-pose vertices
    faces: np.ndarray          # (F, 3) int32 (static topology)
    weights: torch.Tensor      # (V, J) LBS blend weights, rows sum to 1
    joints: torch.Tensor       # (J, 3) rest joint positions
    parents: tuple             # static kinematic tree


def rest_joints() -> np.ndarray:
    pos = np.zeros((N_JOINTS, 3), np.float32)
    for j, p in enumerate(SMPL_PARENTS):
        pos[j] = (_OFFSETS[j] + pos[p]) if p >= 0 else _OFFSETS[j]
    return pos


def _bones():
    """(parent_joint, a, b) influence segments: one per (parent->child),
    and the head's stub."""
    joints = rest_joints()
    out = []
    for j, p in enumerate(SMPL_PARENTS):
        if p >= 0:
            out.append((p, joints[p], joints[j]))
    out.append((15, joints[15], joints[15] + np.array([0, 0.12, 0],
                                                      np.float32)))
    return out


def _capsule(a, b, radius, n_seg=10, n_ring=8):
    """Capsule mesh from a to b (host numpy; static topology):
    (n_seg + 1) rings of n_ring vertices, 2 n_seg n_ring faces."""
    d = b - a
    length = float(np.linalg.norm(d))
    axis = d / max(length, 1e-8)
    up = np.array([1.0, 0, 0]) if abs(axis[1]) > 0.9 else np.array([0, 1.0, 0])
    x = np.cross(up, axis)
    x /= np.linalg.norm(x)
    y = np.cross(axis, x)
    verts, faces = [], []
    rows = []
    for i in range(n_seg + 1):
        t = i / n_seg
        # hemispherical end caps blended into the cylinder
        if t < 0.25:
            r = radius * np.sin(np.pi / 2 * (t / 0.25))
            h = -radius * np.cos(np.pi / 2 * (t / 0.25))
            c = a + axis * h
        elif t > 0.75:
            s = (t - 0.75) / 0.25
            r = radius * np.cos(np.pi / 2 * s)
            c = b + axis * (radius * np.sin(np.pi / 2 * s))
        else:
            r = radius
            c = a + axis * ((t - 0.25) / 0.5 * length)
        ring = []
        for k in range(n_ring):
            ang = 2 * np.pi * k / n_ring
            ring.append(c + r * (np.cos(ang) * x + np.sin(ang) * y))
        rows.append(len(verts))
        verts.extend(ring)
    for i in range(n_seg):
        r0, r1 = rows[i], rows[i + 1]
        for k in range(n_ring):
            k2 = (k + 1) % n_ring
            faces.append((r0 + k, r1 + k, r1 + k2))
            faces.append((r0 + k, r1 + k2, r0 + k2))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _blend_weights(verts: np.ndarray, sigma: float = 0.05,
                   top_k: int = 4) -> np.ndarray:
    """Smooth LBS weights: a Gaussian falloff of the distance to each
    joint's influence segment, cut to the ``top_k`` nearest joints and
    renormalised (the SMPL release caps at 4 joints a vertex too)."""
    segs = _bones()
    d = np.full((len(verts), N_JOINTS), np.inf, np.float32)
    for pj, a, b in segs:
        ab = b - a
        denom = max(float(ab @ ab), 1e-12)
        t = np.clip(((verts - a) @ ab) / denom, 0.0, 1.0)
        proj = a + t[:, None] * ab
        dist = np.linalg.norm(verts - proj, axis=1)
        d[:, pj] = np.minimum(d[:, pj], dist)
    w = np.exp(-(d / sigma) ** 2)
    idx = np.argsort(-w, axis=1)[:, :top_k]
    mask = np.zeros_like(w)
    np.put_along_axis(mask, idx, 1.0, axis=1)
    w = w * mask
    s = w.sum(axis=1, keepdims=True)
    # degenerate rows: snap to the single nearest joint
    nearest = np.argmin(d, axis=1)
    w = np.where(s > 1e-12, w / np.maximum(s, 1e-12),
                 np.eye(N_JOINTS, dtype=np.float32)[nearest])
    return w.astype(np.float32)


def from_numpy(template, faces, weights, joints, parents=SMPL_PARENTS,
               device=None) -> SMPLModel:
    """An SMPLModel of host arrays (another package's model's, a file's)
    with its tensors on ``device``; ``device=None`` means the GPU."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    return SMPLModel(template=f32(template),
                     faces=np.asarray(faces, np.int32),
                     weights=f32(weights), joints=f32(joints),
                     parents=tuple(int(p) for p in parents))


def procedural_template(device=None) -> SMPLModel:
    """The procedural capsule body in the SMPL rest pose with smooth blend
    weights, standing in for the learned SMPL template (2,112 vertices,
    3,840 faces); ``device=None`` means the GPU."""
    dev = resolve_device(device)
    verts, faces = [], []
    off = 0
    for pj, a, b in _bones():
        r = _HEAD_RADIUS if pj == 15 else _BONE_RADIUS.get(pj, 0.05)
        v, f = _capsule(a, b, r)
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    v = np.concatenate(verts)
    f = np.concatenate(faces)
    return from_numpy(v, f, _blend_weights(v), rest_joints(), SMPL_PARENTS,
                      dev)


def load_npz(path: str, device=None) -> SMPLModel:
    """A real SMPL parameter file (the release's field names: v_template,
    f, weights, J or J_regressor, kintree_table); ``device=None`` means
    the GPU.  The root's parent is -1 whatever the file says (the
    reference's ``(-1,) + parents[1:]``)."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=True)
    v = np.asarray(z["v_template"], np.float32)
    joints = (np.asarray(z["J"], np.float32) if "J" in z
              else np.asarray(z["J_regressor"] @ v, np.float32))
    parents = tuple(int(x) for x in np.asarray(z["kintree_table"])[0]) \
        if "kintree_table" in z else SMPL_PARENTS
    parents = (-1,) + parents[1:]
    return from_numpy(v, z["f"], z["weights"], joints, parents, dev)


def lbs(model: SMPLModel, pose: torch.Tensor,
        trans: torch.Tensor = None) -> torch.Tensor:
    """SMPL linear blend skinning (SMPL eq. 2-4; the smplpytorch forward of
    optim_human.py:123-131): pose (72,) or (24, 3) axis-angle, trans an
    optional (3,) root translation -> the posed vertices (V, 3),
    differentiable in both.

    The reference's ``einsum("vj,jab,vb->va", W, Rw, template)
    + W @ t_rel`` is contracted weights first, as SMPL does: one product
    W @ [Rw | t_rel] (V, J) x (J, 12) gives each vertex's blended
    transform, which then moves its template vertex.  XLA may order the
    sums otherwise, so the two agree to float32 rounding, not bit for
    bit."""
    pose = pose.reshape(N_JOINTS, 3)
    joints, parents = model.joints, model.parents
    with full_f32_matmul():
        R = so3_exp(pose)                               # (J, 3, 3)
        # forward kinematics in the tree's order: G_j = G_parent [R_j | j_rel]
        Rw = [None] * N_JOINTS
        tw = [None] * N_JOINTS
        for j in range(N_JOINTS):
            p = parents[j]
            if p < 0:
                Rw[j] = R[j]
                tw[j] = joints[j]
            else:
                Rw[j] = Rw[p] @ R[j]
                tw[j] = Rw[p] @ (joints[j] - joints[p]) + tw[p]
        Rw = torch.stack(Rw)                            # (J, 3, 3)
        tw = torch.stack(tw)                            # (J, 3)
        # A_j = G_j inv(G_j^rest): its translation tw - Rw @ rest_j
        t_rel = tw - (Rw @ joints[:, :, None])[:, :, 0]
        blended = model.weights @ torch.cat(
            [Rw.reshape(N_JOINTS, 9), t_rel], 1)       # (V, 12)
    n = blended.shape[0]
    v = torch.sum(blended[:, :9].reshape(n, 3, 3)
                  * model.template[:, None, :], -1) + blended[:, 9:]
    if trans is not None:
        v = v + trans
    return v

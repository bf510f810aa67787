"""Checkpoint and resume (counterpart of ``utils/checkpoint.py``; the
reference has none, its Logger only dumps each iteration's npy files).

The files and keys are the JAX package's, so a checkpoint written by
either package loads in the other: ``save`` writes ``ckpt_{it}/`` with
``arrays.npz`` (``theta.*``, ``opt_*``) and ``meta.json``;
``save_optimizer`` writes ``opt_{it}.npz`` (``var.*``, ``state.*.j``) and
``opt_{it}.json``; both update ``latest``.  Arrays are written as numpy
from any device; ``load_optimizer`` puts them on the optimizer's device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from .logger import host_array


def _flatten(tree, leaves: list) -> str:
    """Append the leaves of a nest of dicts (keys sorted), lists and
    tuples to ``leaves`` in order; returns the nest's structure, with
    ``*`` for each leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(x, leaves) for x in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    leaves.append(tree)
    return "*"


def save(path: str, it: int, theta: Dict[str, Any], opt_state: Any = None,
         seed: int = 0, extra: Optional[Dict] = None):
    """Save an optimisation checkpoint (written to a temporary directory,
    then renamed)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".tmp_{it}")
    os.makedirs(tmp, exist_ok=True)
    meta = {
        "it": it,
        "seed": seed,
        "theta_keys": sorted(theta.keys()),
        "extra": extra or {},
    }
    flat = {f"theta.{k}": host_array(theta[k]) for k in meta["theta_keys"]}
    if opt_state is not None:
        leaves = []
        meta["opt_treedef"] = _flatten(opt_state, leaves)
        flat.update({f"opt_{i}": host_array(x) for i, x in enumerate(leaves)})
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    final = os.path.join(path, f"ckpt_{it}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(str(it))
    return final


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def load(path: str, it: Optional[int] = None):
    """(it, theta dict, flat optimizer-state arrays, meta) of the
    checkpoint ``it`` (default the latest), numpy arrays; None if
    there is none."""
    if it is None:
        it = latest_step(path)
        if it is None:
            return None
    d = os.path.join(path, f"ckpt_{it}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    arrays = np.load(os.path.join(d, "arrays.npz"))
    theta = {k: arrays[f"theta.{k}"] for k in meta["theta_keys"]}
    opt = {k: arrays[k] for k in arrays.files if k.startswith("opt_")}
    return meta["it"], theta, opt, meta


def save_optimizer(path: str, it: int, opt, seed: int = 0):
    """Checkpoint an ``ad.optimizers`` Optimizer (variables, state, t)."""
    state_flat = {}
    for k, st in opt.state.items():
        for j, arr in enumerate(st):
            state_flat[f"state.{k}.{j}"] = host_array(arr)
    extra = {"t": getattr(opt, "t", None) and dict(opt.t),
             "lr": opt.lr_default}
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"opt_{it}.npz"),
             **{f"var.{k}": host_array(v) for k, v in opt.variables.items()},
             **state_flat)
    with open(os.path.join(path, f"opt_{it}.json"), "w") as f:
        json.dump({"it": it, "seed": seed, "extra": extra}, f)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(str(it))


def load_optimizer(path: str, opt, it: Optional[int] = None) -> int:
    """Restore an Optimizer in place, each tensor on the device of the
    variable it replaces; returns the iteration to resume at (0 without
    a checkpoint)."""
    if it is None:
        it = latest_step(path)
        if it is None:
            return 0
    arrays = np.load(os.path.join(path, f"opt_{it}.npz"))
    with open(os.path.join(path, f"opt_{it}.json")) as f:
        meta = json.load(f)
    for k in list(opt.variables.keys()):
        if f"var.{k}" in arrays:
            opt.variables[k] = torch.from_numpy(arrays[f"var.{k}"]).to(
                opt.variables[k].device)
    for k in list(opt.state.keys()):
        dev = opt.variables[k].device
        parts = []
        j = 0
        while f"state.{k}.{j}" in arrays:
            parts.append(torch.from_numpy(arrays[f"state.{k}.{j}"]).to(dev))
            j += 1
        if parts:
            opt.state[k] = tuple(parts)
    t = meta.get("extra", {}).get("t")
    if t and hasattr(opt, "t"):
        opt.t.update({k: int(v) for k, v in t.items()})
    return meta["it"] + 1

"""Optimizers (counterpart of ``ad/optimizers.py``): a dict-like
container of latent variables whose ``step`` takes the gradients and
updates the variables.  ``Adam`` has ``mask_updates`` (entries whose
gradient is zero keep their state and value) and ``uniform`` (UniformAdam,
Nicolet et al. 2021: the scalar max of the second moment), as
optimizers.py:204-309.  Variables are float32 tensors on the device of the
value given; gradients are passed to ``step({key: grad})``, e.g. from
``torch.autograd.grad`` through ``render``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


class Optimizer:
    """Dict-like parameter container (optimizers.py:6-110)."""

    def __init__(self, lr: float, params: Optional[Dict] = None):
        self.lr_default = lr
        self.lr: Dict[str, float] = {}
        self.variables: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, tuple] = {}
        if params:
            for k, v in params.items():
                self[k] = v

    def __contains__(self, key):
        return key in self.variables

    def __getitem__(self, key):
        return self.variables[key]

    def __setitem__(self, key, value):
        value = torch.as_tensor(value, dtype=torch.float32).detach()
        needs_reset = (key not in self.variables
                       or self.variables[key].shape != value.shape)
        self.variables[key] = value
        if needs_reset:
            self.reset(key)

    def __delitem__(self, key):
        del self.variables[key]
        self.state.pop(key, None)

    def __len__(self):
        return len(self.variables)

    def keys(self):
        return self.variables.keys()

    def items(self):
        return self.variables.items()

    def set_learning_rate(self, lr, key: Optional[str] = None):
        if key is None:
            self.lr_default = lr
        else:
            self.lr[key] = lr

    def _lr(self, key):
        return self.lr.get(key, self.lr_default)

    def reset(self, key):
        raise NotImplementedError


class SGD(Optimizer):
    """SGD with optional momentum (optimizers.py:112-200)."""

    def __init__(self, lr: float, momentum: float = 0.0,
                 params: Optional[Dict] = None):
        if not 0.0 <= momentum < 1.0:
            raise ValueError(f"momentum {momentum} outside [0, 1)")
        self.momentum = momentum
        super().__init__(lr, params)

    def reset(self, key):
        self.state[key] = (torch.zeros_like(self.variables[key]),)

    def step(self, grads: Dict[str, torch.Tensor]):
        for k, g in grads.items():
            if k not in self.variables:
                continue
            p = self.variables[k]
            g = torch.nan_to_num(torch.as_tensor(g, dtype=torch.float32,
                                                 device=p.device))
            if self.momentum != 0.0:
                (vel,) = self.state[k]
                vel = self.momentum * vel + g
                self.state[k] = (vel,)
                g = vel
            self.variables[k] = p - self._lr(k) * g


class Adam(Optimizer):
    """Adam / UniformAdam with mask_updates (optimizers.py:204-309)."""

    def __init__(self, lr: float, beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-8, mask_updates: bool = False,
                 uniform: bool = False, params: Optional[Dict] = None):
        if not (0 <= beta_1 < 1 and 0 <= beta_2 < 1 and lr > 0
                and epsilon > 0):
            raise ValueError("Adam: needs 0 <= beta < 1, lr > 0, eps > 0")
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.mask_updates = mask_updates
        self.uniform = uniform
        self.t: Dict[str, int] = {}
        super().__init__(lr, params)

    def reset(self, key):
        v = self.variables[key]
        self.state[key] = (torch.zeros_like(v), torch.zeros_like(v))
        self.t[key] = 0

    def step(self, grads: Dict[str, torch.Tensor]):
        for k, g in grads.items():
            if k not in self.variables:
                continue
            p = self.variables[k]
            g = torch.nan_to_num(torch.as_tensor(g, dtype=torch.float32,
                                                 device=p.device))
            self.t[k] += 1
            t = self.t[k]
            lr_scale = (1 - self.beta_2 ** t) ** 0.5 / (1 - self.beta_1 ** t)
            lr_t = self._lr(k) * lr_scale
            m_tp, v_tp = self.state[k]
            m_t = self.beta_1 * m_tp + (1 - self.beta_1) * g
            v_t = self.beta_2 * v_tp + (1 - self.beta_2) * g * g
            if self.mask_updates:
                nonzero = g != 0.0
                m_t = torch.where(nonzero, m_t, m_tp)
                v_t = torch.where(nonzero, v_t, v_tp)
            self.state[k] = (m_t, v_t)
            if self.uniform:
                step = lr_t * m_t / (torch.sqrt(torch.amax(v_t))
                                     + self.epsilon)
            else:
                step = lr_t * m_t / (torch.sqrt(v_t) + self.epsilon)
            if self.mask_updates:
                step = torch.where(nonzero, step, 0.0)
            self.variables[k] = p - step

"""The optimizer chain of the train CLI (counterpart of
mvs_tpu.cli.train.build_optimizer), computing what optax computes.

    clip_by_global_norm (train.grad_clip > 0)
    -> add_decayed_weights (train.weight_decay > 0: L2 added to the
       gradient, not AdamW's decoupled decay)
    -> adam | rmsprop (decay 0.9) | sgd (momentum 0.9) | radam
    -> scale by -lr, lr = schedule(count) at the count before the update.

Each rule is optax 0.2.6's, not torch.optim's where they differ: rmsprop
divides by sqrt(nu + eps) (optax's eps_in_sqrt=True) where torch.optim
divides by sqrt(nu) + eps, and radam rectifies when rho >= 5. The scalar
factors (bias corrections, radam's rho and rectification) are taken in
float32, as optax takes them. 'ranger' (lookahead over radam) is not
ported: optax.lookahead raises on the plain parameters the JAX CLI passes
it (ROADMAP.md section 3).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["OPTIMIZERS", "OptaxChain"]

OPTIMIZERS = ("adam", "rmsprop", "sgd", "radam")
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_RMS_DECAY, _SGD_MOMENTUM, _RADAM_THRESHOLD = 0.9, 0.9, 5.0
_F32 = np.float32


class OptaxChain:
    """clip -> decay -> rule -> -lr over `params`, updated in place by
    step(). ``count`` is the number of updates made (optax's step count)."""

    def __init__(self, params, name: str, schedule, grad_clip: float = 0.0,
                 weight_decay: float = 0.0):
        if name == "ranger":
            raise NotImplementedError(
                "optimizer 'ranger' is not ported: optax.lookahead raises "
                "AttributeError on the plain parameters mvs_tpu.cli.train "
                "passes it (ROADMAP.md section 3)")
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}; options: "
                             f"{OPTIMIZERS}")
        self.params = list(params)
        self.name = name
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.count = 0
        # adam / radam: (mu, nu); rmsprop: (nu,); sgd: (trace,)
        slots = {"adam": 2, "radam": 2, "rmsprop": 1, "sgd": 1}[name]
        self.slots = [[torch.zeros_like(p) for p in self.params]
                      for _ in range(slots)]

    @torch.no_grad()
    def step(self, grads=None) -> float:
        """One update from `grads` (default: each parameter's .grad; a
        missing gradient counts as zero). Returns the learning rate used."""
        if grads is None:
            grads = [p.grad for p in self.params]
        g = [torch.zeros_like(p) if t is None else t.detach().clone()
             for p, t in zip(self.params, grads)]
        if self.grad_clip > 0:
            norm = torch.sqrt(sum(torch.sum(t.float() ** 2) for t in g))
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            for t in g:
                t.mul_(scale.to(t.dtype))
        if self.weight_decay > 0:
            for t, p in zip(g, self.params):
                t.add_(p, alpha=self.weight_decay)
        lr = float(self.schedule(self.count))
        self.count += 1
        updates = getattr(self, f"_{self.name}")(g, self.count)
        for p, u in zip(self.params, updates):
            p.sub_(lr * u)
        return lr

    def _moments(self, g, t):
        """Adam's bias-corrected moments, updated in place."""
        mu, nu = self.slots
        for m, v, x in zip(mu, nu, g):
            m.mul_(_B1).add_((1 - _B1) * x)
            v.mul_(_B2).add_((1 - _B2) * x * x)
        bc1, bc2 = (float(_F32(1) - _F32(b) ** _F32(t)) for b in (_B1, _B2))
        return [m / bc1 for m in mu], [v / bc2 for v in nu]

    def _adam(self, g, t):
        mu_hat, nu_hat = self._moments(g, t)
        return [m / (torch.sqrt(v) + _EPS) for m, v in zip(mu_hat, nu_hat)]

    def _radam(self, g, t):
        mu_hat, nu_hat = self._moments(g, t)
        ro_inf = 2.0 / (1.0 - _B2) - 1.0
        b2t = _F32(_B2) ** _F32(t)
        ro = _F32(ro_inf) - _F32(2 * t) * b2t / (_F32(1) - b2t)
        if ro < _RADAM_THRESHOLD:
            return mu_hat
        r = float(np.sqrt((ro - _F32(4)) * (ro - _F32(2)) * _F32(ro_inf)
                          / (_F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        return [r * m / (torch.sqrt(v) + _EPS)
                for m, v in zip(mu_hat, nu_hat)]

    def _rmsprop(self, g, t):
        (nu,) = self.slots
        out = []
        for v, x in zip(nu, g):
            v.mul_(_RMS_DECAY).add_((1 - _RMS_DECAY) * x * x)
            out.append(x * torch.rsqrt(v + _EPS))
        return out

    def _sgd(self, g, t):
        (trace,) = self.slots
        for tr, x in zip(trace, g):
            tr.mul_(_SGD_MOMENTUM).add_(x)
        return trace

    def state_dict(self) -> dict:
        return {"name": self.name, "count": self.count,
                "slots": [[s.detach().cpu() for s in slot]
                          for slot in self.slots]}

    def load_state_dict(self, state: dict) -> None:
        if state["name"] != self.name:
            raise ValueError(f"optimizer state of {state['name']!r}, this "
                             f"chain runs {self.name!r}")
        self.count = int(state["count"])
        for slot, saved in zip(self.slots, state["slots"]):
            for s, x in zip(slot, saved):
                s.copy_(x)

"""Base first-order update rules (the paper's baselines, §2/§4.3).

Port of ``repro.optim.base``. Each rule is a pair of functions:

  init(params)                        -> state
  apply(state, params, grads, lr)     -> state

``params`` and ``grads`` are equal-length lists of tensors. Unlike the JAX
package, ``apply`` updates the parameters IN PLACE under
``torch.no_grad()`` (the weights of a 0.3 B model are not copied on every
step), and updates the rule's own state tensors in place too; it returns
the state for symmetry with the JAX signature.

Every rule keeps the JAX package's precision order: upcast the weight and
gradient to f32, compute the update in f32, cast the result back to the
weight's dtype. The state (velocity, moments) is f32.

  SGD       w' = w - lr * g                              (Eq. 4)
  Momentum  v' = mu*v - lr*g ; w' = w + v'               (Eq. 19)
  Nesterov  v' = mu*v - lr*g ; w' = w + mu*v' - lr*g     (Eq. 20, Sutskever form)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class UpdateRule:
    name: str
    init: Callable
    apply: Callable          # (state, params, grads, lr) -> state


def _zeros_f32(params):
    return [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            for w in params]


def _grad_f32(g, w, weight_decay):
    return g.to(torch.float32) + weight_decay * w.to(torch.float32)


def sgd(weight_decay: float = 0.0) -> UpdateRule:
    def init(params):
        return ()

    @torch.no_grad()
    def apply(state, params, grads, lr):
        for w, g in zip(params, grads):
            g = _grad_f32(g, w, weight_decay)
            w.copy_((w.to(torch.float32) - lr * g).to(w.dtype))
        return state

    return UpdateRule("sgd", init, apply)


def momentum(mu: float = 0.9, weight_decay: float = 0.0) -> UpdateRule:
    @torch.no_grad()
    def apply(vel, params, grads, lr):
        for v, w, g in zip(vel, params, grads):
            g = _grad_f32(g, w, weight_decay)
            v.copy_(mu * v - lr * g)
            w.copy_((w.to(torch.float32) + v).to(w.dtype))
        return vel

    return UpdateRule("momentum", _zeros_f32, apply)


def nesterov(mu: float = 0.9, weight_decay: float = 0.0) -> UpdateRule:
    """Nesterov accelerated gradient in the Sutskever transformed form:
    v' = mu*v - lr*g(w);  w' = w + mu*v' - lr*g(w)."""
    @torch.no_grad()
    def apply(vel, params, grads, lr):
        for v, w, g in zip(vel, params, grads):
            g = _grad_f32(g, w, weight_decay)
            lg = lr * g
            v.copy_(mu * v - lg)
            w.copy_((w.to(torch.float32) + mu * v - lg).to(w.dtype))
        return vel

    return UpdateRule("nesterov", _zeros_f32, apply)


def adagrad(eps: float = 1e-8, weight_decay: float = 0.0) -> UpdateRule:
    """Duchi et al., the adaptive baseline the paper contrasts with (§2)."""
    @torch.no_grad()
    def apply(acc, params, grads, lr):
        for a, w, g in zip(acc, params, grads):
            g = _grad_f32(g, w, weight_decay)
            a.copy_(a + g * g)
            w.copy_((w.to(torch.float32) - lr * g / (torch.sqrt(a) + eps))
                    .to(w.dtype))
        return acc

    return UpdateRule("adagrad", _zeros_f32, apply)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> UpdateRule:
    """AdamW-style decoupled weight decay; state = (m, v, t)."""
    def init(params):
        dev = params[0].device if params else None
        return (_zeros_f32(params), _zeros_f32(params),
                torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def apply(state, params, grads, lr):
        m, v, t = state
        t = t + 1
        bc1 = 1.0 - b1 ** t.to(torch.float32)
        bc2 = 1.0 - b2 ** t.to(torch.float32)
        for mi, vi, w, g in zip(m, v, params, grads):
            g = g.to(torch.float32)
            mi.copy_(b1 * mi + (1 - b1) * g)
            vi.copy_(b2 * vi + (1 - b2) * g * g)
            step = lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            w32 = w.to(torch.float32)
            w.copy_((w32 - step - lr * weight_decay * w32).to(w.dtype))
        return (m, v, t)

    return UpdateRule("adam", init, apply)


RULES = {"sgd": sgd, "momentum": momentum, "nesterov": nesterov,
         "adagrad": adagrad, "adam": adam}

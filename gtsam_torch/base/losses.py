"""Robust loss functions (m-estimators), vectorized.

Counterpart of gtsam_tpu/base/losses.py (reference
gtsam/linear/LossFunctions.h: Fair:182, Huber:217, Cauchy:257, Tukey:293,
Welsch:328, GemanMcClure:366, DCS:406, L2WithDeadZone:447).  Each loss
gives
  weight(d): the IRLS weight w(d) applied to whitened rows (d = the
             whitened norm),
  loss(d):   rho(d), its contribution to the total error,
in the reference's distance (not squared-distance) convention, with the
JAX package's branches: inclusive `<=` at a threshold, max(|d|, 1e-30) in
Huber and the dead zone, Tukey's weight 0 beyond c.

A Loss keeps its name and parameter, so kernel 6 (csrc/pg_between.cu) can
be told which loss to compute: `kernel_code` gives (code, parameter) for a
loss made by one of the nine constructors of LOSSES, and None for a user's
own callables, which take the generic linearization instead.
"""

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Loss:
    name: str
    weight: Callable
    loss: Callable
    param: Optional[float] = None   # c or k of the named losses


def null():
    return Loss("null", lambda d: torch.ones_like(d), lambda d: 0.5 * d * d,
                0.0)


def fair(c=1.3998):
    def weight(d):
        return 1.0 / (1.0 + torch.abs(d) / c)

    def loss(d):
        ad = torch.abs(d) / c
        return c * c * (ad - torch.log1p(ad))

    return Loss("fair", weight, loss, c)


def huber(k=1.345):
    def weight(d):
        ad = torch.abs(d)
        return torch.where(ad <= k, 1.0, k / torch.clamp(ad, min=1e-30))

    def loss(d):
        ad = torch.abs(d)
        return torch.where(ad <= k, 0.5 * d * d, k * ad - 0.5 * k * k)

    return Loss("huber", weight, loss, k)


def cauchy(k=0.1):
    k2 = k * k

    def weight(d):
        return k2 / (k2 + d * d)

    def loss(d):
        return 0.5 * k2 * torch.log1p(d * d / k2)

    return Loss("cauchy", weight, loss, k)


def tukey(c=4.6851):
    c2 = c * c

    def weight(d):
        r = d * d / c2
        return torch.where(torch.abs(d) <= c, (1.0 - r) ** 2, 0.0)

    def loss(d):
        r = torch.clamp(d * d / c2, max=1.0)
        return c2 / 6.0 * (1.0 - (1.0 - r) ** 3)

    return Loss("tukey", weight, loss, c)


def welsch(c=2.9846):
    c2 = c * c

    def weight(d):
        return torch.exp(-d * d / c2)

    def loss(d):
        return 0.5 * c2 * (1.0 - torch.exp(-d * d / c2))

    return Loss("welsch", weight, loss, c)


def geman_mcclure(c=1.0):
    def weight(d):
        c2 = c * c
        return (c2 / (c2 + d * d)) ** 2

    def loss(d):
        c2 = c * c
        return 0.5 * c2 * d * d / (c2 + d * d)

    return Loss("geman_mcclure", weight, loss, c)


def dcs(c=1.0):
    def weight(d):
        e2 = d * d
        return torch.where(e2 > c, (2.0 * c / (c + e2)) ** 2, 1.0)

    def loss(d):
        e2 = d * d
        return torch.where(e2 > c, 2.0 * c * e2 / (c + e2) - c, 0.5 * e2)

    return Loss("dcs", weight, loss, c)


def l2_with_dead_zone(k=1.0):
    def weight(d):
        ad = torch.abs(d)
        return torch.where(ad <= k, 0.0,
                           (ad - k) / torch.clamp(ad, min=1e-30))

    def loss(d):
        ad = torch.abs(d)
        return torch.where(ad <= k, 0.0, 0.5 * (ad - k) ** 2)

    return Loss("l2_with_dead_zone", weight, loss, k)


LOSSES = {
    "null": null,
    "fair": fair,
    "huber": huber,
    "cauchy": cauchy,
    "tukey": tukey,
    "welsch": welsch,
    "geman_mcclure": geman_mcclure,
    "dcs": dcs,
    "l2_with_dead_zone": l2_with_dead_zone,
}

# kernel 6's loss codes (kLoss* in csrc/pg_between.cu): 0 is no loss
CODES = {name: i + 1 for i, name in enumerate(LOSSES)}


def kernel_code(loss: Optional[Loss]):
    """(code, parameter) of `loss` for kernel 6: (0, 0.0) for no loss, the
    loss's code and c or k for a loss made by a constructor of LOSSES, and
    None for any other Loss (callables of the user's own)."""
    if loss is None:
        return 0, 0.0
    code = CODES.get(loss.name)
    if code is None or loss.param is None:
        return None
    qual = f"{loss.name}.<locals>."
    for fn in (loss.weight, loss.loss):
        if getattr(fn, "__module__", None) != __name__ or not \
                fn.__qualname__.startswith(qual):
            return None
    return code, float(loss.param)


def from_code(code: int, param: float) -> Loss:
    """The named loss of kernel 6's `code` (>= 1) with its parameter."""
    name = list(LOSSES)[code - 1]
    return LOSSES[name]() if name == "null" else LOSSES[name](param)

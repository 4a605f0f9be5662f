"""Optimizer factory and LR schedules — counterpart of
``cmrtpu/train/optimizers.py``.

Each optimizer computes its optax rule (optax 0.2.6) by name: adam, nadam
(``adam(nesterov=True)``), sgd (nesterov only with ``MOMENTUM``), adagrad,
rmsprop, adadelta and radam; any other name is adam, as in cmrtpu. The
rules are optax's, not torch.optim's, where the two differ: adagrad starts
its accumulator at 0.1 and adds eps 1e-7 inside the root; rmsprop decays by
0.9 with eps inside the root; nadam has no momentum-decay schedule; the
bias corrections are float32 scalars, ``1 - float32(b) ** t`` as optax forms
them. Every hyperparameter is a float32 scalar, as optax's
``inject_hyperparams`` makes it (``1 - b1`` is 1 - float32(0.9)). ``AGC`` puts ``optax.adaptive_grad_clip(AGC, eps=1e-3)`` in front:
each unit's gradient is clipped to ``AGC * max(||w_unit||, 1e-3)``.

An update is a handful of ``torch._foreach_*`` multi-tensor passes over all
parameters, never a Python loop of per-tensor launches; AGC's unit norms
are one ``index_add_`` over the flattened gradients and weights. The
learning rate lives in the parameter group and is read and set between
steps (ReduceLROnPlateau and the schedules), as cmrtpu reads and sets its
injected hyperparameter; the step count and the rule's name live there too,
so ``state_dict`` holds everything a resume needs.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmrtpu_torch import config as C

NAMES = ("adam", "nadam", "sgd", "adagrad", "rmsprop", "adadelta", "radam")
_B1, _B2 = 0.9, 0.999
_AGC_EPS, _AGC_DIV_EPS = 1e-3, 1e-6


def _f32(x) -> np.float32:
    return np.float32(x)


def _power(decay: float, count: int) -> np.float32:
    """``decay ** count`` in float32, rounded once from float32(decay)."""
    return _f32(np.float64(_f32(decay)) ** count)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` as optax forms it in float32."""
    return float(_f32(1.0) - _power(decay, count))


def _unit_dims(name: str, shape: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """The dims AGC reduces for one parameter (optax ``unitwise_norm`` in
    the torch layout); None: the whole tensor is one unit."""
    if sum(s != 1 for s in shape) <= 1:
        return None
    if len(shape) == 4:
        module = name.split(".")[-2] if "." in name else ""
        # flax reduces HWI of an HWIO kernel: one unit per output channel.
        # torch stores a conv OIHW, a transposed conv [in, out, kh, kw]
        return (0, 2, 3) if module.startswith("ConvTranspose") else (1, 2, 3)
    raise ValueError(f"AGC: no unit rule for {name} of shape {tuple(shape)} "
                     "(the 2D U-Net has only vectors and 4D kernels)")


def _unit_ids(name: str, p: torch.Tensor, base: int) -> Tuple[torch.Tensor,
                                                                 int]:
    """The unit of each element of ``p`` in storage order, from ``base``."""
    dims = _unit_dims(name, p.shape)
    if dims is None:
        return torch.full((p.numel(),), base, dtype=torch.int32), 1
    if dims == (1, 2, 3):  # OIHW: units are runs of I*kh*kw
        units = p.shape[0]
        ids = torch.arange(units, dtype=torch.int32).repeat_interleave(
            p[0].numel())
    else:  # [in, out, kh, kw]: unit o repeats kh*kw, then cycles over in
        units = p.shape[1]
        ids = torch.arange(units, dtype=torch.int32).repeat_interleave(
            p.shape[2] * p.shape[3]).repeat(p.shape[0])
    return ids + base, units


class OptaxRule(torch.optim.Optimizer):
    """One optax rule over (name, parameter) pairs (one group). The group
    holds ``lr``, ``count`` (optax's step count) and ``name``; the
    per-parameter state holds the rule's moments."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 name: str, lr: float, eps: float = 1e-8,
                 momentum: Optional[float] = None,
                 agc: Optional[float] = None):
        if name not in NAMES:
            raise ValueError(f"unknown optimizer rule {name!r}")
        named = list(named_params)
        super().__init__([p for _, p in named],
                         dict(lr=float(_f32(lr)), count=0, name=name,
                              eps=float(eps), momentum=momentum, agc=agc))
        self._agc_ids = None
        if agc:
            self._agc_setup([n for n, _ in named])

    @property
    def name(self) -> str:
        return self.param_groups[0]["name"]

    def load_state_dict(self, state_dict: Dict) -> None:
        """The saved moments, step count and learning rate; ``eps``,
        ``momentum`` and ``agc`` stay the config's (AGC's unit table was
        built for them). A state of another rule raises."""
        group = self.param_groups[0]
        saved = state_dict["param_groups"][0]["name"]
        if saved != group["name"]:
            raise ValueError(f"an optimizer state of rule {saved!r} cannot "
                             f"load into {group['name']!r}")
        keep = {k: group[k] for k in ("eps", "momentum", "agc")}
        super().load_state_dict(state_dict)
        self.param_groups[0].update(keep)

    def _agc_setup(self, names: List[str]) -> None:
        params = self.param_groups[0]["params"]
        ids, base = [], 0
        for name, p in zip(names, params):
            unit, units = _unit_ids(name, p, base)
            ids.append(unit)
            base += units
        ids = torch.cat(ids).to(params[0].device)
        # weights' units after the gradients' in one sum
        self._agc_ids = torch.cat([ids, ids + base])
        self._agc_units = base

    def _agc_clip(self, grads: List[torch.Tensor],
                  params: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax ``adaptive_grad_clip(clip, eps=1e-3)``: each unit's
        gradient scaled by clip * max(|w|, eps) / |g| where |g| exceeds
        that. The unit sums of squares accumulate in float64, so the order
        of the atomic adds on the card moves them far below float32."""
        clip = float(self.param_groups[0]["agc"])
        flat_g = torch.cat([g.reshape(-1) for g in grads])
        flat = torch.cat([flat_g, torch.cat([p.reshape(-1) for p in params])])
        sums = torch.zeros(2 * self._agc_units, dtype=torch.float64,
                           device=flat.device)
        sums.index_add_(0, self._agc_ids, flat.double().square())
        g_norm, p_norm = sums.sqrt().float().split(self._agc_units)
        max_norm = clip * torch.clamp(p_norm, min=_AGC_EPS)
        factor = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                             max_norm / torch.clamp(g_norm, min=_AGC_DIV_EPS))
        clipped = flat_g * factor[self._agc_ids[:flat_g.numel()]]
        return [c.view_as(g) for c, g in
                zip(clipped.split([g.numel() for g in grads]), grads)]

    def _moments(self, params, *keys, fill: float = 0.0):
        """The state tensors ``keys`` of ``params``, made at first use."""
        for p in params:
            state = self.state[p]
            for key in keys:
                if key not in state:
                    state[key] = torch.full_like(p, fill)
        return [[self.state[p][key] for p in params] for key in keys]

    @torch.no_grad()
    def updates(self, params: List[torch.Tensor],
                grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax's ``updates`` of one step (the learning rate applied, not
        yet added to ``params``); advances the rule's state."""
        group = self.param_groups[0]
        if group["agc"]:
            if len(params) != len(group["params"]):
                raise ValueError("AGC clips every parameter's gradient; "
                                 f"{len(group['params']) - len(params)} "
                                 "have none")
            grads = self._agc_clip(grads, params)
        group["count"] += 1
        scaled = getattr(self, "_" + group["name"])(params, grads, group)
        return torch._foreach_mul(scaled, -float(_f32(group["lr"])))

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a gradient (apply_updates)."""
        if closure is not None:
            raise ValueError("OptaxRule.step takes no closure")
        params = [p for p in self.param_groups[0]["params"]
                  if p.grad is not None]
        if params:
            torch._foreach_add_(params, self.updates(
                params, [p.grad for p in params]))

    # -- the rules: each returns the update before the learning rate -----
    def _ema(self, moments, grads, decay: float, square: bool) -> None:
        """optax ``update_moment``: (1 - decay) * g**order + decay * t, the
        decay a float32 hyperparameter."""
        d = _f32(decay)
        torch._foreach_mul_(moments, float(d))
        if square:
            torch._foreach_addcmul_(moments, grads, grads,
                                    value=float(_f32(1.0) - d))
        else:
            torch._foreach_add_(moments, grads, alpha=float(_f32(1.0) - d))

    def _adam(self, params, grads, group, nesterov: bool = False):
        mu, nu = self._moments(params, "mu", "nu")
        self._ema(mu, grads, _B1, square=False)
        self._ema(nu, grads, _B2, square=True)
        t = group["count"]
        if nesterov:
            mu_hat = torch._foreach_div(mu, _bias_correction(_B1, t + 1))
            torch._foreach_mul_(mu_hat, float(_f32(_B1)))
            g_hat = torch._foreach_div(grads, _bias_correction(_B1, t))
            torch._foreach_add_(mu_hat, g_hat,
                                alpha=float(_f32(1.0) - _f32(_B1)))
        else:
            mu_hat = torch._foreach_div(mu, _bias_correction(_B1, t))
        denom = torch._foreach_div(nu, _bias_correction(_B2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(_f32(group["eps"])))
        torch._foreach_div_(mu_hat, denom)
        return mu_hat

    def _nadam(self, params, grads, group):
        return self._adam(params, grads, group, nesterov=True)

    def _radam(self, params, grads, group, threshold: float = 5.0):
        """optax ``scale_by_radam``: the rectified adam step once the
        variance estimate is tractable (rho >= 5), bias-corrected momentum
        before; rho and r in float32 in optax's order."""
        mu, nu = self._moments(params, "mu", "nu")
        self._ema(mu, grads, _B1, square=False)
        self._ema(nu, grads, _B2, square=True)
        t = group["count"]
        one, b2 = _f32(1.0), _f32(_B2)
        ro_inf = _f32(2.0) / (one - b2) - one
        b2t = _power(_B2, t)
        ro = ro_inf - _f32(2 * t) * b2t / (one - b2t)
        mu_hat = torch._foreach_div(mu, _bias_correction(_B1, t))
        if ro < _f32(threshold):
            return mu_hat
        r = np.sqrt((ro - _f32(4.0)) * (ro - _f32(2.0)) * ro_inf
                    / ((ro_inf - _f32(4.0)) * (ro_inf - _f32(2.0)) * ro))
        torch._foreach_mul_(mu_hat, float(r))
        denom = torch._foreach_div(nu, _bias_correction(_B2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, float(_f32(group["eps"])))
        torch._foreach_div_(mu_hat, denom)
        return mu_hat

    def _sgd(self, params, grads, group):
        momentum = group["momentum"]
        if momentum is None:
            return grads
        (trace,) = self._moments(params, "trace")
        momentum = float(_f32(momentum))
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, grads)
        # nesterov whenever a momentum is set (cmrtpu's sgd)
        out = torch._foreach_mul(trace, momentum)
        torch._foreach_add_(out, grads)
        return out

    def _adagrad(self, params, grads, group, eps: float = 1e-7):
        """optax ``scale_by_rss(0.1, 1e-7)``: the accumulator starts at 0.1,
        so it is always positive and optax's ``where(t > 0, ...)`` always
        takes the root."""
        (rss,) = self._moments(params, "sum_of_squares", fill=0.1)
        torch._foreach_addcmul_(rss, grads, grads)
        scale = torch._foreach_add(rss, float(_f32(eps)))
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        return scale

    def _rmsprop(self, params, grads, group, decay: float = 0.9,
                 eps: float = 1e-8):
        (nu,) = self._moments(params, "nu")
        self._ema(nu, grads, decay, square=True)
        scale = torch._foreach_add(nu, float(_f32(eps)))
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        return scale

    def _adadelta(self, params, grads, group, rho: float = 0.9,
                  eps: float = 1e-6):
        e_g, e_x = self._moments(params, "e_g", "e_x")
        self._ema(e_g, grads, rho, square=True)
        eps = float(_f32(eps))
        upd = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(upd)
        denom = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, grads)
        self._ema(e_x, upd, rho, square=True)
        return upd


def get_optimizer(params: Iterable[Tuple[str, torch.nn.Parameter]],
                  config: Dict) -> OptaxRule:
    """The OPTIMIZER rule at LEARNING_RATE over ``params``, the
    (name, parameter) pairs of ``model.named_parameters()`` (cmrtpu's
    ``get_optimizer``): adam, nadam and radam take EPSILON, the others
    optax's defaults; sgd is nesterov with MOMENTUM, plain without; an
    unknown name is adam. ``AGC`` clips ahead of the rule, its units found
    from the names."""
    name = str(C.get(config, "OPTIMIZER", "adam")).lower()
    momentum = None
    if name == "sgd":
        # keras SGD(nesterov=True) has momentum 0.0 by default; MOMENTUM is
        # cmrtpu's config extension
        momentum = float(C.get(config, "MOMENTUM", 0.0)) or None
    return OptaxRule(params, name if name in NAMES else "adam",
                     lr=float(C.get(config, "LEARNING_RATE", 1e-4)),
                     eps=float(C.get(config, "EPSILON", 1e-8)),
                     momentum=momentum, agc=C.get(config, "AGC", None) or None)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Store ``lr`` as optax stores its injected hyperparameter: a float32
    value, which ``get_learning_rate`` reads back."""
    for group in optimizer.param_groups:
        group["lr"] = float(_f32(lr))


def polynomial_decay(epoch: int, max_epochs: int, init_alpha: float,
                     power: float = 2.0) -> float:
    """alpha = init * (1 - epoch/max)^power (ref: KerasCallbacks.py:230-243)."""
    decay = (1.0 - (epoch / float(max_epochs))) ** power
    return float(init_alpha * max(decay, 0.0))


def sgdr_schedule(iteration: int, lr_min: float, lr_max: float,
                  cycle_length: float, mult_factor: float = 2.0) -> float:
    """Cosine annealing with warm restarts (ref: SGDRScheduler,
    KerasCallbacks.py:308-384) as a pure function of the global iteration
    count."""
    remaining = float(iteration)
    length = float(cycle_length)
    while remaining >= length:
        remaining -= length
        length *= mult_factor
    fraction = remaining / length
    return float(lr_min + 0.5 * (lr_max - lr_min)
                 * (1.0 + math.cos(fraction * math.pi)))

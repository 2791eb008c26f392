"""AdamW with a float32 master copy (no ``torch.optim``).

The port's counterpart of the JAX package's ``optim/adamw.py``: the same
arithmetic in the same order, on dicts of tensors keyed as the model's
``state_dict``:

  - the global-norm clip sums each leaf's squares in sorted key order
    (the order of JAX's leaves of the same tree);
  - the bias corrections ``1 - b ** step`` are computed in float32;
  - weight decay sits inside the ``lr`` product:
    ``p32 - lr * (mhat / (sqrt(vhat) + eps) + wd * p32)``;
  - the master, m and v are float32; parameters keep their dtype.

``torch.optim.AdamW`` decays the parameter before the step instead, which
is another function. ``donate=True`` writes the new values into the given
parameters' and state's tensors, as JAX's train step donates its inputs:
a step then holds no second copy of the state, and a few float32
temporaries of one leaf at a time. Without it the leaves are copied first
and updated by the same in-place arithmetic.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32, 0-d
    master: Dict[str, torch.Tensor]     # fp32 master params
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _key(name: str):
    return tuple(name.split("."))


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Step 0, a float32 copy of every parameter and zero moments, on each
    parameter's device (laid out as the parameter, where it is a
    DTensor)."""
    params = {k: p.detach() for k, p in params.items()}
    master = {k: p.to(torch.float32, copy=True) for k, p in params.items()}

    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    device = next(iter(params.values())).device if params else None
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      master, zeros(), zeros())


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0, donate: bool = False):
    """Returns (new_params, new_state). Params keep their input dtype.

    ``donate``: the new values go into the tensors of ``params`` and of
    ``state``'s master, m and v, which are returned; without it they are
    new tensors and the inputs are left as they were."""
    if set(grads) != set(params) or set(state.master) != set(params):
        raise KeyError("params, grads and the state's master must have the "
                       "same keys")
    keys = sorted(params, key=_key)
    scale = None
    if grad_clip is not None:
        gsq = sum(torch.sum(torch.square(grads[k].float())) for k in keys)
        gnorm = torch.sqrt(gsq)
        # a true division: ``grad_clip / tensor`` multiplies by the
        # reciprocal in PyTorch, which rounds otherwise
        scale = torch.clamp(torch.full_like(gnorm, grad_clip)
                            / torch.clamp(gnorm, min=1e-12), max=1.0)

    step = state.step + 1
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    new_params, master, new_m, new_v = {}, {}, {}, {}
    for k in keys:
        m, v, p32 = state.m[k], state.v[k], state.master[k]
        p = params[k]
        if not donate:
            m, v, p32, p = m.clone(), v.clone(), p32.clone(), \
                torch.empty_like(p)
        g = grads[k].float()
        if scale is not None:
            g = g * scale
        # in place, each product and sum rounded as JAX's expression:
        #   m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
        #   p32 - lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p32)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_((g * (1 - b2)).mul_(g))
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        p32.sub_(upd.add_(p32 * weight_decay).mul_(lr))
        p.copy_(p32)
        new_params[k], new_m[k], new_v[k], master[k] = p, m, v, p32
    return new_params, AdamWState(step, master, new_m, new_v)


__all__ = ["AdamWState", "adamw_init", "adamw_update"]

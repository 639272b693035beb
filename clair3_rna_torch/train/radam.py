"""Rectified Adam, step for step optax.radam(learning_rate).

optax.radam = scale_by_radam(b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
threshold 5) then a scale by -learning_rate. Per step t (counted from 1):

  m = (1 - b1) g + b1 m          v = (1 - b2) g^2 + b2 v
  m_hat = m / (1 - b1^t)         v_hat = v / (1 - b2^t)
  rho_t = rho_inf - 2 t b2^t / (1 - b2^t),   rho_inf = 2 / (1 - b2) - 1
  update = -lr * (r m_hat / (sqrt(v_hat + eps_root) + eps))  if rho_t >= 5
           -lr * m_hat                                       otherwise
  r = sqrt((rho_t - 4)(rho_t - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2) rho_t))

The scalars (b^t, rho_t, r) are computed in float32, as optax computes
them inside a jitted step, with b^t as XLA's float32 power gives it:
rho_t = rho_inf - 2 t b2^t / (1 - b2^t) is ill-conditioned near the
threshold, so one ulp of b2^t moves rho_6 by 0.02 and r by 0.6% (float64
moves rho_6 further, to 5.9942).
torch.optim.RAdam is not this step: it takes rho in float64 and adds eps
to sqrt(v) before the bias correction.
"""

from dataclasses import dataclass

import numpy as np
import torch


def _pow_f32(base, n):
    """float32(base) ** n, rounded once to float32 from float64: XLA's
    float32 power (how optax's jitted step takes b^t) agrees with this on
    all but a few t in 3,000 (one ulp, at t >= 685)."""
    return np.float32(float(np.float32(base)) ** n)


@dataclass
class RAdamState:
    count: int
    mu: list
    nu: list


class RAdam:
    """init(params) -> state; update(grads, state) -> (updates, state),
    with params, grads and updates lists of float32 tensors (optax's
    GradientTransformation shape, with the parameter tree a list)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, threshold=5.0):
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.eps_root, self.threshold = eps, eps_root, threshold

    def init(self, params):
        params = list(params)
        return RAdamState(
            count=0, mu=[torch.zeros_like(p).detach() for p in params],
            nu=[torch.zeros_like(p).detach() for p in params])

    @torch.no_grad()
    def update(self, grads, state):
        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        f32 = np.float32
        t = f32(count)
        b2t = _pow_f32(b2, count)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = f32(ro_inf) - f32(2) * t * b2t / (f32(1) - b2t)
        bc1 = float(f32(1) - _pow_f32(b1, count))
        bc2 = float(f32(1) - b2t)
        step = float(f32(-self.lr))
        if ro >= self.threshold:
            r = float(np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                              / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
            updates = [step * (r * (m / bc1)
                               / (torch.sqrt(v / bc2 + self.eps_root)
                                  + self.eps))
                       for m, v in zip(mu, nu)]
        else:
            updates = [step * (m / bc1) for m in mu]
        return updates, RAdamState(count=count, mu=mu, nu=nu)

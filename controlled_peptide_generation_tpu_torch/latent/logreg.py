"""L2-regularized logistic regression fit by damped Newton on the device.

Objective (sklearn's primal form): 0.5*||w||^2 + C * sum_i log(1 +
exp(-y_i f(x_i))), intercept unpenalized. Each iteration solves the
(D+1)x(D+1) Newton system by Cholesky with a tiny Tikhonov damping (keeps
separable inputs finite) and backtracks until the objective decreases.
Full fp32 matmuls (no TF32): reduced precision breaks the Hessian's
Cholesky on ill-conditioned fits.
"""

from typing import NamedTuple

import torch


class LogRegParams(NamedTuple):
    w: torch.Tensor   # [D]
    b: torch.Tensor   # []


def fit(X, y, C=1.0, tol=1e-4, max_iter=200):
    """X: [N, D] float, y: [N] in {0, 1}. Returns (LogRegParams, n_iter)."""
    X = X.to(torch.float32)
    y = y.to(torch.float32)
    N, D = X.shape
    dev = X.device
    Xb = torch.cat([X, torch.ones((N, 1), device=dev)], dim=1)
    reg = torch.cat([torch.ones(D, device=dev), torch.zeros(1, device=dev)])

    def grad_hess(theta):
        p = torch.sigmoid(Xb @ theta)
        g = C * (Xb.T @ (p - y)) + reg * theta
        s = p * (1.0 - p)
        H = C * (Xb.T * s[None, :]) @ Xb + torch.diag(reg)
        return g, H

    def loss(theta):
        m = Xb @ theta
        softplus = torch.logaddexp(m, torch.zeros_like(m))
        return (C * torch.sum(softplus - y * m)
                + 0.5 * torch.sum(reg * theta ** 2))

    damp = 1e-7 * torch.eye(D + 1, device=dev)
    theta = torch.zeros(D + 1, device=dev)
    g, _ = grad_hess(theta)
    gnorm = float(torch.max(torch.abs(g)))
    it = 0
    while gnorm > tol and it < max_iter:
        g, H = grad_hess(theta)
        step = torch.cholesky_solve(g[:, None],
                                    torch.linalg.cholesky(H + damp))[:, 0]
        l0 = float(loss(theta))
        t = 1.0
        for _ in range(30):
            l1 = float(loss(theta - t * step))
            if l1 <= l0 and l1 == l1 and abs(l1) != float("inf"):
                break
            t *= 0.5
        theta = theta - t * step
        g, _ = grad_hess(theta)
        gnorm = float(torch.max(torch.abs(g)))
        it += 1
    return LogRegParams(theta[:D], theta[D]), it


def predict_proba(params, X):
    """[N, D] -> [N, 2] class probabilities (sklearn's column order)."""
    p1 = torch.sigmoid(X @ params.w + params.b)
    return torch.stack([1.0 - p1, p1], dim=1)


def decision(params, X):
    return X @ params.w + params.b


def accuracy(params, X, y):
    pred = (decision(params, X) > 0).to(y.dtype)
    return torch.mean((pred == y).to(torch.float32))

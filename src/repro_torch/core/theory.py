"""Calculators for the paper's bound terms (Theorems 1-6) and the
quadratic validation problem where every constant is known in closed form.

Ports ``thm1_residual``, ``thm1_rate``, ``stationarity_translation``,
``thm5_stability`` (numpy, as the reference's) and ``QuadraticProblem``
of ``repro/core/theory.py``: its constants and optima in numpy, its data
and losses as torch tensors.  The measured residual suboptimality of
masked training tracks the Theorem 1 residual term
``(5L/2mu_bar + 4/L) (2G^2 + 2W^2L^2) / N sum_i d (1 - p_i)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Bound terms
# ---------------------------------------------------------------------------


def thm1_residual(L, mu, G, W, d, probs):
    """Residual error due to masked updates (Theorem 1, last term)."""
    probs = np.asarray(probs, np.float64)
    mu_bar = float(probs.mean()) * mu
    coeff = 5 * L / (2 * mu_bar) + 4 / L
    return coeff * (2 * G ** 2 + 2 * W ** 2 * L ** 2) \
        * float(np.mean(d * (1 - probs)))


def thm1_rate(L, mu, G, W, d, probs, K, R, w0_dist, sigma_star, delta, N):
    """Full Theorem-1 RHS (optimization + residual)."""
    probs = np.asarray(probs, np.float64)
    mu_t = float(probs.min()) * mu
    L_t = float(probs.max()) * L
    kap = L_t / mu_t
    opt = L * (w0_dist ** 2 / (K ** 2 * R ** 2)
               + (kap * sigma_star ** 2 + kap * delta ** 2)
               / (mu_t ** 2 * R ** 2)
               + delta ** 2 / (mu_t ** 2 * N * K * R))
    return opt + thm1_residual(L, mu, G, W, d, probs)


def stationarity_translation(eps, G, L, w_norm, d, probs):
    """||grad F(w)||^2 bound from eps-stationarity of F_p (Sec. 2.2)."""
    probs = np.asarray(probs, np.float64)
    return 2 * eps ** 2 + float(np.mean(d * (1 - probs))) \
        * (G ** 2 + L ** 2 * w_norm ** 2)


def thm5_stability(G, L, delta, D_max, sigma_star, probs, N, n):
    """Stability bound of random masking (Theorem 5 / Corollary 1)."""
    Lt = float(np.max(probs)) * L
    root = math.sqrt(Lt / math.sqrt(N * n) + sigma_star ** 2 + delta ** 2)
    return G * ((delta + G * D_max) / math.sqrt(N * n)
                + root / math.sqrt(N * n))


# ---------------------------------------------------------------------------
# Quadratic validation problem: f_i(w) = 0.5 ||A_i w - b_i||^2
# ---------------------------------------------------------------------------


@dataclass
class QuadraticProblem:
    """Strongly-convex quadratic federated objective with a known optimum.

    Per-client ``f_i(w) = 0.5 ||A_i w - b_i||^2 / m``.  Smoothness L and
    strong convexity mu are the extreme eigenvalues of ``(1/N) sum A_i^T
    A_i / m``.  ``A [N, m, d]`` and ``b [N, m]`` are float32 tensors.
    """

    A: torch.Tensor            # [N, m, d]
    b: torch.Tensor            # [N, m]

    @staticmethod
    def make(n_clients, m, d, hetero=1.0, seed=0, cond=10.0, device="cuda"):
        """The reference's problem for ``seed`` (numpy draws), on
        ``device``."""
        rng = np.random.default_rng(seed)
        base = rng.standard_normal((m, d))
        # control conditioning
        u, s, vt = np.linalg.svd(base, full_matrices=False)
        s = np.linspace(1.0, math.sqrt(cond), len(s))
        base = (u * s) @ vt
        A = np.stack([base + hetero * rng.standard_normal((m, d)) * 0.3
                      for _ in range(n_clients)])
        w_true = rng.standard_normal(d)
        b = np.einsum("nmd,d->nm", A, w_true) \
            + hetero * rng.standard_normal((n_clients, m))
        dev = resolve_device(device)
        return QuadraticProblem(
            torch.tensor(A.astype(np.float32), device=dev),
            torch.tensor(b.astype(np.float32), device=dev))

    @property
    def dim(self):
        return self.A.shape[-1]

    def _np(self):
        return self.A.cpu().numpy(), self.b.cpu().numpy()

    def hessian(self):
        A, _ = self._np()
        return np.einsum("nmd,nme->nde", A, A).mean(0) / A.shape[1]

    def constants(self):
        ev = np.linalg.eigvalsh(self.hessian())
        return {"L": float(ev[-1]), "mu": float(ev[0])}

    def w_star(self):
        A, b = self._np()
        g = np.einsum("nmd,nm->d", A, b).astype(np.float64) \
            / (A.shape[0] * A.shape[1])
        return np.linalg.solve(self.hessian(), g)

    def w_star_masked(self, probs):
        """argmin of F_p for coordinate-wise Bernoulli(p) masking:
        E_m[f(m*w)] has Hessian ``p p^T * H + diag(p(1-p) diag(H))``, in
        closed form for quadratics."""
        A, b = self._np()
        H = self.hessian()
        p = np.full(self.dim, float(np.mean(probs)))
        Hp = np.outer(p, p) * H
        np.fill_diagonal(Hp, p * np.diag(H))
        g = p * (np.einsum("nmd,nm->d", A, b) / (A.shape[0] * A.shape[1]))
        return np.linalg.solve(Hp, g)

    def loss_fn(self, client):
        """Client ``client``'s loss of one model: ``f(w, batch_idx)`` on
        the rows ``batch_idx`` of its data, ``(loss, {"loss"})``."""
        def f(w, batch_idx):
            r = self.A[client][batch_idx] @ w["w"] - self.b[client][batch_idx]
            loss = 0.5 * torch.mean(r * r)
            return loss, {"loss": loss}
        return f

    def global_loss(self, w):
        r = torch.einsum("nmd,d->nm", self.A, w) - self.b
        return 0.5 * float(torch.mean(r * r))

    def params(self, seed=0):
        return {"w": torch.zeros(self.dim, device=self.A.device)}

    def axes(self):
        return {"w": ("d_model",)}

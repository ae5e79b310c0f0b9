"""Exponential-family core (PyTorch).

Counterpart of ``beer_tpu/dists/basedist.py``.  A family is a small
frozen dataclass that knows its natural-parameter length ``nat_dim`` and
its log-partition ``log_norm``; everything else follows generically:

* E[T(θ)] = ∇A(η), through ``torch.func.grad`` of the batch-summed
  log-partition (exact: ``lgamma``'s derivative is ``digamma``),
* KL(q‖p) as the Bregman divergence of A:
  (η_q − η_p)·∇A(η_q) − A(η_q) + A(η_p).

Natural parameters are flat tensors of shape ``(..., P)``; leading axes
batch a set of parameters.  The conjugacy convention is the JAX
package's: data-side statistics live in the prior's natural-parameter
space, so the VB M-step is an addition and the expected
log-likelihood is one matmul.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ExpFamily:
    """Base class for exponential-family descriptors."""

    @property
    def nat_dim(self) -> int:
        raise NotImplementedError

    def log_norm(self, nat: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def expected_sufficient_statistics(self, nat: torch.Tensor) -> torch.Tensor:
        """E[T(θ)] = ∇_η A(η) for batched ``nat`` of shape (..., P).

        ``log_norm`` maps each batch element independently, so the
        gradient of the batch sum is the per-element gradient.
        """
        return torch.func.grad(lambda n: self.log_norm(n).sum())(nat)

    def kl_div(self, nat_q: torch.Tensor, nat_p: torch.Tensor) -> torch.Tensor:
        """KL(q‖p) between two members, batched over leading dims."""
        grad_q = self.expected_sufficient_statistics(nat_q)
        return (
            ((nat_q - nat_p) * grad_q).sum(-1)
            - self.log_norm(nat_q)
            + self.log_norm(nat_p)
        )


# ----------------------------------------------------------------------
# Shared helpers for matrix-variate families.
# ----------------------------------------------------------------------
def sym(mat: torch.Tensor) -> torch.Tensor:
    """Symmetrise (guards cholesky/logdet against asymmetric roundoff)."""
    return 0.5 * (mat + mat.transpose(-1, -2))


def logdet_pd(mat: torch.Tensor) -> torch.Tensor:
    """log|M| for symmetric positive-definite M through a Cholesky factor
    (batched); raises on a matrix that is not positive definite."""
    chol = torch.linalg.cholesky(sym(mat))
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def vec(mat: torch.Tensor) -> torch.Tensor:
    """Flatten the trailing (D, D) matrix dims to D²."""
    return mat.reshape(*mat.shape[:-2], -1)


def unvec(flat: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`vec`."""
    return flat.reshape(*flat.shape[:-1], dim, dim)

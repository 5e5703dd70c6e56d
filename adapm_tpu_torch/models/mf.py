"""Matrix factorization with AdaGrad + L2 (reference
apps/matrix_factorization.cc + apps/mf/update.h:23-79
`UpdateNsqlL2Adagrad`), as in the JAX package's `models/mf.py`.

Key layout (matrix_factorization.cc:692-697): row keys [0, first_col_key),
column keys from first_col_key; value row = [factor (rank) | AdaGrad (rank)].
Loss = nonzero squared loss + L2 on both factors. The loss runs its step
as the hand-written kernel K7 (`MfLoss.fused_update`, ops/kernels.py
mf_step).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import mf_step


class MfLoss:
    """loss_fn(embs, aux) for ops/fused.py. Roles: w [B, rank] (row
    factors), h [B, rank] (column factors); aux = the observed ratings
    [B] (an array or a tensor, taken to the rows' device).
    loss = mean_b((w.h - x)^2 + l2 (|w|^2 + |h|^2)).

    `fused_update` is the loss's fused form: the fused step runs it (the
    hand-written kernel K7) in place of autograd and K2."""

    def __init__(self, l2: float = 0.0):
        self.l2 = float(l2)

    @staticmethod
    def _ratings(aux, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(aux, dtype=like.dtype, device=like.device)

    def __call__(self, embs, aux):
        w, h = embs["w"], embs["h"]
        x = self._ratings(aux, w)
        pred = (w * h).sum(-1)
        err = (pred - x) ** 2
        reg = self.l2 * ((w * w).sum(-1) + (h * h).sum(-1))
        return (err + reg).mean()

    def fused_update(self, rows, out, lr_eps, aux) -> torch.Tensor:
        """The MF loss, its gradient and the AdaGrad delta rows in one K7
        launch: `rows` maps w, h to gathered [factor | acc] rows, `out`
        each trainable role to its delta rows, `aux` the ratings. Returns
        the mean loss."""
        if sorted(rows) != ["h", "w"]:
            raise ValueError(f"MfLoss: roles {sorted(rows)}, expected w, h")
        x = self._ratings(aux, rows["w"]).contiguous()
        return mf_step(rows["w"], rows["h"], x, lr_eps, self.l2,
                       out=out).mean()


def make_mf_loss(l2: float = 0.0) -> MfLoss:
    """Roles: w [B, rank] (row factors), h [B, rank] (col factors);
    aux = observed ratings x [B]. Mean squared residual + L2."""
    return MfLoss(l2)


def row_key(i: np.ndarray):
    return np.asarray(i, dtype=np.int64)


def col_key(j: np.ndarray, first_col_key: int):
    return np.asarray(j, dtype=np.int64) + first_col_key


def full_loss(W: np.ndarray, H: np.ndarray, coo, l2: float = 0.0) -> float:
    """Test/train loss over all observed entries (reference apps/mf/loss.h):
    coo = (rows, cols, vals) numpy arrays."""
    i, j, x = coo
    pred = (W[i] * H[j]).sum(-1)
    err = float(((pred - x) ** 2).sum())
    if l2:
        err += l2 * float((W * W).sum() + (H * H).sum())
    return err

"""3D pose metrics: MPJPE, Procrustes-aligned MPJPE, PCK3D, AUC3D (the JAX
package's ``ops/metrics.py``).

  * MPJPE: mean per-joint L2 error.
  * PA-MPJPE: per-sample similarity alignment (scale, rotation, translation)
    solved by one batched SVD, with the reflection fix (``sign(det)``).
  * PCK3D at 150 mm and AUC3D over 31 thresholds in [0, 150] mm.
"""

from __future__ import annotations

import torch

from egorear_tpu_torch.utils.constants import device_constant

AUC_THRESHOLDS = tuple(150.0 * i / 30 for i in range(31))


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(..., J, 3) -> (...,) mean per-joint L2 error."""
    return torch.linalg.vector_norm(gt - pred, dim=-1).mean(dim=-1)


def mpjpe_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Scalar mean L2 distance over every joint of the batch."""
    return torch.linalg.vector_norm(gt - pred, dim=-1).mean()


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Batched similarity alignment of ``pred`` onto ``gt``: (B, J, 3) x
    (B, J, 3) -> (B, J, 3).

    The orthogonal-Procrustes solution per sample: K = X1 X2^T of the
    centred 3xJ point sets, R = V Z U^T from the SVD of K with
    Z = diag(1, 1, sign(det(U V^T))) so that R is a rotation, never a
    reflection; scale = trace(R K) / |X1|^2.
    """
    mu1 = pred.mean(dim=1, keepdim=True)
    mu2 = gt.mean(dim=1, keepdim=True)
    X1 = (pred - mu1).transpose(1, 2)  # (B, 3, J)
    X2 = (gt - mu2).transpose(1, 2)
    var1 = (X1 ** 2).sum(dim=(1, 2))
    K = X1 @ X2.transpose(1, 2)  # (B, 3, 3)
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(1, 2)
    det = torch.linalg.det(U @ V.transpose(1, 2))
    z = torch.ones(pred.shape[0], 3, dtype=pred.dtype, device=pred.device)
    z[:, -1] = torch.sign(det)
    R = (V * z[:, None, :]) @ U.transpose(1, 2)
    scale = (R @ K).diagonal(dim1=1, dim2=2).sum(-1) / var1.clamp_min(1e-12)
    t = mu2.transpose(1, 2) - scale[:, None, None] * (R @ mu1.transpose(1, 2))
    aligned = scale[:, None, None] * (R @ pred.transpose(1, 2)) + t
    return aligned.transpose(1, 2)


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, J, 3) -> (B,) Procrustes-aligned MPJPE."""
    return mpjpe(procrustes_align(pred, gt), gt)


def pck_3d(pred: torch.Tensor, gt: torch.Tensor,
           threshold: float = 150.0) -> torch.Tensor:
    """(B, J, 3) -> (B,) fraction of joints within ``threshold`` (mm inputs)."""
    dist = torch.linalg.vector_norm(gt - pred, dim=-1)
    return (dist <= threshold).to(pred.dtype).mean(dim=-1)


def auc_3d(pred: torch.Tensor, gt: torch.Tensor,
           thresholds=AUC_THRESHOLDS) -> torch.Tensor:
    """(B, J, 3) -> (B,) mean PCK over the 31 thresholds."""
    dist = torch.linalg.vector_norm(gt - pred, dim=-1)  # (B, J)
    th = device_constant(tuple(thresholds), dist.dtype, dist.device)
    pck = (dist[..., None] <= th).to(dist.dtype).mean(dim=-2)  # (B, T)
    return pck.mean(dim=-1)

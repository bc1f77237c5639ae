"""Plain PyTorch version of the paged SiN distance kernel."""
from __future__ import annotations

import torch


def paged_distances_ref(page_ids: torch.Tensor, queries: torch.Tensor,
                        qq: torch.Tensor, db: torch.Tensor,
                        vnorm: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`repro_torch.kernels.distance.kernel.
    paged_distances`: gather the named pages, one batched product, the
    norms. Page ids clamp into the store, as the kernel clamps them.
    """
    pid = page_ids.long().clamp(0, db.shape[0] - 1)
    pages = db[pid].float()                               # (T, P, d)
    qv = torch.einsum("tqd,tpd->tqp", queries.float(), pages)
    return (qq[:, :, None].float() - 2.0 * qv) + vnorm[pid][:, None, :].float()

"""The cluster-editing steps of ``editing.py`` on torch float64 tensors.

A line-for-line transliteration of ``_EditingState`` and
``_host_cluster_editing``: the same sums, the same decision rule, the
same tie-breaking (``torch.argmax`` returns the first maximum, as
``np.argmax`` does).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .editing import FORBIDDEN


class _TorchEditingState:
    def __init__(self, weights: np.ndarray, device):
        n = weights.shape[0]
        self.n = n
        self.dev = device
        self.W = torch.as_tensor(np.asarray(weights, dtype=np.float64),
                                 device=device).clone()
        self.W.fill_diagonal_(0.0)
        self.alive = torch.ones(n, dtype=torch.bool, device=device)
        self.forb = torch.zeros((n, n), dtype=torch.bool, device=device)
        self.members: List[List[int]] = [[i] for i in range(n)]
        self.sum_f = torch.zeros((n, n), dtype=torch.float64, device=device)
        self.sum_p = torch.zeros((n, n), dtype=torch.float64, device=device)
        idx = torch.arange(n, device=device)
        self.upper = idx[:, None] < idx[None, :]
        for z in range(n):
            self.sum_f += self._contrib_f(z)
            self.sum_p += self._contrib_p(z)

    def _col(self, z: int) -> torch.Tensor:
        return self.W[:, z] * self.alive[z]

    def _contrib_f(self, z: int) -> torch.Tensor:
        col = self._col(z)
        return torch.clamp(torch.minimum(col[:, None], col[None, :]),
                           min=0.0)

    def _contrib_p(self, z: int) -> torch.Tensor:
        col = self._col(z)
        pos, neg = col > 0, col < 0
        conflict = (pos[:, None] & neg[None, :]) | (neg[:, None]
                                                    & pos[None, :])
        a = col.abs()
        return conflict * torch.minimum(a[:, None], a[None, :])

    def icf_icp(self):
        icf = torch.clamp(self.W, min=0.0) + self.sum_f
        icp = torch.clamp(-self.W, min=0.0) + self.sum_p
        return icf, icp

    def undecided(self, positive_only: bool) -> torch.Tensor:
        live = self.alive[:, None] & self.alive[None, :]
        cand = (self.W > 0) if positive_only else (
            (self.W != 0) & ~self.forb)
        return cand & live & self.upper

    def forbid(self, u: int, v: int) -> None:
        old_fu, old_pu = self._contrib_f(u), self._contrib_p(u)
        old_fv, old_pv = self._contrib_f(v), self._contrib_p(v)
        self.W[u, v] = self.W[v, u] = FORBIDDEN
        self.forb[u, v] = self.forb[v, u] = True
        self._update_z(u, old_fu, old_pu)
        self._update_z(v, old_fv, old_pv)

    def _update_z(self, z: int, old_f, old_p) -> None:
        self.sum_f += self._contrib_f(z) - old_f
        self.sum_p += self._contrib_p(z) - old_p

    def merge(self, u: int, v: int) -> None:
        W = self.W
        old_fu, old_pu = self._contrib_f(u), self._contrib_p(u)
        old_fv, old_pv = self._contrib_f(v), self._contrib_p(v)
        merged = W[u] + W[v]
        merged[u] = 0.0
        fmerged = self.forb[u] | self.forb[v]
        fmerged[u] = False
        merged[fmerged] = FORBIDDEN
        W[u, :] = merged
        W[:, u] = merged
        W[v, :] = 0.0
        W[:, v] = 0.0
        self.forb[u, :] = fmerged
        self.forb[:, u] = fmerged
        self.alive[v] = False
        self.members[u].extend(self.members[v])
        self.members[v] = []
        self._update_z(u, old_fu, old_pu)
        self._update_z(v, old_fv, old_pv)
        self._recompute_pair_row(u)

    def _recompute_pair_row(self, u: int) -> None:
        Wa = self.W * self.alive[None, :]
        wu = Wa[u]
        f = torch.clamp(torch.minimum(wu[None, :], Wa), min=0.0)
        row_f = f.sum(dim=1)
        conflict = ((wu[None, :] > 0) & (Wa < 0)) | ((wu[None, :] < 0)
                                                      & (Wa > 0))
        p = conflict * torch.minimum(wu.abs()[None, :], Wa.abs())
        row_p = p.sum(dim=1)
        self.sum_f[u, :] = row_f
        self.sum_f[:, u] = row_f
        self.sum_p[u, :] = row_p
        self.sum_p[:, u] = row_p

    def clusters(self) -> List[List[int]]:
        alive = self.alive.cpu().numpy()
        out = [sorted(self.members[i]) for i in range(self.n) if alive[i]]
        out.sort(key=lambda c: c[0])
        return out


def _argmax_edge(values: torch.Tensor, mask: torch.Tensor, n: int):
    masked = torch.where(mask, values, torch.full_like(values,
                                                       -float("inf")))
    flat = int(torch.argmax(masked))
    u, v = divmod(flat, n)
    return float(masked[u, v]), u, v


def torch_cluster_editing(weights: np.ndarray, mode: str, device
                          ) -> List[List[int]]:
    n = weights.shape[0]
    if n == 0:
        return []
    st = _TorchEditingState(weights, device)
    while True:
        und = st.undecided(positive_only=(mode == "fresh"))
        if not bool(und.any()):
            break
        icf, icp = st.icf_icp()
        if mode == "whatshap":
            m_icf, fu, fv = _argmax_edge(icf, und, n)
            m_icp, pu, pv = _argmax_edge(icp, und, n)
            if m_icf <= 0:
                break
            do_merge = m_icf >= m_icp
            u, v = (fu, fv) if do_merge else (pu, pv)
        else:
            _, u, v = _argmax_edge(torch.maximum(icf, icp), und, n)
            do_merge = bool(icf[u, v] >= icp[u, v])
        if do_merge:
            st.merge(u, v)
        else:
            st.forbid(u, v)
    return st.clusters()

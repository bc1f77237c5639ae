"""Synthetic vector datasets for the ANNS workloads (the paper's
glove/fashion-mnist/sift/deep/spacev stand-ins, scale-reduced).

The port's own copy of the reference package's ``data/vectors.py``:
the same generators and seeds, so both packages materialize the same
arrays.

Clustered Gaussians give HNSW/DiskANN-like graphs realistic navigability
structure (hubs inside clusters, sparse inter-cluster edges) so locality
benchmarks (Fig. 16/17) behave like the paper's datasets.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VectorDataset:
    """Low-intrinsic-dimension clustered data in a high ambient dim.

    Points live on an ``intrinsic``-dimensional subspace (random linear
    embedding into ``dim``) with clustered density plus mild ambient
    noise. This matches real embedding datasets — SIFT/GloVe/deep have
    intrinsic dimension ~10-20 — and is what makes greedy graph search
    achieve the paper's 90-95% recall operating point. (Two designs that
    do NOT work and that we tested: (a) well-separated full-rank Gaussian
    islands — no density bridges, the medoid can reach at most ``degree``
    clusters, recall caps at ~0.5 regardless of beam width; (b) adding
    full-rank background points — near-equidistant neighbors, the
    curse-of-dimensionality regime where recall@10 is ill-posed.)"""

    name: str
    n: int
    dim: int
    clusters: int = 32
    spread: float = 0.35
    intrinsic: int = 8
    ambient_noise: float = 0.02
    seed: int = 0

    def _basis(self):
        rng = np.random.default_rng(self.seed + 7919)
        a = rng.standard_normal((self.intrinsic, self.dim))
        q, _ = np.linalg.qr(a.T)                       # (dim, intrinsic)
        return q.T                                     # orthonormal rows

    def _centers(self):
        rng = np.random.default_rng(self.seed)
        return rng.standard_normal((self.clusters, self.intrinsic))

    def _sample(self, num: int, rng) -> np.ndarray:
        centers = self._centers()
        assign = rng.integers(0, self.clusters, size=num)
        z = centers[assign] + self.spread * rng.standard_normal(
            (num, self.intrinsic))
        x = z @ self._basis()
        x += self.ambient_noise * rng.standard_normal((num, self.dim))
        return x.astype(np.float32)

    def materialize(self) -> np.ndarray:
        return self._sample(self.n, np.random.default_rng(self.seed))

    def queries(self, num: int, seed: int = 1) -> np.ndarray:
        return self._sample(num, np.random.default_rng(self.seed + seed))


# Scale-reduced stand-ins for the paper's five datasets (names preserved
# so benchmark tables read like the paper's figures). The intrinsic dims
# are tuned so a Vamana graph at r=16, L=32 lands on the paper's
# recall@10 operating points (95/95/94/93/90% — §VII-A).
PAPER_DATASETS = {
    "glove-100": VectorDataset("glove-100", n=8192, dim=100, clusters=24,
                               intrinsic=18, seed=100),
    "fashion-mnist": VectorDataset("fashion-mnist", n=8192, dim=784,
                                   clusters=10, intrinsic=18, seed=101),
    "sift-1b": VectorDataset("sift-1b", n=16384, dim=128, clusters=48,
                             intrinsic=20, seed=102),
    "deep-1b": VectorDataset("deep-1b", n=16384, dim=96, clusters=48,
                             intrinsic=20, seed=103),
    "spacev-1b": VectorDataset("spacev-1b", n=16384, dim=100, clusters=48,
                               intrinsic=24, seed=104),
}

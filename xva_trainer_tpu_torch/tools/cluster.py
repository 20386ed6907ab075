"""The clustering that the speaker tools and diarization need, in numpy and
scipy, in place of scikit-learn (which the card's machine does not have).

The JAX package calls scikit-learn three times: ``KMeans(n_init=4,
random_state=0)`` and ``AffinityPropagation(random_state=0)`` in
``tools/speaker_tools.py:73-79``, and Ward ``AgglomerativeClustering`` in
``tools/diarize.py:304-311``.

- ``affinity_propagation`` is scikit-learn's algorithm step for step:
  similarities are negative squared euclidean distances (computed in
  float64 and rounded to the input's float32, as scikit-learn does), the
  preference is their median, damping 0.5, at most 200 iterations, 15
  unchanged ones to converge, the same tie-breaking noise from
  ``RandomState(0)``, and labels numbered by exemplar index.
- ``ward_labels`` builds the tree with ``scipy.cluster.hierarchy.ward``, as
  scikit-learn does without a connectivity matrix, and cuts it into k
  clusters numbered as scikit-learn's ``_hc_cut`` numbers them (a heap of
  the largest node indices). The numbering is output: diarization's mode
  filter breaks a three-way tie by the smallest label, and its folders are
  named ``speaker_<label>``.
- ``kmeans_labels`` is the port's own k-means (``data/xva_dataset.py``):
  four k-means++ starts, the least inertia wins. Its draws cannot be
  scikit-learn's, so on separable data its partition is scikit-learn's and
  its cluster numbers may differ.
"""
from __future__ import annotations

import heapq
import warnings

import numpy as np


def _squared_euclidean(x: np.ndarray) -> np.ndarray:
    """``sklearn.metrics.euclidean_distances(x, squared=True)`` for x == y:
    float32 rows upcast to float64, ``-2 x·xᵀ + |x|² + |x|²``, rounded back to
    the input's float32, clipped at 0, the diagonal 0."""
    x64 = np.asarray(x, np.float64)
    sq = np.einsum("ij,ij->i", x64, x64)
    d = -2 * (x64 @ x64.T)
    d += sq[:, None]
    d += sq[None, :]
    if x.dtype == np.float32:
        d = d.astype(np.float32)
    np.maximum(d, 0, out=d)
    np.fill_diagonal(d, 0)
    return d


def affinity_propagation(x: np.ndarray, damping: float = 0.5, max_iter: int = 200,
                         convergence_iter: int = 15, seed: int = 0) -> np.ndarray:
    """Labels of ``AffinityPropagation(random_state=seed).fit_predict(x)``;
    all -1 when no exemplar emerges, as scikit-learn gives them."""
    x = np.asarray(x)
    if x.dtype != np.float32:
        x = x.astype(np.float64)
    S = -_squared_euclidean(x)
    preference = np.asarray(np.median(S))
    n = S.shape[0]
    off = ~np.eye(n, dtype=bool)
    if n == 1 or np.all(S[off] == S[off][0]):
        warnings.warn("All samples have mutually equal similarities. "
                      "Returning arbitrary cluster center(s).")
        if preference.flat[0] > S.flat[n - 1]:
            return np.arange(n)
        return np.zeros(n, np.int64)

    random_state = np.random.RandomState(seed)
    S.flat[:: n + 1] = preference
    A = np.zeros((n, n))
    R = np.zeros((n, n))
    tmp = np.zeros((n, n))
    # remove degeneracies
    S += (np.finfo(S.dtype).eps * S + np.finfo(S.dtype).tiny * 100) * \
        random_state.standard_normal(size=(n, n))
    e = np.zeros((n, convergence_iter))
    ind = np.arange(n)
    for it in range(max_iter):
        # responsibilities
        np.add(A, S, tmp)
        I = np.argmax(tmp, axis=1)
        Y = tmp[ind, I]
        tmp[ind, I] = -np.inf
        Y2 = np.max(tmp, axis=1)
        np.subtract(S, Y[:, None], tmp)
        tmp[ind, I] = S[ind, I] - Y2
        tmp *= 1 - damping
        R *= damping
        R += tmp
        # availabilities
        np.maximum(R, 0, out=tmp)
        tmp.flat[:: n + 1] = R.flat[:: n + 1]
        tmp -= np.sum(tmp, axis=0)
        dA = np.diag(tmp).copy()
        tmp.clip(0, np.inf, tmp)
        tmp.flat[:: n + 1] = dA
        tmp *= 1 - damping
        A *= damping
        A -= tmp
        # convergence: the exemplar set unchanged for convergence_iter steps
        E = (np.diag(A) + np.diag(R)) > 0
        e[:, it % convergence_iter] = E
        K = np.sum(E, axis=0)
        if it >= convergence_iter:
            se = np.sum(e, axis=1)
            unconverged = np.sum((se == convergence_iter) + (se == 0)) != n
            if (not unconverged and (K > 0)) or (it == max_iter):
                break

    I = np.flatnonzero(E)
    K = I.size
    if K == 0:
        return np.full(n, -1, np.int64)
    c = np.argmax(S[:, I], axis=1)
    c[I] = np.arange(K)
    # refine the exemplars, then the clusters
    for k in range(K):
        ii = np.asarray(c == k).nonzero()[0]
        j = np.argmax(np.sum(S[ii[:, np.newaxis], ii], axis=0))
        I[k] = ii[j]
    c = np.argmax(S[:, I], axis=1)
    c[I] = np.arange(K)
    labels = I[c]
    return np.searchsorted(np.unique(labels), labels)


def _descendants(node: int, children: np.ndarray, n_leaves: int) -> list:
    out, stack = [], [node]
    while stack:
        i = stack.pop()
        if i < n_leaves:
            out.append(i)
        else:
            stack.extend(children[i - n_leaves])
    return out


def ward_labels(x: np.ndarray, k: int) -> np.ndarray:
    """Labels of ``AgglomerativeClustering(n_clusters=k).fit_predict(x)``
    (Ward linkage, euclidean, no connectivity), numbering included."""
    from scipy.cluster import hierarchy

    x = np.require(x, requirements="W")
    n = len(x)
    if k > n:
        raise ValueError(f"Cannot extract more clusters than samples: {k} clusters were "
                         f"given for a tree with {n} leaves.")
    children = hierarchy.ward(x)[:, :2].astype(np.intp)
    # a heap of negated node indices: the largest node splits next
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(k - 1):
        these = children[-nodes[0] - n]
        heapq.heappush(nodes, -these[0])
        heapq.heappushpop(nodes, -these[1])
    labels = np.zeros(n, dtype=np.intp)
    for i, node in enumerate(nodes):
        labels[_descendants(-node, children, n)] = i
    return labels


def kmeans_labels(x: np.ndarray, k: int) -> np.ndarray:
    """Labels of the port's k-means with four k-means++ starts (seed 0)."""
    from ..data.xva_dataset import kmeans

    return kmeans(x, k, n_init=4, seed=0)[1]

"""The port's clustering (``xva_trainer_tpu_torch/tools/cluster.py``) against
scikit-learn, which the JAX package calls and the port may not: affinity
propagation's labels equal (``AffinityPropagation(random_state=0)``), Ward's
labels equal numbering included (``AgglomerativeClustering(n_clusters=k)``),
and the k-means partition equal on separable clusters
(``KMeans(n_init=4, random_state=0)``; its cluster numbers may differ).
scikit-learn is present here and absent on the card's machine; the port
never imports it (``tests/test_torch_imports.py``)."""
import warnings

import numpy as np
import pytest
from sklearn.cluster import AffinityPropagation, AgglomerativeClustering, KMeans

from xva_trainer_tpu_torch.tools.cluster import affinity_propagation, kmeans_labels, ward_labels


def blobs(seed, n, d, k, spread=1.0, dtype=np.float32, unit=False):
    rng = np.random.default_rng(seed)
    centres = 3.0 * rng.standard_normal((k, d))
    x = centres[rng.integers(k, size=n)] + spread * rng.standard_normal((n, d))
    if unit:  # rows on the unit sphere, as the speaker embeddings are
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(dtype)


CASES = [dict(seed=s, n=n, d=d, k=k, dtype=dt, unit=u)
         for s, (n, d, k, dt, u) in enumerate([
             (40, 8, 3, np.float32, False), (97, 16, 5, np.float64, False),
             (60, 512, 4, np.float32, True), (150, 2, 6, np.float64, False),
             (12, 40, 2, np.float32, True), (256, 512, 8, np.float32, True),
             (33, 3, 3, np.float32, False)])]


def _partition(labels):
    return sorted(sorted(np.flatnonzero(labels == c).tolist()) for c in np.unique(labels))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c['n']}_d{c['d']}_k{c['k']}")
def test_affinity_propagation_matches_sklearn(case):
    x = blobs(case["seed"], case["n"], case["d"], case["k"], 1.5, case["dtype"], case["unit"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = AffinityPropagation(random_state=0).fit_predict(x)
    np.testing.assert_array_equal(affinity_propagation(x), ref)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c['n']}_d{c['d']}_k{c['k']}")
def test_ward_matches_sklearn_with_its_numbering(case):
    x = blobs(case["seed"], case["n"], case["d"], case["k"], 2.0, case["dtype"], case["unit"])
    for k in range(2, min(9, case["n"])):
        ref = AgglomerativeClustering(n_clusters=k).fit_predict(x)
        np.testing.assert_array_equal(ward_labels(x, k), ref, err_msg=f"k={k}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c['n']}_d{c['d']}_k{c['k']}")
def test_kmeans_partition_matches_sklearn_on_separable_clusters(case):
    x = blobs(case["seed"], case["n"], case["d"], case["k"], 0.2, case["dtype"], case["unit"])
    ref = KMeans(n_clusters=case["k"], n_init=4, random_state=0).fit_predict(x)
    assert _partition(kmeans_labels(x, case["k"])) == _partition(ref)


def test_edge_cases_match_sklearn():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for x in (np.ones((5, 3), np.float32), np.zeros((1, 4), np.float32),
                  np.array([[0.0], [1.0]], np.float32)):
            np.testing.assert_array_equal(affinity_propagation(x),
                                          AffinityPropagation(random_state=0).fit_predict(x))
    with pytest.raises(ValueError, match="more clusters than samples"):
        ward_labels(np.zeros((3, 2), np.float32), 4)

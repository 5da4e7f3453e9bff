"""The plain reference against hand-worked cases."""

import numpy as np

from gwasbench import reference

FP = (0.1, 28.374, 0.1, 0.05, 0.2, 0.5)


def _data(g1, g2, y=None, c=None):
    n1, n2 = len(g1), len(g2)
    y = np.zeros(n1 + n2) if y is None else np.asarray(y, float)
    c = np.zeros((n1 + n2, 1)) if c is None else np.asarray(c, float)
    return {1: (np.asarray(g1, np.int8), y[:n1], c[:n1]),
            2: (np.asarray(g2, np.int8), y[n1:], c[n1:])}


def test_qc_filter_hand_worked():
    # 20 individuals, 3 SNPs: A all hom-ref (MAF 0 fails), B 4 missing
    # (16 < 0.9 x 20 observed fails), C 5 / 10 / 5 (p = 0.5, HWE exact: kept)
    a = [0] * 20
    b = [-1] * 4 + [0, 1, 2, 1] * 4
    c = [0] * 5 + [1] * 10 + [2] * 5
    g = np.stack([a, b, c], 1)
    keep = reference.qc_filter(_data(g[:10], g[10:]), FP)
    assert keep.tolist() == [False, False, True]


def test_assoc_stats_hand_worked():
    # y and g projected off [1 | c], c = (1, -1, 1, -1) orthogonal to 1:
    # y~ = (-1, -1, 1, 1), g~ = (-1, 0, 1, 0), y~ . g = 2, so 2 / sqrt(2) / 2
    g = np.array([[0], [1], [2], [1]])
    y = [1, 0, 3, 2]
    c = [[1], [-1], [1], [-1]]
    got = reference.assoc_stats(_data(g[:2], g[2:], y, c), np.array([True]))
    assert np.allclose(got, [1 / np.sqrt(2)], rtol=0, atol=1e-12)


def test_inv_sqrt_and_errors():
    assert reference.inv_sqrt([4.0, 0.25]).tolist() == [0.5, 2.0]
    e = reference.abs_errors([1.0, 2.0], [1.0, 2.5])
    assert e == {"max": 0.5, "rms": float(np.sqrt(0.125))}
    assert reference.abs_errors([1.0], [1.0, 2.0])["max"] == float("inf")
    assert reference.abs_errors([1.0, float("nan")], [1.0, 2.0])["rms"] == float("inf")

"""ATE after Horn alignment, against hand cases."""
import numpy as np

from benchmark.reference import quality as Q


def _poses(points):
    out = []
    for p in points:
        m = np.eye(4)
        m[:3, 3] = p
        out.append(m)
    return out


def test_rigid_motion_is_aligned_away():
    gt = np.array([[0, 0, 0], [1, 0, 0], [1, 2, 0], [0, 1, 3.0]])
    a = np.pi / 2
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    est = gt @ R.T + np.array([5.0, -2.0, 1.0])
    err = Q.ate_errors(_poses(gt), _poses(est))
    assert np.max(err) < 1e-12


def test_stretched_path():
    """Two points 1 m apart against the same two 2 m apart: the best rigid
    fit centres them, leaving 0.5 m at each."""
    gt = np.array([[0, 0, 0], [1, 0, 0.0]])
    est = np.array([[0, 0, 0], [2, 0, 0.0]])
    err = Q.ate_errors(_poses(gt), _poses(est))
    assert np.allclose(err, [0.5, 0.5])


def test_w2c_from_quaternion():
    m = Q.w2c_from([2.0, 0, 0, 0], [1, 2, 3])
    assert np.allclose(m[:3, :3], np.eye(3))
    assert np.allclose(m[:3, 3], [1, 2, 3])

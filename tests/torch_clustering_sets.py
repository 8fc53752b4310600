"""Point sets on which the port's cluster tree is held bitwise against the
reference's: a grid, a stretched grid whose split axis changes, a 3D
cloud, and integer points with heavy ties and both signs of zero."""
import numpy as np

from repro_torch.core.clustering import regular_grid_points


def grid(n: int, seed: int) -> np.ndarray:
    return regular_grid_points(int(round(np.sqrt(n))), 2)


def stretched(n: int, seed: int) -> np.ndarray:
    return regular_grid_points(int(round(np.sqrt(n))), 2, -1.0, 1.0) \
        * np.array([1.0, 3.0])


def cloud3d(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (n, 3))


def ties(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.integers(-3, 4, (n, 2)).astype(np.float64)
    return np.where(pts == 0, rng.choice([-0.0, 0.0], pts.shape), pts)


SETS = {"grid": grid, "stretched": stretched, "cloud3d": cloud3d,
        "ties": ties}


def bits(a: np.ndarray) -> np.ndarray:
    """The bit patterns of a float64 array (tells -0.0 from +0.0)."""
    return np.ascontiguousarray(a, dtype=np.float64).view(np.int64)


def box_bits(a: np.ndarray) -> np.ndarray:
    """The bit patterns of a box side, zeros taken as +0.0: where a node's
    extreme is a zero held with both signs, which sign a min or max
    returns follows the reduction's order of evaluation (numpy's, the
    device's), not the tree."""
    return bits(a + 0.0)


def assert_same_tree(got, want) -> None:
    assert got.depth == want.depth and got.leaf_size == want.leaf_size
    assert got.perm.dtype == want.perm.dtype
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(bits(got.points), bits(want.points))
    assert len(got.box_min) == len(want.box_min) == want.depth + 1
    for l in range(want.depth + 1):
        for a, b in ((got.box_min[l], want.box_min[l]),
                     (got.box_max[l], want.box_max[l])):
            assert a.shape == b.shape, l
            np.testing.assert_array_equal(box_bits(a), box_bits(b),
                                          err_msg=f"level {l}")

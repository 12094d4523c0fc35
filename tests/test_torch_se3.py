"""The port's SE(3) algebra, its numpy twin and point batches against the
reference, on the same numpy inputs, on the CPU.

Tolerance: atol 1e-6 plus rtol 1e-6 — the float32 formulas are the same;
only the order and fusing (FMA) of small products differ, a few ulps, and a
float32 ulp of a 5-10 m translation is already 5e-7 to 1e-6. ``pose_log``
and ``pose_interp`` get rtol 1e-5: their V⁻¹ coefficient
(1 − θ·sinθ / (2(1 − cosθ))) / θ² carries the ulp by which XLA's and
PyTorch's sin/cos differ, amplified ~10× at θ ≈ 2.5 rad.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.common import pointcloud as jpc
from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu.common import se3np as jse3np
from lmsf_slam_tpu_torch.common import pointcloud as ppc
from lmsf_slam_tpu_torch.common import se3 as pse3
from lmsf_slam_tpu_torch.common import se3np as pse3np
from tests import torch_threads  # noqa: F401

ATOL = 1e-6
RTOL = 1e-6
B = 64


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _poses(rng, n):
    return np.concatenate(
        [_quats(rng, n), rng.normal(scale=5.0, size=(n, 3)).astype(np.float32)], axis=1
    )


def _tangents(rng, n):
    # mix of the Taylor branch (tiny angles) and the exact branch
    scale = np.where(np.arange(n)[:, None] % 2 == 0, 1e-4, 0.7)
    return (rng.normal(size=(n, 6)) * scale).astype(np.float32)


def _inputs(rng):
    a, b = _poses(rng, B), _poses(rng, B)
    return {
        "q": _quats(rng, B), "q2": _quats(rng, B), "v": rng.normal(size=(B, 3)).astype(np.float32),
        "w": _tangents(rng, B)[:, :3], "xi": _tangents(rng, B), "a": a, "b": b,
        "pts": rng.normal(scale=10.0, size=(B, 20, 3)).astype(np.float32),
        "R": np.asarray(jse3.quat_to_matrix(jnp.asarray(_quats(rng, B)))),
        "alpha": np.float32(0.3),
    }


# name → (argument keys); the same call on both packages
CASES = {
    "skew": ("v",),
    "quat_normalize": ("q",),
    "quat_mul": ("q", "q2"),
    "quat_conj": ("q",),
    "quat_rotate": ("q", "v"),
    "quat_to_matrix": ("q",),
    "matrix_to_quat": ("R",),
    "so3_exp_quat": ("w",),
    "so3_log": ("q",),
    "so3_exp_matrix": ("w",),
    "make_pose": ("q", "v"),
    "pose_compose": ("a", "b"),
    "pose_inverse": ("a",),
    "pose_apply": ("a", "v"),
    "pose_between": ("a", "b"),
    "se3_exp": ("xi",),
    "pose_log": ("a",),
    "pose_retract": ("a", "xi"),
    "pose_to_matrix": ("a",),
    "pose_interp": ("a", "b", "alpha"),
    "quat_left_matrix": ("q",),
    "quat_right_matrix": ("q",),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se3_matches_reference(name):
    x = _inputs(np.random.default_rng(7))
    args = [x[k] for k in CASES[name]]
    want = np.asarray(getattr(jse3, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(pse3, name)(*[torch.as_tensor(np.array(a)) for a in args]).numpy()
    rtol = 1e-5 if name in ("pose_log", "pose_interp") else RTOL
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol)


def test_pose_apply_batched_points():
    x = _inputs(np.random.default_rng(8))
    want = np.asarray(jse3.pose_apply(jnp.asarray(x["a"]), jnp.asarray(x["pts"])))
    got = pse3.pose_apply(torch.as_tensor(x["a"]), torch.as_tensor(x["pts"])).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_matrix_to_pose_roundtrip():
    x = _inputs(np.random.default_rng(9))
    m = np.asarray(jse3.pose_to_matrix(jnp.asarray(x["a"])))
    want = np.asarray(jse3.matrix_to_pose(jnp.asarray(m)))
    got = pse3.matrix_to_pose(torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_identities():
    np.testing.assert_array_equal(
        pse3.pose_identity((3,), device="cpu").numpy(), np.asarray(jse3.pose_identity((3,)))
    )
    np.testing.assert_array_equal(
        pse3.quat_identity((2,), device="cpu").numpy(), np.asarray(jse3.quat_identity((2,)))
    )


SE3NP = ["quat_normalize", "quat_mul", "quat_conj", "quat_rotate", "so3_exp_quat",
         "so3_log", "pose_compose", "pose_inverse", "pose_between", "se3_exp",
         "pose_log", "pose_retract"]


@pytest.mark.parametrize("name", SE3NP)
def test_se3np_matches_reference(name):
    """The port's own copy of the host twin is the same float64 arithmetic."""
    rng = np.random.default_rng(11)
    args = {
        "quat_normalize": (_quats(rng, 1)[0] * 3,),
        "quat_mul": (_quats(rng, 1)[0], _quats(rng, 1)[0]),
        "quat_conj": (_quats(rng, 1)[0],),
        "quat_rotate": (_quats(rng, 1)[0], rng.normal(size=3)),
        "so3_exp_quat": (rng.normal(size=3) * 0.4,),
        "so3_log": (_quats(rng, 1)[0],),
        "pose_compose": (_poses(rng, 1)[0], _poses(rng, 1)[0]),
        "pose_inverse": (_poses(rng, 1)[0],),
        "pose_between": (_poses(rng, 1)[0], _poses(rng, 1)[0]),
        "se3_exp": (rng.normal(size=6) * 0.4,),
        "pose_log": (_poses(rng, 1)[0],),
        "pose_retract": (_poses(rng, 1)[0], rng.normal(size=6) * 0.1),
    }[name]
    want = getattr(jse3np, name)(*args)
    got = getattr(pse3np, name)(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pointbatch_from_points_empty_transform():
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(37, 3)).astype(np.float32)
    attr = rng.random((37, 2)).astype(np.float32)
    jb = jpc.PointBatch.from_points(pts, 50, attr=attr)
    pb = ppc.PointBatch.from_points(pts, 50, attr=attr, device="cpu")
    for f in ("xyz", "mask", "attr"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)))
    assert int(pb.count()) == int(jb.count()) == 37
    pose = _poses(rng, 1)[0]
    np.testing.assert_allclose(
        pb.transform(torch.as_tensor(pose)).xyz.numpy(),
        np.asarray(jb.transform(jnp.asarray(pose)).xyz), atol=ATOL, rtol=RTOL,
    )
    np.testing.assert_array_equal(pb.to_numpy(), jb.to_numpy())
    e = ppc.PointBatch.empty(8, attr_dim=1, device="cpu")
    je = jpc.PointBatch.empty(8, attr_dim=1)
    assert e.attr.shape == je.attr.shape and not e.mask.any()


@pytest.mark.parametrize("capacity", [None, 200, 60])
def test_concat_matches_reference(capacity):
    rng = np.random.default_rng(13)
    parts = []
    for n, cap, adim in ((30, 64, 1), (10, 40, 0), (55, 80, 2)):
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        attr = rng.random((n, adim)).astype(np.float32) if adim else None
        parts.append((pts, cap, attr))
    jb = jpc.concat([jpc.PointBatch.from_points(p, c, attr=a) for p, c, a in parts], capacity)
    pb = ppc.concat(
        [ppc.PointBatch.from_points(p, c, attr=a, device="cpu") for p, c, a in parts], capacity
    )
    for f in ("xyz", "mask", "attr"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)))

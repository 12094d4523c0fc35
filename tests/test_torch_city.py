"""The port's city course (``lmsf_slam_tpu_torch.datasets.city``) against the
reference's (``lmsf_slam_tpu/datasets/city.py``): world, course and mover
boxes are all host numpy seeded by one integer, which the reference draws
from a JAX key and the port takes as it is. Given that integer everything is
equal bit for bit; a scan of the world rendered by the two simulators agrees
to 1e-4 m + 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lmsf_slam_tpu.datasets import city as jcity
from lmsf_slam_tpu.datasets import simulator as jsim
from lmsf_slam_tpu_torch.datasets import city as pcity
from lmsf_slam_tpu_torch.datasets import simulate_scan
from tests import torch_threads  # noqa: F401


def seed_of(key):
    """The integer the reference derives from its key."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


@pytest.mark.parametrize("seed", [0, 7])
def test_world_and_movers_equal_the_reference_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    jw, pw = jcity.make_city_world(key), pcity.make_city_world(seed_of(key))
    for name in ("boxes_min", "boxes_max", "cylinders"):
        a, b = np.asarray(getattr(jw, name)), getattr(pw, name)
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert pw.boxes_min.shape == (18, 3) and pw.cylinders.shape == (136, 4)
    assert float(jw.ground_z) == pw.ground_z == 0.0
    mkey = jax.random.fold_in(key, 999)
    jm, pm = jcity.make_movers(mkey), pcity.make_movers(seed_of(mkey))
    for frame in (0, 1, 57, 399, 1500):
        (a0, a1), (b0, b1) = jm(frame), pm(frame)
        np.testing.assert_array_equal(b0, a0)
        np.testing.assert_array_equal(b1, a1)
        jwm = jcity.world_with_movers(jw, jm, frame)
        pwm = pcity.world_with_movers(pw, pm, frame)
        np.testing.assert_array_equal(pwm.boxes_min, np.asarray(jwm.boxes_min))
        np.testing.assert_array_equal(pwm.boxes_max, np.asarray(jwm.boxes_max))
        assert pwm.boxes_min.shape == (26, 3) and pwm.cylinders is pw.cylinders
    assert (pm(0)[0] != pm(10)[0]).any()  # they move


def test_course_and_constants_equal_the_reference():
    assert pcity.HDL64 == jcity.HDL64 and pcity.HDL64_SENSOR_Z == jcity.HDL64_SENSOR_Z
    assert pcity.DEFAULT_ROUTE == jcity.DEFAULT_ROUTE
    a, b = jcity.make_city_course(), pcity.make_city_course()
    assert b.dtype == np.float32 and b.shape == a.shape == (1704, 7)
    np.testing.assert_array_equal(b, a)
    short = [(0, 0), (1, 0), (1, 1)]
    np.testing.assert_array_equal(pcity.make_city_course(short, speed=0.5),
                                  jcity.make_city_course(short, speed=0.5))
    # the block perimeter comes back past the origin near frame 250 (the
    # rounded corner passes it at ~3 m) and re-drives the first street
    d = np.linalg.norm(b[200:300, 4:6] - b[0, 4:6], axis=1)
    assert d.min() < 4.0 and 230 <= 200 + int(d.argmin()) <= 270
    assert np.abs(b[260:300, 5] - b[0, 5]).max() < 0.5


def test_scans_of_the_city_agree_between_the_simulators():
    """A narrow scan (16 × 180 of the HDL-64 fan) from the tenth course pose
    with movers: same validity, points to 1e-4 m + 1e-4 relative (no noise; ranges reach 80 m)."""
    key = jax.random.PRNGKey(0)
    jw = jcity.world_with_movers(jcity.make_city_world(key),
                                 jcity.make_movers(jax.random.fold_in(key, 999)), 10)
    pw = pcity.world_with_movers(pcity.make_city_world(seed_of(key)),
                                 pcity.make_movers(seed_of(jax.random.fold_in(key, 999))), 10)
    pose = pcity.make_city_course()[10]
    kw = dict(rings=16, width=180, elev_min=pcity.HDL64["elev_min"],
              elev_max=pcity.HDL64["elev_max"], max_range=80.0, min_range=2.5, noise=0.0)
    want = jsim.simulate_scan(jw, jnp.asarray(pose), key, **kw)
    got = simulate_scan(pw, pose, np.zeros(16 * 180, np.float32), device="cpu", **kw)
    wm, gm = np.asarray(want.mask), got.mask.numpy()
    assert (wm != gm).sum() <= 2 and gm.sum() > 1000  # a ray at the range limit may flip
    both = wm & gm
    np.testing.assert_allclose(got.xyz.numpy()[both], np.asarray(want.xyz)[both], atol=1e-4, rtol=1e-4)

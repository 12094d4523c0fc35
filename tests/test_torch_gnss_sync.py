"""The port's host-side ingest modules against the reference's, on the same
inputs: GNSS coordinates (``estimator/gnss.py``), NMEA parsing
(``estimator/nmea.py``), stream synchronization (``common/sync.py``), the
city course's IMU stream (``datasets/city.py::make_city_imu``) and the
motion-blurred simulator sweep (``datasets/simulator.py::
simulate_scan_moving``).

The host modules are numpy / pure Python in both packages: their outputs
must be equal (ENU to 1e-9 m). The sweep is float32 tensor math on one side
and XLA on the other: the same rays hit, and all but 0.1 % of the
coordinates agree to 1e-4 m and 5e-5 relative, as
``tests/test_torch_preprocess_voxel_features.py`` holds ``simulate_scan``;
rays that graze an edge to 5e-3 m.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lmsf_slam_tpu.common import sync as jsync
from lmsf_slam_tpu.datasets import city as jcity
from lmsf_slam_tpu.datasets import simulator as jsim
from lmsf_slam_tpu.estimator import gnss as jgnss
from lmsf_slam_tpu.estimator import nmea as jnmea
from lmsf_slam_tpu_torch.common import sync as psync
from lmsf_slam_tpu_torch.datasets import city as pcity
from lmsf_slam_tpu_torch.datasets import make_sim_world, simulate_scan_moving
from lmsf_slam_tpu_torch.estimator import gnss as pgnss
from lmsf_slam_tpu_torch.estimator import nmea as pnmea
from tests.test_nmea import GGA, RMC, _cksum


def test_lla_enu_matches_reference():
    ref = np.array([48.0, 11.0, 500.0])
    rng = np.random.default_rng(0)
    pts = ref + np.concatenate([rng.normal(scale=1e-3, size=(50, 2)),
                                rng.normal(scale=20.0, size=(50, 1))], 1)
    jf, pf = jgnss.make_enu_frame(ref), pgnss.make_enu_frame(ref)
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pgnss.lla_to_ecef(pts), jgnss.lla_to_ecef(pts))
    got, want = pgnss.lla_to_enu(pf, pts), jgnss.lla_to_enu(jf, pts)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # the reason this stays float64 on the host: centimetres survive
    cm = pgnss.lla_to_enu(pf, np.array([48.0, 11.0 + 1.5e-7, 500.0]))
    assert 0.005 < float(cm[0]) < 0.02


SENTENCES = [
    GGA, RMC, GGA[:-1] + "0",
    _cksum("GPRMC,000001,A,4807.038,S,01131.000,W,0.0,0.0,010100,,"),
    _cksum("GPRMC,123519,V,4807.038,N,01131.000,E,,,230394,,"),
    _cksum("GPGGA,123519,4807.038,N,01131.000,E,0,00,,,M,,M,,"),
    _cksum("GNGGA,123519,4807.038,N,01131.000,E,1,08,0.9,545.4,M,,M,,"),
    _cksum("GPGGA,123519,4807.038,N,01131.000,E,2,xx,abc,,M,,M,,"),
    "lorem ipsum", "$GPXTE,A,A,0.67,L,N*6F", "$GPGGA,1,2*ZZ",
]


@pytest.mark.parametrize("sentence", SENTENCES)
def test_parse_nmea_matches_reference(sentence):
    got, want = pnmea.parse_nmea(sentence), jnmea.parse_nmea(sentence)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_equal(tuple(got), tuple(want))


def test_nmea_stream_matches_reference():
    """A serial stream cut at arbitrary points, with garbage and an
    over-long terminator-free run."""
    text = "\r\n".join(SENTENCES) + "\r\n" + "x" * 200 + "\n" + GGA + "\n$GP"
    rng = np.random.default_rng(1)
    cuts = np.sort(rng.choice(len(text), 30, replace=False))
    ps, js = pnmea.NmeaStream(), jnmea.NmeaStream()
    for a, b in zip(np.concatenate([[0], cuts]), np.concatenate([cuts, [len(text)]])):
        chunk = text[a:b].encode() if a % 2 else text[a:b]
        got, want = ps.feed(chunk), js.feed(chunk)
        np.testing.assert_equal([tuple(f) for f in got], [tuple(f) for f in want])
        assert ps._buf == js._buf


def jittered_imu(n=300, seed=2):
    """A 100 Hz stream with timing jitter and dropped samples."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.006, 0.014, n))
    keep = rng.random(n) > 0.05
    gyro = rng.normal(size=(n, 3)).astype(np.float32)
    acc = (rng.normal(size=(n, 3)) + [0, 0, 9.81]).astype(np.float32)
    return t[keep], gyro[keep], acc[keep]


def test_imu_window_buffer_matches_reference():
    t, gyro, acc = jittered_imu()
    pb, jb = psync.ImuWindowBuffer(max_samples=128), jsync.ImuWindowBuffer(max_samples=128)
    windows = 0
    for k, (tk, g, a) in enumerate(zip(t, gyro, acc)):
        pb.push(tk, g, a)
        jb.push(tk, g, a)
        if k % 10 == 9:
            t0, t1 = tk - 0.1, tk - 0.004
            got, want = pb.window(t0, t1), jb.window(t0, t1)
            assert (got is None) == (want is None)
            if got is not None:
                windows += 1
                for x, y in zip(got, want):
                    np.testing.assert_array_equal(x, y)
                    assert x.dtype == np.float32
            pb.drop_before(t0)
            jb.drop_before(t0)
            assert list(pb._t) == list(jb._t)
    assert windows > 20


class _Recorder:
    """A stand-in system: records what StreamIngest hands it."""

    def __init__(self, config):
        self.config = config
        self.calls, self.fixes = [], []

    def process(self, scans, t, **kw):
        self.calls.append((t, scans, {k: v.copy() for k, v in kw.items()}))
        return len(self.calls)

    def process_gnss(self, lla, pos_std=0.1):
        self.fixes.append((tuple(lla), pos_std))


def test_stream_ingest_matches_reference():
    from types import SimpleNamespace

    cfg = SimpleNamespace(n_lidars=1, use_imu=True)
    port, ref = _Recorder(cfg), _Recorder(cfg)
    pi, ji = psync.StreamIngest(port, slop=0.02), jsync.StreamIngest(ref, slop=0.02)
    t, gyro, acc = jittered_imu(seed=3)
    rng = np.random.default_rng(4)
    scan_t = 0.1 * np.arange(1, 25) + rng.uniform(-0.005, 0.005, 24)
    k = 0
    for i, ts in enumerate(scan_t):
        while k < len(t) and t[k] <= ts + 0.01:
            pi.push_imu(t[k], gyro[k], acc[k])
            ji.push_imu(t[k], gyro[k], acc[k])
            k += 1
        assert pi.push_scan(0, ts, f"scan{i}") == ji.push_scan(0, ts, f"scan{i}")
        if i == 5:
            pi.push_gnss(ts, [48.0, 11.0, 500.0])
            ji.push_gnss(ts, [48.0, 11.0, 500.0])
    assert len(port.calls) == len(ref.calls) > 20 and port.fixes == ref.fixes
    for (tp, sp, kp), (tr, sr, kr) in zip(port.calls, ref.calls):
        assert (tp, sp, sorted(kp)) == (tr, sr, sorted(kr))
        for name in kp:
            np.testing.assert_array_equal(kp[name], kr[name])
    assert pi.dropped == ji.dropped
    # two LiDARs: process gets the list of matched scans, primary first, and
    # the same IMU windows as the reference's
    cfg2 = SimpleNamespace(n_lidars=2, use_imu=True)
    port, ref = _Recorder(cfg2), _Recorder(cfg2)
    pi, ji = psync.StreamIngest(port, slop=0.02), jsync.StreamIngest(ref, slop=0.02)
    k = 0
    for i, ts in enumerate(scan_t):
        while k < len(t) and t[k] <= ts + 0.01:
            pi.push_imu(t[k], gyro[k], acc[k])
            ji.push_imu(t[k], gyro[k], acc[k])
            k += 1
        for lidar in ((1, 0) if i % 3 == 0 else (0, 1)):
            if (i, lidar) == (7, 1):
                continue  # a dropped sub scan
            ts_l = ts + (0.004 if lidar else 0.0)
            assert (pi.push_scan(lidar, ts_l, f"scan{i}.{lidar}")
                    == ji.push_scan(lidar, ts_l, f"scan{i}.{lidar}"))
    assert len(port.calls) == len(ref.calls) > 20
    for (tp, sp, kp), (tr, sr, kr) in zip(port.calls, ref.calls):
        assert (tp, sp, sorted(kp)) == (tr, sr, sorted(kr))
        assert isinstance(sp, list) and sp[0].endswith(".0") and sp[1].endswith(".1")
        for name in kp:
            np.testing.assert_array_equal(kp[name], kr[name])
    assert pi.dropped == ji.dropped
    # the N-stream matcher itself is the reference's
    ps_, js_ = psync.ApproxTimeSync(3, slop=0.02, queue_size=5), jsync.ApproxTimeSync(
        3, slop=0.02, queue_size=5)
    for i in range(60):
        for s in range(3):
            if (i + s) % 7 == 3:
                continue  # a dropped message
            ts = 0.1 * i + rng.uniform(-0.008, 0.008)
            assert ps_.push(s, ts, (s, i)) == js_.push(s, ts, (s, i))
    assert ps_.dropped == js_.dropped > 0


def test_make_city_imu_matches_reference():
    course = pcity.make_city_course()[:40]
    got, want = pcity.make_city_imu(course), jcity.make_city_imu(course)
    assert got[0] is None and want[0] is None and len(got) == len(want) == 40
    for g, w in zip(got[1:], want[1:]):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_simulate_scan_moving_matches_reference():
    """Same world, same sweep (a fast turn), no noise: the same scan; with
    noise, the port adds exactly the normals it is given."""
    world = make_sim_world(np.random.default_rng(5), extent=18.0, n_boxes=8, n_cylinders=14)
    jworld = jsim.SimWorld(*(jnp.asarray(a) for a in world[:3]), world.ground_z)
    p0 = np.array([1, 0, 0, 0, 0.5, -0.3, 1.2], np.float32)
    yaw = 0.3
    p1 = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2), 1.6, 0.2, 1.25], np.float32)
    kw = dict(rings=16, width=360, max_range=40.0)
    want = jsim.simulate_scan_moving(jworld, jnp.asarray(p0), jnp.asarray(p1),
                                     jax.random.PRNGKey(0), noise=0.0, **kw)
    zero = np.zeros(16 * 360, np.float32)
    got = simulate_scan_moving(world, p0, p1, zero, device="cpu", **kw)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.attr.numpy(), np.asarray(want.attr), rtol=1e-6)
    # each column's pose is a float32 exp of the sweep's twist, rounded
    # differently by XLA: a ray that grazes a trunk or a box edge moves its
    # hit by millimetres; every other coordinate agrees as the static scan's
    d = np.abs(got.xyz.numpy() - np.asarray(want.xyz))
    off = d > 1e-4 + 5e-5 * np.abs(np.asarray(want.xyz))
    assert off.mean() < 1e-3 and d.max() < 5e-3, (off.sum(), d.max())
    assert got.mask.sum() > 0.5 * 16 * 360
    normals = np.random.default_rng(6).standard_normal(16 * 360).astype(np.float32)
    noisy = simulate_scan_moving(world, p0, p1, normals, noise=0.01, device="cpu", **kw)
    both = (noisy.mask & got.mask).numpy()
    rng_clean = np.linalg.norm(got.xyz.numpy(), axis=1)
    rng_noisy = np.linalg.norm(noisy.xyz.numpy(), axis=1)
    np.testing.assert_allclose(rng_noisy[both] - rng_clean[both], 0.01 * normals[both], atol=1e-4)
    # a sweep that does not move is the static scan
    still = simulate_scan_moving(world, p0, p0, zero, device="cpu", **kw)
    static = jsim.simulate_scan(jworld, jnp.asarray(p0), jax.random.PRNGKey(0), noise=0.0, **kw)
    np.testing.assert_allclose(still.xyz.numpy(), np.asarray(static.xyz), atol=1e-4, rtol=5e-5)

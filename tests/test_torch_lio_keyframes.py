"""The keyframe decisions of the port's ``use_imu`` system against the
reference system's (float32, as it ships) over the first 8 frames of
``tests/test_lio.py``'s aggressive sequence (the scenario of
``tests/test_torch_lio_system.py``), on the CPU: the same frames pass the
gate and get the same database ids. A file of its own: the reference's
system compiles its programs on the first frames (~15 s on the CPU).
"""
import jax.numpy as jnp

from lmsf_slam_tpu.estimator import eskf_init_state as jeskf_init_state
from lmsf_slam_tpu.system import MultiLidarSystem as JSystem
from tests.test_lio import SCAN_HZ, skewed_scans  # noqa: F401
from tests.test_torch_lio_system import anchor_velocity, imu_kw, run_port, system_configs

N_COMPARED = 8


def test_system_with_imu_keyframes_match_reference(skewed_scans):  # noqa: F811
    _, poses, imu, scans = skewed_scans
    gt0 = poses[1]
    port = run_port(scans, imu, N_COMPARED, gt0)
    jcfg, _ = system_configs()
    ref = JSystem(jcfg)
    ref._lio.eskf = jeskf_init_state()._replace(v=jnp.asarray(anchor_velocity(gt0)))
    for i in range(N_COMPARED):
        ref.process(scans[i], i / SCAN_HZ, **imu_kw(imu, i))
    assert [r.is_keyframe for r in port.results] == [r.is_keyframe for r in ref.results]
    assert [r.keyframe_id for r in port.results] == [r.keyframe_id for r in ref.results]
    assert sum(r.is_keyframe for r in port.results) > 3

"""The window's propagation without corrections (``estimator/eskf.py::
eskf_propagate``) on the CPU, where it is ``eskf_run``'s loop. The LIO
tracker's ``_propagate`` returns what ``eskf_run`` returns for a window with
and without wheel speeds. The kernel does no wheel update, so asking for one
raises; so do an empty window and CPU tensors handed to the kernel's
wrapper. The kernel itself is held to the plain version on the card
(``tests/test_torch_eskf_cuda.py``) by ``kernel_cases.eskf_gaps``; here that
comparison is shown to catch a propagation whose bias blocks take the wrong
process noise, over windows of 1, 10 and 37 samples."""
import numpy as np
import pytest
import torch

import kernel_cases
from lmsf_slam_tpu_torch.common import se3
from lmsf_slam_tpu_torch.estimator import eskf as pe
from lmsf_slam_tpu_torch.lio.lio_tracker import LioConfig, LioTracker
from tests import torch_threads  # noqa: F401

window, start = kernel_cases.eskf_window, kernel_cases.eskf_start


def assert_bit_equal(got: pe.EskfState, want: pe.EskfState):
    for name in pe.EskfState._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, name
        assert torch.equal(a, b), f"{name}: max |Δ| {float(torch.max(torch.abs(a - b)))}"


# process-noise densities of the bias blocks that a faulty kernel would use:
# one dropped, the two swapped, the gyro's block given the accelerometer's
WRONG_BIAS_RATES = {
    "drop_ba": dict(acc_bias_noise=0.0),
    "drop_bg": dict(gyro_bias_noise=0.0),
    "swap": dict(acc_bias_noise=pe.EskfConfig().gyro_bias_noise,
                 gyro_bias_noise=pe.EskfConfig().acc_bias_noise),
    "bg_takes_ba": dict(gyro_bias_noise=pe.EskfConfig().acc_bias_noise),
}


@pytest.mark.parametrize("fault", WRONG_BIAS_RATES)
@pytest.mark.parametrize("n", [1, 10, 37])
def test_gaps_catch_wrong_bias_noise_from_zero_covariance(n, fault):
    """The bias blocks' process noise is 1e-10 (accelerometer) and 1e-12
    (gyro) a 10 ms step, below one float32 rounding of the initial bias
    variances, so only a window from a zero covariance shows it. From there
    ``eskf_gaps``, which scales each covariance entry by its own correlation,
    holds the plain version to itself and refuses one whose bias noise is
    wrong."""
    gyro, acc, dts = (torch.as_tensor(x) for x in window(n, 10 * n + 1))
    st = start(True)._replace(cov=torch.zeros(15, 15))
    config = pe.EskfConfig()
    want = kernel_cases.eskf_plain(st, gyro, acc, dts, config)
    got = kernel_cases.eskf_plain(st, gyro, acc, dts, config._replace(**WRONG_BIAS_RATES[fault]))
    assert set(kernel_cases.eskf_gaps(want, want).values()) == {0.0}
    gaps = kernel_cases.eskf_gaps(got, want)
    assert gaps["cov"] > 1.0 and max(v for k, v in gaps.items() if k != "cov") == 0.0, gaps


@pytest.mark.parametrize("wheel", [False, True], ids=["imu", "wheel"])
def test_lio_propagate_returns_what_eskf_run_returns(wheel):
    """``LioTracker._propagate`` on the CPU: the window without wheel speeds
    through ``eskf_propagate``, with them through ``eskf_run`` and its wheel
    update, each the state ``eskf_run`` gives for the window's one copy."""
    config = LioConfig()
    lio = LioTracker(config, device="cpu")
    st = start(True)
    # moving along the body's x axis, as the wheel speeds say
    lio.eskf = st._replace(v=se3.quat_rotate(st.q, torch.tensor([8.0, 0.05, 0.0])))
    gyro, acc, dts = window(10, 5)
    speeds = np.linspace(7.9, 8.3, 10, dtype=np.float32) if wheel else None
    got = lio._propagate(gyro, acc, dts, speeds)
    extra = dict(wheel_speed=torch.as_tensor(speeds), wheel_std=config.wheel_std) if wheel else {}
    want, _ = pe.eskf_run(lio.eskf, torch.as_tensor(gyro), torch.as_tensor(acc),
                          torch.as_tensor(dts), None, None, config=config.eskf, **extra)
    assert_bit_equal(got, want)
    if wheel:  # the wheel update moved the state: the window did not skip it
        plain = pe.eskf_propagate(lio.eskf, *(torch.as_tensor(x) for x in (gyro, acc, dts)),
                                  config.eskf)
        assert not torch.equal(got.v, plain.v)


def test_propagate_refuses_what_the_kernel_does_not_do():
    gyro, acc, dts = (torch.as_tensor(x) for x in window(4, 3))
    st = start(False)
    with pytest.raises(ValueError, match="wheel"):
        pe.eskf_propagate(st, gyro, acc, dts, wheel_speed=torch.full((4,), 8.0))
    with pytest.raises(ValueError, match="empty"):
        pe.eskf_propagate(st, gyro[:0], acc[:0], dts[:0])
    with pytest.raises(ValueError, match="CUDA"):
        pe.eskf_propagate_cuda(st, gyro, acc, dts)

from .eskf import (  # noqa: F401
    EskfConfig,
    EskfState,
    EskfTrajectory,
    eskf_init_state,
    eskf_predict,
    eskf_run,
    eskf_update_pose,
    eskf_update_position,
    eskf_update_wheel,
    static_initialize,
)
from .gnss import EnuFrame, lla_to_ecef, lla_to_enu, make_enu_frame  # noqa: F401
from .nmea import NmeaFix, NmeaStream, parse_nmea  # noqa: F401
from .preintegration import (  # noqa: F401
    PreintegratedImu,
    correct_bias,
    predict_pose,
    preintegrate,
)

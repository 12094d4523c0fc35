from .simulator import SimWorld, make_sim_world, simulate_scan, simulate_scan_moving  # noqa: F401
from .synthetic import make_trajectory  # noqa: F401
from .city import (  # noqa: F401
    DEFAULT_ROUTE,
    HDL64,
    HDL64_SENSOR_Z,
    make_city_course,
    make_city_imu,
    make_city_world,
    make_movers,
    world_with_movers,
)

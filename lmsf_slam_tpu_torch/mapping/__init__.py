from .occupancy import (  # noqa: F401
    OccupancyConfig,
    occupancy_from_database,
    occupancy_init,
    occupancy_probability,
    occupancy_update,
)

from .handeye import (  # noqa: F401
    HandEyeConfig,
    HandEyeResult,
    HandEyeState,
    handeye_add_pair,
    handeye_init,
    handeye_solve,
)

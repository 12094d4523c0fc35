from .handeye import HandEyeConfig  # noqa: F401

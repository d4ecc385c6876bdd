from mcmh_localization_tpu_torch.utils.angles import (
    normalize_angle,
    normalize_angle_about,
    quaternion_from_yaw,
    yaw_from_quaternion,
)

__all__ = [
    "normalize_angle",
    "normalize_angle_about",
    "yaw_from_quaternion",
    "quaternion_from_yaw",
]

from mcmh_localization_tpu_torch.utils.angles import (
    normalize_angle,
    normalize_angle_about,
)

# the JAX package's utils exports, less the quaternion helpers (not ported)
__all__ = [
    "normalize_angle",
    "normalize_angle_about",
]

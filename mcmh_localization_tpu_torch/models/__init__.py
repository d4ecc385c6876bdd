from mcmh_localization_tpu_torch.models.motion import (
    compute_motion,
    invert_delta,
    motion_density,
    sample_motion,
)
from mcmh_localization_tpu_torch.models.sensor import (
    likelihood_field_scores,
    log_likelihood_field,
    raycast,
    raycast_beam_scores,
)

__all__ = [
    "compute_motion",
    "invert_delta",
    "sample_motion",
    "motion_density",
    "log_likelihood_field",
    "likelihood_field_scores",
    "raycast",
    "raycast_beam_scores",
]

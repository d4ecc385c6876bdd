from mcmh_localization_tpu_torch.filter.estimate import PoseEstimate, estimate_pose
from mcmh_localization_tpu_torch.filter.init import init_gaussian, init_uniform
from mcmh_localization_tpu_torch.filter.mh import asymmetric_mh, symmetric_mh
from mcmh_localization_tpu_torch.filter.state import FilterState
from mcmh_localization_tpu_torch.filter.step import (
    FilterModel,
    StepInfo,
    make_model,
    make_run,
    make_step,
    state_size,
)

# the JAX package's filter exports
__all__ = [
    "FilterState",
    "symmetric_mh",
    "asymmetric_mh",
    "init_uniform",
    "init_gaussian",
    "estimate_pose",
    "PoseEstimate",
    "make_step",
    "make_run",
    "make_model",
    "FilterModel",
    "StepInfo",
    "state_size",
]

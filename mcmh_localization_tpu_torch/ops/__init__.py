from mcmh_localization_tpu_torch.ops.resampling import (
    effective_sample_size,
    kld_resample,
    multinomial_resample_indices,
    softmax_weights,
    systematic_resample_indices,
)

__all__ = [
    "softmax_weights",
    "effective_sample_size",
    "systematic_resample_indices",
    "multinomial_resample_indices",
    "kld_resample",
]

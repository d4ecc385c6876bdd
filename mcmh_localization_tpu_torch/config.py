"""Filter configuration: the JAX package's ``config.py``, one source.

``FilterConfig``, ``parse_mode``, ``MODES`` and ``FilterConfig.from_yaml``
are the JAX package's own, loaded by path (``_shared.py``).
``check_supported`` refuses the configuration values this port does not
run yet, naming the ROADMAP item that adds each.
"""

from __future__ import annotations

from mcmh_localization_tpu_torch import _shared

_src = _shared.load("config.py", "mcmh_localization_tpu_torch._config_src")

FilterConfig = _src.FilterConfig
parse_mode = _src.parse_mode
MODES = _src.MODES


def check_supported(config) -> None:
    """Raise NotImplementedError for a value outside the ported slice."""
    if config.sensor_model != "likelihood_field":
        raise NotImplementedError(
            f"sensor_model={config.sensor_model!r}: the beam model and 3-D "
            "lidar are ROADMAP items 13-14 (only 'likelihood_field' is ported)"
        )
    if config.likelihood_impl not in ("auto", "corr"):  # "auto" -> corr
        raise NotImplementedError(
            f"likelihood_impl={config.likelihood_impl!r}: the exact scorer "
            "is ROADMAP item 11 (only 'corr' is ported)"
        )
    if config.corr_window_cells and config.corr_coarse_factor:
        raise NotImplementedError(
            "the coarse out-of-window fallback (corr_coarse_factor > 0 with "
            "corr_window_cells > 0 in one program) is ROADMAP item 11; the "
            "staged runner's programs do not use it"
        )
    if config.motion_validity != "score":
        raise NotImplementedError(
            f"motion_validity={config.motion_validity!r}: the 'reject' "
            "retries are ROADMAP item 11 (only 'score' is ported)"
        )
    if not config.use_adaptive or config.adaptive_resampler != "kld":
        raise NotImplementedError(
            f"mode={config.mode!r} adaptive_resampler="
            f"{config.adaptive_resampler!r}: only the KLD-adaptive modes "
            "are ported; the non-adaptive and 'simple'/'lvr' resamplers "
            "are ROADMAP item 7"
        )

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
    """Raise NotImplementedError for a value outside the ported slices."""
    if config.sensor_model == "lidar3d":
        raise NotImplementedError(
            "sensor_model='lidar3d': 3-D lidar is ROADMAP item 14")

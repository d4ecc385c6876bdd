from mcmh_localization_tpu_torch.sim.bag import load_bag, save_bag
from mcmh_localization_tpu_torch.sim.simulator import Bag, simulate_bag
from mcmh_localization_tpu_torch.sim.trajectory import (
    SCENARIOS,
    fit_trajectory_to_map,
    l_rest_trajectory,
    second_placement,
    square_trajectory,
    static_trajectory,
    straight_line_spin_trajectory,
)

# the JAX package's sim exports
__all__ = [
    "static_trajectory",
    "straight_line_spin_trajectory",
    "square_trajectory",
    "l_rest_trajectory",
    "fit_trajectory_to_map",
    "second_placement",
    "SCENARIOS",
    "simulate_bag",
    "Bag",
    "save_bag",
    "load_bag",
]

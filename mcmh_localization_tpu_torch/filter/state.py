"""FilterState (port of ``mcmh_localization_tpu/filter/state.py``).

The same fields and layouts as the JAX pytree: particle arrays padded to a
static ``n_max`` with a ``count`` scalar (0-d int32 tensor).  ``key`` is a
``torch.Generator`` on the state's device in place of a JAX PRNG key; the
step advances it in place, so a state's generator is shared by the states
``replace`` derives from it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FilterState:
    particles: torch.Tensor       # (n_max, 3) current particle set
    prev_particles: torch.Tensor  # (n_max, 3) pre-proposal set (for MH)
    weights: torch.Tensor         # (n_max,) normalized; 0 on inactive slots
    count: torch.Tensor           # () int32 active particle count
    w_slow: torch.Tensor          # () f32 augmented-MCL slow average
    w_fast: torch.Tensor          # () f32 augmented-MCL fast average
    delta: torch.Tensor           # (3,) last odometry delta (rot1, trans, rot2)
    anchor: torch.Tensor          # (3,) window anchor pose
    anchor_streak: torch.Tensor   # () int32 debounced-migration streak
    key: torch.Generator          # random source of the step's draws

    @property
    def n_max(self) -> int:
        return self.particles.shape[0]

    @property
    def device(self) -> torch.device:
        return self.particles.device

    @property
    def active_mask(self) -> torch.Tensor:
        return torch.arange(self.n_max, device=self.device) < self.count

    def replace(self, **kw) -> "FilterState":
        return dataclasses.replace(self, **kw)


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def copy_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device in ``gen``'s present state."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def split_seed(seed: int, n: int = 2) -> list[int]:
    """``n`` independent 64-bit seeds from one integer seed (numpy's
    ``SeedSequence.spawn``): where the JAX package splits a PRNG key into
    independent streams, the port splits a seed."""
    return [int(s.generate_state(1, np.uint64)[0])
            for s in np.random.SeedSequence(int(seed)).spawn(n)]


def make_state(
    particles: torch.Tensor,
    count: int,
    key: torch.Generator,
    n_max: int,
    w_init: float | None = None,
) -> FilterState:
    """Initial state from (n, 3) particles padded to ``n_max``: uniform
    1/count weights, w_slow = w_fast = ``w_init`` (default 1/n), anchor at
    the cloud mean (circular in theta)."""
    n = particles.shape[0]
    pad = n_max - n
    if pad < 0:
        raise ValueError(f"{n} particles > n_max={n_max}")
    dev = particles.device
    particles = torch.nn.functional.pad(
        particles.to(torch.float32), (0, 0, 0, pad))
    denom = float(max(int(n), 1))
    mean_xy = particles[:n, :2].sum(dim=0) / denom
    mean_th = torch.atan2(torch.sin(particles[:n, 2]).sum(),
                          torch.cos(particles[:n, 2]).sum())
    anchor = torch.cat([mean_xy, mean_th[None]]).to(torch.float32)
    count_t = torch.tensor(count, dtype=torch.int32, device=dev)
    mask = torch.arange(n_max, device=dev) < count_t
    weights = torch.where(mask, 1.0 / max(int(count), 1), 0.0).to(torch.float32)
    if w_init is None:
        w_init = 1.0 / max(int(n), 1)
    f32 = dict(dtype=torch.float32, device=dev)
    return FilterState(
        particles=particles,
        prev_particles=particles,
        weights=weights,
        count=count_t,
        w_slow=torch.tensor(w_init, **f32),
        w_fast=torch.tensor(w_init, **f32),
        delta=torch.zeros(3, **f32),
        anchor=anchor,
        anchor_streak=torch.zeros((), dtype=torch.int32, device=dev),
        key=key,
    )

"""Per-particle Metropolis-Hastings accept/reject (port of
``mcmh_localization_tpu/filter/mh.py``).  ``u`` is the (N,) U[0, 1) draw
per particle; drawn from ``generator`` when None."""

from __future__ import annotations

from typing import Tuple

import torch

_LOG_EPS = 1e-10  # the reference's log guard (parallel_utils.py:259-262)


def _uniform(u, like: torch.Tensor, generator) -> torch.Tensor:
    if u is None:
        u = torch.rand(like.shape, generator=generator, device=like.device)
    return u


def _select(u, alpha, prev_particles, proposed_particles, weights_post,
            weights_pre):
    accept = u < alpha
    particles = torch.where(accept[:, None], proposed_particles, prev_particles)
    weights = torch.where(accept, weights_post, weights_pre)
    return particles, weights, accept


def symmetric_mh(
    prev_particles: torch.Tensor,
    proposed_particles: torch.Tensor,
    weights_post: torch.Tensor,
    weights_pre: torch.Tensor,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """alpha = min(1, w_post / w_pre) (always accept when w_pre <= 0);
    returns (particles, weights, accept)."""
    alpha = torch.where(
        weights_pre > 0,
        torch.clamp(weights_post / weights_pre, max=1.0), 1.0)
    u = _uniform(u, alpha, generator)
    return _select(u, alpha, prev_particles, proposed_particles,
                   weights_post, weights_pre)


def asymmetric_mh(
    prev_particles: torch.Tensor,
    proposed_particles: torch.Tensor,
    weights_post: torch.Tensor,
    weights_pre: torch.Tensor,
    trans_forward: torch.Tensor,
    trans_backward: torch.Tensor,
    ref_compat_guard: bool = False,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """log alpha = [log w_post + log q(x|x')] - [log w_pre + log q(x'|x)]
    (parallel_utils.py:238-276); ``ref_compat_guard`` keeps the reference's
    always-accept ``log_den > 0`` guard.  Returns (particles, weights,
    accept)."""
    log_num = torch.log(weights_post + _LOG_EPS) + torch.log(trans_backward + _LOG_EPS)
    log_den = torch.log(weights_pre + _LOG_EPS) + torch.log(trans_forward + _LOG_EPS)
    alpha = torch.clamp(torch.exp(log_num - log_den), max=1.0)
    if ref_compat_guard:
        alpha = torch.where(log_den > 0, alpha, 1.0)
    u = _uniform(u, alpha, generator)
    return _select(u, alpha, prev_particles, proposed_particles,
                   weights_post, weights_pre)

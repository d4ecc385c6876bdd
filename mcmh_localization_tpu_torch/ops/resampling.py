"""Resampling primitives (port of ``mcmh_localization_tpu/ops/resampling.py``).

Static shapes as in the JAX package: a padded (N_max, ...) set with a
``count`` scalar.  The systematic draw is cumsum -> segment bounds -> the
sorted-rank expansion (``ops/rank.py``, CUDA kernels on the card, which
take the running max of the bounds themselves).  KLD
bins are counted exactly with a stable sort; the JAX package's hash count
and its debias are TPU approximations and are not ported.

The random draws come in as arguments (``r``, the systematic offset in
[0, 1); ``noise``/``noise_tail``, standard normals for the KLD jitter) so a
test can hand in the JAX draws; each is drawn from ``generator`` when None.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mcmh_localization_tpu_torch.ops.graph import run_if
from mcmh_localization_tpu_torch.ops.rank import expand_sorted, rank_in_sorted
from mcmh_localization_tpu_torch.ops.take import take_rows_monotone
from mcmh_localization_tpu_torch.utils.f32 import cumsum, divide, scalar

# Per-sample jitter applied by KLD sampling (parallel_utils.py:552)
KLD_NOISE_STD = (0.001, 0.001, 0.02)

# Stage-1 prefix of the escalating KLD stop evaluation (see kld_resample)
_KLD_STAGE1 = 131072

# KLD_NOISE_STD on each (device, dtype) it is used on, made once: a copy
# from the host per call would wait on the card (or stop a capture)
_noise_std: dict = {}


def _kld_noise_std(device, dtype) -> torch.Tensor:
    key = (torch.device(device), dtype)
    if key not in _noise_std:
        _noise_std[key] = torch.tensor(KLD_NOISE_STD, dtype=dtype).to(device)
    return _noise_std[key]


def kld_noise_rows(max_samples: int, min_particles: int,
                   eval_window: int = 0) -> tuple[int, int]:
    """(rows of ``noise``, rows of ``noise_tail``) that ``kld_resample``
    takes: the stage-1 prefix w1 and the escalation's rest where w1 <
    max_samples applies, else one full draw and no tail."""
    if min_particles < max_samples and not (
            eval_window and eval_window < max_samples):
        w1 = max(_KLD_STAGE1, min_particles + min_particles // 4)
        if w1 < max_samples:
            return w1, max_samples - w1
    return max_samples, 0


def softmax_weights(scores: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Log-scores -> normalized weights; masked-out entries get 0."""
    if mask is not None:
        scores = torch.where(mask, scores, -torch.inf)
    w = torch.exp(scores - scores.max())
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    return w / w.sum()


def effective_sample_size(weights: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp((weights * weights).sum(), min=1e-30)


def _uniform_offset(r, device, generator) -> torch.Tensor:
    if r is None:
        r = torch.rand((), generator=generator, device=device)
    return torch.as_tensor(r, dtype=torch.float32, device=device)


def _segment_bounds(weights: torch.Tensor, num_out: int, count=None,
                    r=None) -> torch.Tensor:
    """(N,) int32 segment ends: input i covers output slots
    [bound[i-1], bound[i]).  A reassociated cumsum can dip by an ulp, and
    the bound with it; JAX takes the running max here (resampling.py:
    106-120), the port's rank kernels take it as they rank (ops/rank.py),
    so the bound stops at the clamp."""
    if count is None:
        denom = float(num_out)
    else:
        denom = torch.as_tensor(count, device=weights.device).to(torch.float32)
    c = cumsum(weights)  # one association on every run: a resume replays
    c = c / torch.clamp(c[-1], min=1e-30)
    return torch.clamp(torch.ceil(c * denom - r), 0, num_out).to(torch.int32)


def systematic_resample_indices(weights: torch.Tensor, num_out: int,
                                count=None, r=None,
                                generator: torch.Generator | None = None
                                ) -> torch.Tensor:
    """(num_out,) int32 systematic-resampling indices: positions
    (r + m) / count walk the normalized CDF; slots past ``count`` repeat
    the last active slot."""
    r = _uniform_offset(r, weights.device, generator)
    bound = _segment_bounds(weights, num_out, count, r)
    return rank_in_sorted(bound, num_out, count=count)


def systematic_resample_particles(particles: torch.Tensor,
                                  weights: torch.Tensor, num_out: int,
                                  count=None, r=None,
                                  generator: torch.Generator | None = None,
                                  impl: str = "fused") -> torch.Tensor:
    """(num_out, 3) ``particles[systematic_resample_indices(...)]``, all
    impls the same draw: "fused", the rank and take in one expansion
    (``ops/rank.py::expand_sorted``); "gather", the indices then a plain
    row gather; "mxu", the indices then the monotone take kernel
    (``ops/take.py``), as the JAX impl of that name."""
    if impl not in ("fused", "gather", "mxu"):
        raise ValueError(f"unknown impl {impl!r}")
    r = _uniform_offset(r, weights.device, generator)
    if impl == "fused":
        bound = _segment_bounds(weights, num_out, count, r)
        return expand_sorted(bound, particles, num_out, count=count)
    idx = systematic_resample_indices(weights, num_out, count=count, r=r)
    if impl == "mxu":
        return take_rows_monotone(particles, idx)
    return particles[idx.to(torch.int64)]


def multinomial_resample_indices(weights: torch.Tensor, num_out: int,
                                 u: torch.Tensor | None = None,
                                 generator: torch.Generator | None = None
                                 ) -> torch.Tensor:
    """(num_out,) int32 i.i.d. resampling: the first normalized-cumsum entry
    >= u_m for ``u`` (num_out,) uniforms (drawn from ``generator`` when
    None), clipped to the last index (JAX resampling.py:188-193)."""
    if u is None:
        u = torch.rand((num_out,), generator=generator, device=weights.device)
    c = cumsum(weights)
    c = c / torch.clamp(c[-1], min=1e-30)
    idx = torch.searchsorted(c, u.to(c.dtype), right=False)
    return idx.clamp(max=weights.shape[0] - 1).to(torch.int32)


def _kld_chi2_bound(k: torch.Tensor, epsilon: float, z: float) -> torch.Tensor:
    """Wilson-Hilferty chi^2 upper-quantile bound / (2 eps)."""
    km1 = torch.clamp(k - 1.0, min=1.0)
    t = 1.0 - 2.0 / (9.0 * km1) + torch.sqrt(2.0 / (9.0 * km1)) * z
    return km1 * (t * t * t) / (2.0 * epsilon)


def _first_occurrence_sort(bx, by, bt) -> torch.Tensor:
    """(S,) bool: True where bin (bx, by, bt)[m] does not appear earlier.
    Exact: a stable sort of one packed key groups equal bins with the
    earliest sample first (the JAX lexsort path, resampling.py:204)."""
    s = bx.shape[0]
    key = torch.zeros(s, dtype=torch.int64, device=bx.device)
    for b in (bx, by, bt):
        b = b.to(torch.int64)
        lo = b.min()
        key = key * (b.max() - lo + 1) + (b - lo)
    sk, order = torch.sort(key, stable=True)
    is_new = torch.ones(s, dtype=torch.bool, device=bx.device)
    is_new[1:] = sk[1:] != sk[:-1]
    out = torch.empty(s, dtype=torch.bool, device=bx.device)
    out[order] = is_new
    return out


def kld_resample(
    particles: torch.Tensor,
    weights: torch.Tensor,
    max_samples: int,
    min_particles: int,
    bin_size_xy: float,
    bin_size_theta: float,
    epsilon: float,
    z: float,
    count=None,
    eval_window: int = 0,
    stop_rule: str = "every_sample",
    r=None,
    noise: torch.Tensor | None = None,
    noise_tail: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """KLD-adaptive resampling (Fox 2003) with static shapes; see the JAX
    docstring (resampling.py:299-363) for the stop rules and the escalating
    evaluation, which this follows draw for draw.

    Returns (samples (max_samples, 3), n_kept 0-d int tensor); rows at or
    past n_kept are drawn but discarded (mask them).

    ``noise``: jitter normals for the first draw, (w1, 3) when the stage-1
    prefix applies (w1 = max(131072, 1.25 * min_particles) < max_samples)
    else (max_samples, 3); ``noise_tail``: (max_samples - w1, 3) for the
    escalation (``kld_noise_rows``), drawn inside the escalation when None.
    The escalation's gate is ``ops/graph.py::run_if`` in place of the JAX
    ``while_loop``: a conditional node in a captured step (whose draws are
    all given, ``filter/step.py::_resample_draws``), a host ``if`` on the
    stage-1 result otherwise."""
    if stop_rule not in ("every_sample", "new_bin"):
        raise ValueError(f"unknown stop_rule {stop_rule!r}")
    dev = particles.device
    r = _uniform_offset(r, dev, generator)
    noise_std = _kld_noise_std(dev, particles.dtype)
    stride = count if count is not None else max_samples
    # one bound serves every draw: for slot values v < num_out <=
    # max_samples, min(b, num_out) <= v exactly when b <= v, so the
    # bound at max_samples ranks like the bound at num_out
    bound = _segment_bounds(weights, max_samples, stride, r)

    def normals(rows, given):
        if given is None:
            given = torch.randn((rows, 3), generator=generator, device=dev,
                                dtype=particles.dtype)
        return given

    def draw(num_out, nz):
        d = expand_sorted(bound, particles, num_out, count=stride)
        return d + normals(num_out, nz) * noise_std

    def first_stop(sub):
        bx = divide(sub[:, 0], bin_size_xy).to(torch.int32)
        by = divide(sub[:, 1], bin_size_xy).to(torch.int32)
        bt = divide(sub[:, 2], bin_size_theta).to(torch.int32)
        new_bin = _first_occurrence_sort(bx, by, bt)
        k_bins = torch.cumsum(new_bin, dim=0)
        m = torch.arange(sub.shape[0], device=dev)
        required = _kld_chi2_bound(k_bins.to(torch.float32), epsilon, z)
        stop_here = (k_bins > 1) & (m >= min_particles) & (m > required)
        if stop_rule == "new_bin":
            stop_here = new_bin & stop_here
        return stop_here.any(), torch.argmax(stop_here.to(torch.uint8))

    def kept(any_stop, first):
        return torch.where(any_stop, first, max_samples).to(torch.int32)

    rows, tail_rows = kld_noise_rows(max_samples, min_particles, eval_window)
    if min_particles >= max_samples:
        # the caller clamps the count to [min, max]: the stop rule is dead
        return draw(max_samples, noise), scalar(max_samples, dev, torch.int32)

    if eval_window and eval_window < max_samples:
        samples = draw(max_samples, noise)
        return samples, kept(*first_stop(samples[:eval_window]))

    if tail_rows:
        w1 = rows
        samples1 = draw(w1, noise)  # == rows [0, w1) of the full sequence
        a1, f1 = first_stop(samples1)
        pad = torch.zeros((tail_rows, 3), dtype=samples1.dtype, device=dev)

        def escalate():
            drawn = expand_sorted(bound, particles, max_samples, count=stride)
            tail = normals(tail_rows, noise_tail) * noise_std
            samples = torch.cat([samples1, drawn[w1:] + tail])
            return samples, kept(*first_stop(samples))

        return tuple(run_if(~a1, escalate,
                            [torch.cat([samples1, pad]), f1.to(torch.int32)],
                            donate=True))

    samples = draw(max_samples, noise)
    return samples, kept(*first_stop(samples))

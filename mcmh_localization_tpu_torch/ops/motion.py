"""One odometry message's motion step: the delta, its noise scales, the
proposal (under motion_validity="reject" the first of ``motion_retries``
candidates on a free cell, else the old pose) and the anchor's advance;
in place on a state's buffers, also the previous set.

Two forms.  ``predict`` is ``filter/step.py::_predict``'s: a new proposal
and anchor from a given (3,) delta, the set kept as ``prev_particles``
uncopied by the caller.  ``predict_in_place`` is what each odometry graph
of ``filter/captured.py`` holds: the message from its (2, 3) poses on the
correct step's buffers, which it writes in place (``prev_particles`` <-
``particles`` <- the proposal, ``delta``, ``anchor``).

On the card a message is torch's draw (``torch.randn`` from the state's
generator, as the plain chain draws: the same shape at the same place in
the stream) and one launch of ``csrc/motion.cu``, where PyTorch took 59
launches and 4 copies (83 and 4 under "reject" with 4 retries).  The JAX
package leaves the motion model to XLA
(``mcmh_localization_tpu/models/motion.py``); no Pallas kernel is
replaced.  The plain version is the PyTorch chain itself
(``models/motion.py::compute_motion``, ``sample_motion`` and
``advance_anchor``), which CPU tensors take; the kernel does each slot's
arithmetic operation by operation as it does, so on the card the two are
bitwise equal.
"""

from __future__ import annotations

import torch

from mcmh_localization_tpu_torch.models.motion import (
    advance_anchor,
    compute_motion,
    sample_motion,
)
from mcmh_localization_tpu_torch.ops import _cuda


def retries(config) -> int:
    """R, the candidates a slot draws: 0 (the raw draw) under
    motion_validity="score", ``motion_retries`` under "reject"."""
    return 0 if config.motion_validity == "score" else config.motion_retries


def draw_noise(state, config) -> torch.Tensor:
    """The message's standard normals from ``state.key``: (n_max, 3), or
    (R, n_max, 3) under "reject"."""
    p = state.particles
    r = retries(config)
    shape = (p.shape[0], 3) if r == 0 else (r, p.shape[0], 3)
    return torch.randn(shape, generator=state.key, device=p.device,
                       dtype=p.dtype)


def predict_plain(state, delta, config, grid_map=None, noise=None):
    """``predict`` in PyTorch: ``sample_motion`` on ``state.particles``
    with ``noise`` (drawn from ``state.key`` when None), the anchor
    advanced by the (3,) ``delta``."""
    if noise is None:
        noise = draw_noise(state, config)
    proposed = sample_motion(state.particles, delta, config.alpha, noise=noise,
                             grid_map=grid_map, retries=retries(config))
    return proposed, advance_anchor(state.anchor, delta)


def predict_in_place_plain(state, poses, config, grid_map=None,
                           noise=None) -> None:
    """``predict_in_place`` in PyTorch: ``compute_motion`` of the poses,
    ``predict_plain`` on it, the results copied into ``state``'s tensors
    (the set into ``prev_particles`` before it is overwritten)."""
    delta = compute_motion(poses[0], poses[1])
    proposed, anchor = predict_plain(state, delta, config, grid_map, noise)
    state.prev_particles.copy_(state.particles)
    state.particles.copy_(proposed)
    state.delta.copy_(delta)
    state.anchor.copy_(anchor)


def predict(state, delta, config, grid_map=None, noise=None):
    """(proposal, anchor) of one message from ``state`` (its particles,
    anchor and generator ``key``) and the (3,) f32 ``delta``; ``noise`` as
    ``draw_noise`` gives it (drawn there when None).  CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if state.particles.device.type == "cpu":
        return predict_plain(state, delta, config, grid_map, noise)
    drawn = noise is None
    if drawn:
        noise = draw_noise(state, config)
    # the raw draw's proposal goes over the normals drawn here (each thread
    # reads its rows before it writes them): one (n_max, 3) tensor a
    # message, not two
    proposed = (noise if drawn and retries(config) == 0
                else torch.empty_like(state.particles))
    anchor = torch.empty_like(state.anchor)
    _launch(state.particles, noise, state.anchor, config, grid_map,
            proposed=proposed, anchor_out=anchor, delta=delta)
    return proposed, anchor


def predict_in_place(state, poses, config, grid_map=None, noise=None) -> None:
    """One message from the (2, 3) ``poses`` (previous, current) on
    ``state``'s tensors, in place: ``prev_particles`` takes the set,
    ``particles`` the proposal, ``delta`` compute_motion's and ``anchor``
    the advanced one.  ``noise`` as in ``predict``."""
    if state.particles.device.type == "cpu":
        predict_in_place_plain(state, poses, config, grid_map, noise)
        return
    if noise is None:
        noise = draw_noise(state, config)
    _launch(state.particles, noise, state.anchor, config, grid_map,
            proposed=state.particles, anchor_out=state.anchor, poses=poses,
            prev_out=state.prev_particles, delta_out=state.delta)


def _launch(particles, noise, anchor, config, grid_map, *, proposed,
            anchor_out, delta=None, poses=None, prev_out=None,
            delta_out=None) -> None:
    """``csrc/motion.cu`` on the card: the delta from ``poses`` where they
    are given, else ``delta``.  Raises where a tensor is not on the card or
    does not have the shape and type the kernel takes."""
    r = retries(config)
    n = particles.shape[0]
    src = poses if poses is not None else delta
    outs = [t for t in (proposed, anchor_out, prev_out, delta_out)
            if t is not None]
    _cuda.require_cuda("motion", particles, noise, anchor, src, *outs)
    if any(t.dtype != torch.float32
           for t in (particles, noise, anchor, src, *outs)):
        raise ValueError("motion: every tensor must be float32")
    if particles.shape != (n, 3) or any(
            t.shape != (n, 3) for t in (proposed, prev_out) if t is not None):
        raise ValueError("motion: the sets must be (n_max, 3)")
    if noise.shape != ((n, 3) if r == 0 else (r, n, 3)):
        raise ValueError(f"motion: noise has shape {tuple(noise.shape)} for "
                         f"n_max={n} and {r} retries")
    if src.shape != ((2, 3) if poses is not None else (3,)) or any(
            t.shape != (3,) for t in (anchor, anchor_out, delta_out)
            if t is not None):
        raise ValueError("motion: poses must be (2, 3); delta and anchor (3,)")
    free = None
    h = w = 0
    if r:
        free = grid_map.free_mask
        _cuda.require_cuda("motion", free)
        if free.dtype != torch.float32 or free.dim() != 2:
            raise ValueError("motion: the free mask must be 2-D float32")
        h, w = free.shape
    res = grid_map.res if grid_map is not None else 1.0
    ox, oy = grid_map.origin_xy if grid_map is not None else (0.0, 0.0)
    a1, a2, a3, a4 = config.alpha
    args = _cuda.MotionArgs(
        *map(_ptr, (noise, particles, poses, delta, anchor, free, proposed,
                    prev_out, delta_out, anchor_out)),
        n, r, h, w, a1, a2, a3, a4, ox, oy, res)
    _cuda.check_launch("motion", _cuda.library().mcmh_motion(
        args, _cuda.stream_of(particles)))


def _ptr(t):
    return None if t is None else t.data_ptr()

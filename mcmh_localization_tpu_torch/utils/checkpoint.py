"""FilterState checkpoint/resume (port of
``mcmh_localization_tpu/utils/checkpoint.py``).

The same npz fields as the JAX package, with its fallbacks for checkpoints
that predate the window anchor and its streak.  The random source is a
``torch.Generator`` here, so its state goes under a name of its own,
``torch_generator_state``, beside ``torch_generator_device`` (the device
type the state belongs to: a CPU generator's state does not load into a
CUDA one); the file has no ``key``, so the JAX package cannot load it.

A checkpoint the JAX package saved loads here with every field but the key
bitwise equal.  Its key cannot carry across (the two packages' streams
differ), so the generator is seeded from the key's words by one fixed rule
(``seed_from_jax_key``): the same file always resumes the same stream.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mcmh_localization_tpu_torch.convert import STATE_FIELDS, state_from_numpy
from mcmh_localization_tpu_torch.filter.state import FilterState, make_generator
from mcmh_localization_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
)


def save_state(path: str, state: FilterState) -> None:
    arrays = {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}
    arrays["torch_generator_state"] = state.key.get_state().numpy()
    arrays["torch_generator_device"] = np.array(state.key.device.type)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **arrays)


def seed_from_jax_key(key_data) -> int:
    """The generator seed of a JAX checkpoint: its key's uint32 words read
    as one big-endian integer, modulo 2**64 (a default threefry key's two
    words are ``key[0] << 32 | key[1]``)."""
    seed = 0
    for word in np.asarray(key_data, dtype=np.uint32).reshape(-1):
        seed = ((seed << 32) | int(word)) % (1 << 64)
    return seed


def _generator(z, device: torch.device) -> torch.Generator:
    if "torch_generator_state" not in z:
        return make_generator(seed_from_jax_key(z["key"]), device)
    saved_on = str(z["torch_generator_device"])
    if saved_on != device.type:
        raise ValueError(
            f"the checkpoint's generator state is a {saved_on} generator's; "
            f"it does not load into a {device.type} generator")
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(z["torch_generator_state"]))
    return gen


def load_state(path: str, device=DEFAULT_DEVICE) -> FilterState:
    """The state saved at ``path`` on ``device`` (the card unless named),
    its generator on the same device."""
    dev = resolve_device(device)
    with np.load(path) as z:
        arrays = {f: z[f] for f in STATE_FIELDS if f in z}
        # pre-round-4 checkpoints have no anchor; the weighted-mean
        # fallback matches make_state's fresh-state initialization
        if "anchor" not in arrays:
            arrays["anchor"] = np.asarray(
                np.average(z["particles"], axis=0,
                           weights=np.maximum(z["weights"], 0.0) + 1e-30),
                dtype=np.float32)
        # pre-round-5 checkpoints have no streak; 0 = no pending
        # different-mode challenge, matching make_state
        if "anchor_streak" not in arrays:
            arrays["anchor_streak"] = np.zeros((), dtype=np.int32)
        return state_from_numpy(arrays, device=dev,
                                generator=_generator(z, dev))

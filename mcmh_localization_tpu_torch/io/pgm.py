"""PGM image + ROS map YAML loading: the port's own copy of the JAX
package's numpy-only ``io/pgm.py`` (the tests read back through one
package what the other wrote).

Replaces the ROS ``map_server`` + ``/map`` topic path the reference relies on
(``amcmh_localizer.py:124-136`` waits for an OccupancyGrid published by
map_server from ``app/maps/map_house.{pgm,yaml}``).  We read the same on-disk
format directly and reproduce map_server's trinary conversion so a reference
user's map assets work unchanged.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np


def read_pgm(path: str) -> np.ndarray:
    """Read a P5 (binary) or P2 (ascii) PGM into a (H, W) uint8/uint16 array."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: magic, width, height, maxval — whitespace/comment separated.
    tokens = []
    pos = 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[pos:])
        if m is None:
            raise ValueError(f"Malformed PGM header in {path}")
        tok = m.group(1)
        pos += m.end()
        if not tok.startswith(b"#"):
            tokens.append(tok)
    magic = tokens[0]
    width, height, maxval = (int(t) for t in tokens[1:4])
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")

    if magic == b"P5":
        # Exactly one whitespace byte follows maxval before binary raster.
        raster = np.frombuffer(data, dtype=dtype, count=width * height, offset=pos + 1)
    elif magic == b"P2":
        raster = np.array(data[pos:].split()[: width * height], dtype=int).astype(dtype)
    else:
        raise ValueError(f"Unsupported PGM magic {magic!r} in {path}")
    return raster.reshape(height, width)


def write_pgm(path: str, img: np.ndarray, maxval: int = 255) -> None:
    """Write a (H, W) uint8 array as binary P5 PGM."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n{maxval}\n".encode())
        f.write(img.tobytes())


def load_map_yaml(yaml_path: str) -> Tuple[np.ndarray, dict]:
    """Load a ROS map YAML + its PGM; return (trinary occupancy, metadata).

    Occupancy values follow ROS OccupancyGrid semantics (what map_server
    publishes and the reference consumes at amcmh_localizer.py:136):
      0 = free, 100 = occupied, -1 = unknown, as int8, shape (H, W) with
      row 0 = the map's bottom row (origin corner) — i.e. the PGM image is
      vertically flipped, matching map_server.

    Metadata keys: resolution (m/cell), origin (x, y, yaw),
    occupied_thresh, free_thresh, negate.
    Map YAML format: app/maps/map_house.yaml:1-6.
    """
    meta_raw: dict = {}
    base = os.path.dirname(os.path.abspath(yaml_path))
    with open(yaml_path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, _, val = line.partition(":")
            meta_raw[key.strip()] = val.strip()

    image = meta_raw["image"]
    if not os.path.isabs(image):
        image = os.path.normpath(os.path.join(base, image))
    resolution = float(meta_raw["resolution"])
    origin = tuple(
        float(v) for v in meta_raw.get("origin", "[0,0,0]").strip("[]").split(",")
    )
    negate = int(meta_raw.get("negate", 0))
    occupied_thresh = float(meta_raw.get("occupied_thresh", 0.65))
    free_thresh = float(meta_raw.get("free_thresh", 0.196))

    raster = read_pgm(image)
    # capture the dtype BEFORE the float cast: after astype(float64) the >u2
    # check is always false and 16-bit PGMs would be normalized by 255
    maxval = 65535.0 if raster.dtype == np.dtype(">u2") else 255.0
    img = raster.astype(np.float64)
    # map_server trinary conversion (map_server/src/map_server.cpp semantics)
    p = img / maxval if negate else (maxval - img) / maxval
    occ = np.full(img.shape, -1, dtype=np.int8)
    occ[p > occupied_thresh] = 100
    occ[p < free_thresh] = 0
    # PGM row 0 is the TOP of the image; OccupancyGrid row 0 is the BOTTOM
    # (origin corner) — map_server flips vertically when publishing.
    occ = occ[::-1].copy()

    meta = {
        "resolution": resolution,
        "origin": origin,
        "negate": negate,
        "occupied_thresh": occupied_thresh,
        "free_thresh": free_thresh,
        "image": image,
    }
    return occ, meta

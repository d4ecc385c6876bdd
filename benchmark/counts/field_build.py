"""The correlation field build's work: ``F[k, y, x] = sum_j
padded[y + oy[k, j], x + ox[k, j]]`` over the valid beams j of K theta bins
on an (H, W) field read from a padded (Hp, Wp) float32 table.

One add per output cell and valid beam.  Bytes: the table read once, the
(K, M) int32 offsets ``ox`` and ``oy`` read once, the (K, H, W) float32
field written once (each input read once and each output written once,
whatever the kernel reads again)."""


def ops(k: int, h: int, w: int, valid_beams: int) -> float:
    return float(k) * h * w * valid_beams


def nbytes(k: int, h: int, w: int, beams: int, hp: int, wp: int) -> float:
    return 4.0 * (hp * wp + 2 * k * beams + k * h * w)

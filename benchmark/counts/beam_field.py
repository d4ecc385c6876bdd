"""The beam score field's builds of one scan: the fine field ``F[b, y, x] =
sum_j L[j, qt[g_j(b), y, x]]`` over the window's ``win`` x ``win`` cells
and ``nbins`` theta bins, and the coarse field ``C[c, y, x] = sum_j L'[j,
qtc[g_j(c), y, x]]`` over the ``hc`` x ``wc`` block centres and ``kc``
bins; ``L`` is the scan's (M, nq) float32 LUT (each beam's term at each
range level), ``L'`` its optimistic form (each level's term the largest at
it and the levels beside it), ``qt`` the (K, H, W) int8 level table and
``qtc`` its block centres.

Operations: one add per output cell and valid beam in each field, and two
maxes per valid beam and level for ``L'``.  Bytes: the LUT and the beams'
angles read once, the (K, win, win) window of ``qt`` and the (K, hc, wc)
block centres read once (a byte a level), both float32 fields written
once (each input read once and each output written once, whatever a
kernel reads again or keeps between the builds: the bin-LUT matrices that
the program's kernels pass between them are not counted)."""


def ops(nbins: int, win: int, kc: int, hc: int, wc: int, valid_beams: int,
        nq: int) -> float:
    return float(valid_beams) * (nbins * win * win + kc * hc * wc + 2 * nq)


def nbytes(k: int, nbins: int, win: int, kc: int, hc: int, wc: int,
           beams: int, nq: int) -> float:
    return (4.0 * beams * (nq + 1) + k * (win * win + hc * wc)
            + 4.0 * (nbins * win * win + kc * hc * wc))

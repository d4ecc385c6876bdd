"""The 3-D lidar scorer's work on one scan: for each of N planar poses and
each live beam (valid, its endpoint's plane inside the volume) the
endpoint ``(x + c u - s v, y + s u + c v)``, its voxel, the bounds checks,
one read of the per-voxel log mixture and its add to the pose's sum; for
each pose its heading's cosine and sine and the mean's divide; for each
of the scan's M beams its sensor-frame endpoint and plane.

Operations: 13 a (pose, live beam) pair (two rotations of two multiplies
and an add each, two subtracts of the origin, two scalings and two floors,
the add; the bounds checks and the index as integer work, as kernel 6's
count takes them), 3 a pose and 20 a beam (the cosines and sines of its
angles, five multiplies, the plane's add, scale and floor, the validity).
Bytes: the (N, 3) float32 poses and the scan's ranges, azimuths and
elevations read once, the (N,) float32 scores written once, and the
(D, H, W) float32 log-mixture volume read once, or one value a read where
the reads touch less of it (a gather's table counted as the values it
reads).  Each input is read once and each output written once whatever
form a kernel reads: the program's 16-bit level index and its levels are
not counted, so at ``chip_smoke.py``'s form (b) shape (2 x 100k poses,
5006 live of 5760 beams, the 400 x 400 x 60 building) the bytes differ
from that row's count, while the bound, set by the operations, is the
same 0.1943 ms."""


def ops(poses: int, live_beams: int, beams: int) -> float:
    return 13.0 * poses * live_beams + 3.0 * poses + 20.0 * beams


def nbytes(poses: int, live_beams: int, beams: int, voxels: int) -> float:
    return (12.0 * poses + 12.0 * beams + 4.0 * poses
            + 4.0 * min(voxels, poses * live_beams))

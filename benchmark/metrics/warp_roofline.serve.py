"""The pooled crop's and the warp's share of their memory bound: the bytes
the batch's geometry needs (``counts.crop_pool_bytes`` + ``warp_bytes``, the
geometry as the reference places the faces) at 3.35 TB/s, over the two
kernels' own device time a batch in the profiled slice. Moves
``faces_per_s``."""

from benchmark.peaks import HBM_BYTES

KERNELS = ("crop_pool_band_kernel", "warp_tile_kernel")


def read(sl, ctx):
    ms = sl.kernel_ms(*KERNELS) / sl.steps
    nbytes = ctx.get("warp_bytes_per_step")
    if ms <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES / (ms * 1e-3)

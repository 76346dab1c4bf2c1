"""Synthetic frames rendered on host threads, bit-equal to a sequential
render.

``utils/synthetic``'s ray casters are numpy array work, which releases the
GIL, so a pool of threads renders a sequence several times faster than a
loop.  Each call's noise is drawn here, from the caller's generator and in
the sequential order, and handed to the call in place of the generator:
the frames and the generator's state afterwards are the loop's.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

RENDER_THREADS = 8
BATCH = 64            # frames whose noise is drawn ahead at a time


class _DrawnNoise:
    """Stands in for the generator inside one render call: hands back, in
    order, the noise arrays drawn for that call from the real generator."""

    def __init__(self, arrays):
        self._arrays = list(arrays)

    def normal(self, loc, scale, size):
        return self._arrays.pop(0)


def render_frames(render, world, cam, poses, rng, images=2, **kw):
    """``[render(world, cam, T, rng, 1.0, **kw) for T in poses]`` on
    RENDER_THREADS threads.  ``images`` is the number of noise arrays one
    call draws (2 for a stereo pair); they are drawn BATCH frames ahead,
    so a long sequence holds no more than that many frames' noise."""
    shape = (cam.height, cam.width)
    out = []
    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        for b0 in range(0, len(poses), BATCH):
            batch = poses[b0:b0 + BATCH]
            draws = [[rng.normal(0.0, 1.0, shape) for _ in range(images)]
                     for _ in batch]
            out.extend(pool.map(
                lambda a: render(world, cam, a[0], _DrawnNoise(a[1]), 1.0,
                                 **kw),
                zip(batch, draws)))
    return out

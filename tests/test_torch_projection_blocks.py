"""``matching.search_by_projection`` over blocks of query points.

The [P, N] gates and Hamming distances run over blocks of
``matching.PROJECTION_BLOCK`` points.  Here the blocked pass is held bit
for bit (index, distance, projected uv, and the matches left by
``resolve_duplicates``) against one pass over all P points, at P = three
blocks and a remainder against N = 1024 keypoints, with ``check_ur`` on
and off.  The points, made from a seed, are copies of keypoints seen
through the camera with a few descriptor bits flipped, and include a
block whose points are all invalid, one whose points lie behind the
camera, ties at the best distance between two keypoints of one row, and
one point repeated on both sides of a block boundary.
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.ops import hamming, matching
from orbslam2_tpu_torch.utils import camera as tcam

torch.set_num_threads(2)

N_KP = 1024
B = matching.PROJECTION_BLOCK
P = 3 * B + 1000


def _cam():
    return tcam.Camera.from_config(tconfig.CameraConfig(
        fx=225.0, fy=225.0, cx=160.0, cy=120.0, bf=120.0, width=320,
        height=240, fps=10.0, th_depth=35.0))


def _case(seed=0):
    rng = np.random.default_rng(seed)
    kp_xy = np.stack([rng.uniform(0, 320, N_KP), rng.uniform(0, 240, N_KP)],
                     -1).astype(np.float32)
    kp_level = rng.integers(0, 8, N_KP).astype(np.int32)
    kp_desc = rng.integers(-2 ** 31, 2 ** 31, (N_KP, 8)).astype(np.int32)
    kp_valid = rng.random(N_KP) < 0.95
    kp_ur = np.where(rng.random(N_KP) < 0.8,
                     kp_xy[:, 0] - rng.uniform(2, 30, N_KP), -1.0
                     ).astype(np.float32)
    # ties: keypoint 2i+1 (i < 32) repeats keypoint 2i
    tie = np.arange(0, 64, 2)
    kp_valid[tie] = True
    for a in (kp_xy, kp_level, kp_desc, kp_valid, kp_ur):
        a[tie + 1] = a[tie]

    # each point: a keypoint seen at a depth, its descriptor with a few
    # bits flipped, its level's distance band around that depth
    src = rng.integers(0, N_KP, P)
    src[: 4 * len(tie)] = np.repeat(tie, 4)
    z = rng.uniform(2.0, 30.0, P).astype(np.float32)
    uv = kp_xy[src] + rng.normal(0, 1.5, (P, 2)).astype(np.float32)
    pos = np.stack([(uv[:, 0] - 160.0) / 225.0 * z,
                    (uv[:, 1] - 120.0) / 225.0 * z, z], -1)
    desc = kp_desc[src].copy()
    flips = rng.integers(0, 256, (P, 6))
    for f in range(flips.shape[1]):
        keep = rng.random(P) < 0.7
        w, b = flips[:, f] // 32, flips[:, f] % 32
        bit = np.left_shift(np.ones(P, np.int64), b).astype(np.uint32)
        rows = np.arange(P)[keep]
        desc.view(np.uint32)[rows, w[keep]] ^= bit[keep]
    scale = 1.2 ** kp_level[src]
    dist = np.linalg.norm(pos, axis=-1)
    max_dist = (dist * scale / 1.1).astype(np.float32)
    min_dist = (max_dist / 1.2 ** 7).astype(np.float32)
    normal = (pos / dist[:, None]).astype(np.float32)
    valid = rng.random(P) < 0.9
    # a block all invalid, a block behind the camera
    valid[2 * B:3 * B] = False
    pos[B:2 * B, 2] *= -1.0
    # one point on both sides of the first block boundary
    for a in ("pos", "desc", "max_dist", "min_dist", "normal"):
        arr = locals()[a]
        arr[B] = arr[B - 1]
    valid[B - 1] = valid[B] = True
    pos[B - 1:B + 1, 2] = np.abs(pos[B - 1:B + 1, 2])
    t = torch.from_numpy
    q = matching.ProjectionQuery(
        pos_w=t(pos.astype(np.float32)), normal=t(normal),
        min_dist=t(min_dist), max_dist=t(max_dist), desc=t(desc),
        valid=t(valid))
    kp = (t(kp_xy), t(kp_level), t(kp_desc), t(kp_valid), t(kp_ur))
    return q, kp


@pytest.mark.parametrize("check_ur,nn_ratio", [(False, 2.0), (True, 0.9)],
                         ids=["ur-off-recount-ratio", "ur-on-tracking-ratio"])
def test_blocked_search_equals_one_pass(check_ur, nn_ratio, monkeypatch):
    cam = _cam()
    Tcw = torch.eye(4)
    q, kp = _case()
    shapes = []
    hm = hamming.hamming_matrix

    def spy(a, b):
        shapes.append((a.shape[0], b.shape[0]))
        return hm(a, b)

    monkeypatch.setattr(hamming, "hamming_matrix", spy)

    def run():
        return matching.search_by_projection(
            cam, Tcw, q, *kp, 1.2, 8, radius=10.0, nn_ratio=nn_ratio,
            check_ur=check_ur)

    blocked = run()
    assert shapes == [(B, N_KP)] * 3 + [(P - 3 * B, N_KP)]
    monkeypatch.setattr(matching, "PROJECTION_BLOCK", P)
    one = run()
    assert shapes[4:] == [(P, N_KP)]
    for a, b in zip(blocked, one):
        assert a.dtype == b.dtype and torch.equal(a, b)
    m, d, _ = blocked
    assert torch.equal(matching.resolve_duplicates(m, d, N_KP),
                       matching.resolve_duplicates(one[0], one[1], N_KP))
    # the case is not vacuous: matches in the blocks that gate anything,
    # none in the invalid block or behind the camera, the repeated point
    # matched alike on both sides of the boundary, and ties broken to the
    # first keypoint (ratio 2.0) or left unmatched (0.9)
    ok = (m >= 0).numpy()
    assert ok[:B].sum() > 1000 and ok[3 * B:].sum() > 100
    assert not ok[B + 1:3 * B].any()
    assert ok[B - 1] and m[B - 1] == m[B] and d[B - 1] == d[B]
    pair = torch.from_numpy(np.repeat(np.arange(0, 64, 2), 4))   # rows 0-127
    to_pair = (m[:128] == pair) | (m[:128] == pair + 1)
    if nn_ratio > 1.0:
        assert int(to_pair.sum()) > 10
        assert torch.equal(m[:128][to_pair], pair[to_pair])
    else:
        assert not bool(to_pair.any())

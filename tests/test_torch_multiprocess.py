"""Two processes × two CPU shards over one Gloo group: the port of
tests/test_multiprocess.py with tests/mp_ba_worker.py.

This file is also the worker: ``python tests/test_torch_multiprocess.py
<rank> <world> <store file>`` joins a ``torch.distributed`` Gloo group
set up through a ``FileStore`` (no port to race for), makes
``make_mesh(["cpu"] * 2, group=WORLD)`` (global shards rank·2 + i of 4),
and, with ``import jax`` made to fail first, runs
``distributed_bundle_adjust`` on tests/test_bundle.py's problem of 200
points built from the same seed (a numpy copy of ``_make_ba_problem``),
then queries a keyframe DB sharded over the group.  It prints one JSON
line.  Both ranks must print the same poses (the group's sum is one
all-reduce) within the JAX worker's bars of the truth
(tests/mp_ba_worker.py:42-43: translation < 0.02, rotation < 0.1°), and
scores within 1e-6 of the dense product.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CHILD_TIMEOUT_S = 300


def _problem(rng, n_free=6, n_fixed=2, n_pts=200, noise_px=0.4,
             pose_pert=0.02, pt_pert=0.05, outlier_frac=0.05):
    """tests/test_bundle.py's ``_make_ba_problem`` (stereo), on numpy and
    the port: the same draws from ``rng``."""
    import torch
    from orbslam2_tpu_torch.ops import bundle
    from orbslam2_tpu_torch.utils import lie, synthetic
    fx, fy, cx, cy, bf = 450.0, 450.0, 320.0, 240.0, 150.0
    n_cams = n_free + n_fixed
    poses_true = [synthetic.look_ahead_pose(np.array([0.3 * i, 0.0, 0.4 * i]))
                  for i in range(n_cams)]
    pts_true = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-4, 4, n_pts),
                         rng.uniform(6, 25, n_pts)], -1)
    cam_i, pt_i, uvs, urs = [], [], [], []
    for ci, T in enumerate(poses_true):
        pc = pts_true @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        vis = (z > 0.5) & (u > 10) & (u < 630) & (v > 10) & (v < 470)
        for pi in np.where(vis)[0]:
            cam_i.append(ci)
            pt_i.append(pi)
            uu = u[pi] + rng.normal(0, noise_px)
            vv = v[pi] + rng.normal(0, noise_px)
            uvs.append((uu, vv))
            urs.append(uu - bf / z[pi] + rng.normal(0, noise_px))
    O = len(cam_i)
    uvs = np.asarray(uvs, np.float32)
    urs = np.asarray(urs, np.float32)
    n_out = int(O * outlier_frac)
    out_idx = rng.choice(O, n_out, replace=False)
    uvs[out_idx] += rng.uniform(10, 40, (n_out, 2))
    poses0 = np.stack(poses_true).astype(np.float32)
    for i in range(n_free):
        xi = np.concatenate([rng.normal(0, pose_pert, 3),
                             rng.normal(0, pose_pert * 5, 3)]).astype(
                                 np.float32)
        poses0[i] = lie.se3_exp(torch.from_numpy(xi)).numpy() @ poses0[i]
    pts0 = pts_true + rng.normal(0, pt_pert, pts_true.shape)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype))

    prob = bundle.BAProblem(
        poses=t(poses0, np.float32), points=t(pts0, np.float32),
        point_valid=t(np.ones(n_pts, bool), bool),
        cam_i=t(cam_i, np.int64), pt_i=t(pt_i, np.int64),
        uv=t(uvs, np.float32), ur=t(urs, np.float32),
        inv_sigma2=t(np.ones(O), np.float32), valid=t(np.ones(O), bool))
    return prob, np.stack(poses_true)


def _worker(rank: int, world: int, store: str) -> None:
    sys.modules["jax"] = None                  # any `import jax` now raises
    try:
        import jax  # noqa: F401
        raise AssertionError("jax imported in the worker")
    except ImportError:
        pass
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from orbslam2_tpu_torch.config import CameraConfig
    from orbslam2_tpu_torch.models.keyframe_db import KeyFrameDB
    from orbslam2_tpu_torch.parallel import db_shard, dist_ba
    from orbslam2_tpu_torch.parallel.mesh import make_mesh
    from orbslam2_tpu_torch.utils import camera as cam_mod

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(["cpu"] * 2, group=dist.group.WORLD)
        assert mesh.size == 2 * world and mesh.shard_index(1) == 2 * rank + 1
        prob, poses_true = _problem(np.random.default_rng(0))
        cam = cam_mod.Camera.from_config(CameraConfig(
            fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0, width=640,
            height=480))
        poses, points, inlier = dist_ba.distributed_bundle_adjust(
            mesh, cam, prob, n_free=6, solver="cg")
        rng = np.random.default_rng(1)              # the same on each rank
        bow = rng.random((20, 64)).astype(np.float32)
        bow /= np.linalg.norm(bow, axis=1, keepdims=True)   # as BoW rows
        q = rng.random(64).astype(np.float32)
        q /= np.linalg.norm(q)
        db = db_shard.shard_db(mesh, KeyFrameDB(
            bow=torch.from_numpy(bow), valid=torch.ones(20, dtype=torch.bool)))
        scores = db.scores(torch.from_numpy(q))
        print(json.dumps({
            "rank": rank,
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] == "orbslam2_tpu"
                             or (m.split(".")[0] == "jax"
                                 and sys.modules[m] is not None)),
            "poses": poses.numpy().tolist(),
            "poses_true": poses_true.tolist(),
            "n_points": int(points.shape[0]),
            "inliers": float(inlier.float().mean()),
            "rows": int(db.blocks[0].bow.shape[0]),
            "scores": scores.numpy().tolist(),
            "want": (bow @ q).tolist()}), flush=True)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         store], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        env=env, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def test_two_process_distributed_ba(ranks):
    from test_bundle import _pose_errors
    a, b = ranks
    assert (a["rank"], b["rank"]) == (0, 1)
    assert a["loaded"] == b["loaded"] == []    # nothing of jax loaded
    assert a["poses"] == b["poses"]          # one all-reduce: the same bits
    poses = np.asarray(a["poses"], np.float32)
    et, er = _pose_errors(poses, np.asarray(a["poses_true"]), 6)
    assert et.max() < 0.02, et
    assert er.max() < 0.1, er
    assert a["n_points"] == 200 and a["inliers"] > 0.9


def test_two_process_sharded_db_scores(ranks):
    for r in ranks:
        assert r["rows"] == 5                 # 20 rows over 4 shards
        np.testing.assert_allclose(r["scores"], r["want"], atol=1e-6)
    assert ranks[0]["scores"] == ranks[1]["scores"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

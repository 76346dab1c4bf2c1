"""The port's engine recovering from LOST (moved from
tests/test_torch_reloc.py, which holds relocalization module by module
against the JAX package): tests/test_loop_closing.py's kidnap on the
port, relocalized within 0.1 m of the true camera centre, as the JAX
engine does there, and tracking on from that pose.
"""

import numpy as np
import torch

from orbslam2_tpu.config import CapacityConfig, OrbConfig, STEREO, SlamConfig
from orbslam2_tpu.utils import synthetic
from orbslam2_tpu_torch.runtime import tracking as ttracking
from orbslam2_tpu_torch.runtime.slam import SlamEngine as TorchEngine
from test_torch_reloc import CAM, port_cfg

torch.set_num_threads(2)


def test_port_engine_relocalizes_after_lost():
    """tests/test_loop_closing.py's kidnap on the port's engine: map 10
    frames, declare LOST, show a view of frame 2."""
    cfg = SlamConfig(camera=CAM, orb=OrbConfig(n_features=600),
                     capacity=CapacityConfig(max_keyframes=32,
                                             max_map_points=1 << 13,
                                             local_ba_keyframes=8,
                                             local_ba_points=2048),
                     sensor=STEREO)
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, 900, extent=(14.0, 9.0, 40.0),
                                 z_near=3.0)
    poses = synthetic.straight_trajectory(10, step=0.25)
    eng = TorchEngine(port_cfg(cfg), device="cpu")
    for i, Tcw in enumerate(poses):
        eng.track_stereo(*synthetic.render_stereo(scene, CAM, Tcw, rng, 1.0),
                         0.1 * i)
    assert eng.state == ttracking.OK and eng.n_kfs > 5, eng.stats
    eng.state = ttracking.LOST
    eng.velocity = None
    T_back = poses[2]
    Tcw = eng.track_stereo(*synthetic.render_stereo(scene, CAM, T_back, rng,
                                                    1.0), 99.0)
    assert Tcw is not None, "relocalization failed"
    assert eng.stats["reloc"] == 1 and eng.state == ttracking.OK
    Ce = -Tcw[:3, :3].T @ Tcw[:3, 3]
    Cg = -T_back[:3, :3].T @ T_back[:3, 3]
    assert np.linalg.norm(Ce - Cg) < 0.1, (Ce, Cg)
    # tracking goes on from the relocalized pose
    assert eng.track_stereo(*synthetic.render_stereo(
        scene, CAM, poses[3], rng, 1.0), 99.1) is not None

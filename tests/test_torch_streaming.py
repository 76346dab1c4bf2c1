"""The streaming LOC tracker of the port (``runtime/streaming.py``)
against the JAX package's, on tests/test_torch_windowed.py's corridor and
JAX map (moved from that file; its module fixtures run here again): one
window of ``make_window_tracker`` on the map the JAX windowed engine
built over 12 frames, the port's uint8 packing equal to JAX's;
summaries' integer fields, associations and counters identical, poses
within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import torch

from orbslam2_tpu.runtime import streaming as jstreaming
from orbslam2_tpu_torch.runtime import streaming as tstreaming
from test_torch_windowed import (JCFG, N_ENGINE, TCFG, _assert_summaries,
                                 _port_map, _start_state,
                                 corridor, jax_engine)  # noqa: F401

torch.set_num_threads(2)


def test_streaming_tracker_matches_jax(corridor, jax_engine):
    _, frames, _ = corridor
    window = frames[N_ENGINE:N_ENGINE + 4]
    sT, assoc0, _, ref_kf = _start_state(jax_engine)
    flat = jstreaming.pack_window_uint8(window)
    np.testing.assert_array_equal(tstreaming.pack_window_uint8(window), flat)
    jres = jstreaming.make_window_tracker(JCFG, 4)(
        jax_engine.ms, jnp.asarray(flat), jnp.asarray(sT),
        jnp.asarray(assoc0), jnp.int32(ref_kf))
    track = tstreaming.make_window_tracker(TCFG, 4, device="cpu")
    tres = track(_port_map(jax_engine), flat, sT, assoc0, ref_kf)
    jsm = np.asarray(jres.summaries)
    assert (jsm[:, 34] >= 30).all(), jsm[:, 34]
    _assert_summaries(tres.summaries.numpy(), jsm)
    np.testing.assert_array_equal(tres.assoc.numpy(), np.asarray(jres.assoc))
    np.testing.assert_array_equal(tres.counters.numpy(),
                                  np.asarray(jres.counters))
    np.testing.assert_allclose(tres.state_T.numpy(), np.asarray(jres.state_T),
                               atol=1e-4, rtol=0)

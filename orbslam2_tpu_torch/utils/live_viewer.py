"""Minimal live viewer: the role of ``Viewer`` (src/Viewer.cc:54-248)
without Pangolin — a background HTTP server serving a canvas page that
polls the live map (points, keyframes, current camera) and exposes the
menu actions that matter to the engine: the Localization-Mode switch
(Viewer.cc:67-74, menuLocalizationMode → System::{Activate,Deactivate}
LocalizationMode, :125-135) and Reset (menuReset, :137).

Design: the reference redraws at camera fps from its own thread; here the
browser polls ``/state`` and the handler reads the engine's CURRENT
functional snapshot — no lock web, the immutable MapState is the
synchronization.  Point clouds are subsampled server-side to bound the
fetch.

Port of ``orbslam2_tpu/utils/live_viewer.py``: the snapshot moves the map
from the engine's device to the host explicitly.  The server binds
127.0.0.1 only."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>orbslam2_tpu live</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:12px }
canvas { background:#181818; border:1px solid #333 }
button { margin-right: 8px }
</style></head><body>
<div>
  <button id="loc">Localization Mode: ?</button>
  <button id="reset">Reset</button>
  <span id="info"></span>
</div>
<canvas id="c" width="900" height="600"></canvas>
<div><img id="fr" style="display:none;border:1px solid #333;margin-top:8px"
     alt="current frame"></div>
<script>
const c = document.getElementById('c'), g = c.getContext('2d');
let loc = false;
function draw(s) {
  g.clearRect(0, 0, c.width, c.height);
  const pts = s.points, kfs = s.keyframes;
  let minx=1e9, maxx=-1e9, minz=1e9, maxz=-1e9;
  for (const p of pts.concat(kfs)) {
    minx=Math.min(minx,p[0]); maxx=Math.max(maxx,p[0]);
    minz=Math.min(minz,p[2]); maxz=Math.max(maxz,p[2]);
  }
  const sc = Math.min(c.width/(maxx-minx+1e-6), c.height/(maxz-minz+1e-6))*0.9;
  const X = x => (x-minx)*sc + 0.05*c.width;
  const Z = z => c.height - ((z-minz)*sc + 0.05*c.height);
  g.fillStyle = '#6a6';
  for (const p of pts) g.fillRect(X(p[0]), Z(p[2]), 2, 2);
  g.fillStyle = '#48f';
  for (const k of kfs) g.fillRect(X(k[0])-2, Z(k[2])-2, 5, 5);
  if (s.camera) {
    g.fillStyle = '#f44';
    g.beginPath();
    g.arc(X(s.camera[0]), Z(s.camera[2]), 6, 0, 7); g.fill();
  }
  document.getElementById('info').textContent =
    ` state=${s.state} kfs=${s.n_kfs} pts=${s.n_points}` +
    ` loops=${s.loops_closed}`;
  loc = s.localization;
  document.getElementById('loc').textContent =
    'Localization Mode: ' + (loc ? 'ON' : 'OFF');
}
async function tick() {
  try { draw(await (await fetch('state')).json()); } catch (e) {}
  setTimeout(tick, 500);
}
async function frameTick() {   // annotated current frame (FrameDrawer)
  const img = document.getElementById('fr');
  try {
    const r = await fetch('frame.png?' + Date.now());
    if (r.ok) {
      const b = await r.blob();
      img.src = URL.createObjectURL(b);
      img.style.display = 'block';
    }
  } catch (e) {}
  setTimeout(frameTick, 500);
}
frameTick();
document.getElementById('loc').onclick =
  () => fetch('toggle_localization', {method: 'POST'});
document.getElementById('reset').onclick =
  () => fetch('reset', {method: 'POST'});
tick();
</script></body></html>"""


class LiveViewer:
    """Serve the live map of a System or SlamEngine.  start() returns the
    bound port (0 → ephemeral)."""

    def __init__(self, target, port: int = 0, max_points: int = 4000):
        self._engine = getattr(target, "engine", target)
        self._system = target if hasattr(target, "engine") else None
        self.max_points = max_points
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- snapshot
    def state(self) -> dict:
        eng = self._engine
        ms = eng.ms
        pos = ms.mp_pos.cpu().numpy()
        valid = ms.mp_valid.cpu().numpy()
        pts = pos[valid]
        if len(pts) > self.max_points:
            pts = pts[:: len(pts) // self.max_points + 1]
        kf_valid = ms.kf_valid.cpu().numpy()
        pose = ms.kf_pose.cpu().numpy()
        R = pose[:, :3, :3]
        t = pose[:, :3, 3]
        centers = -np.einsum("kji,kj->ki", R, t)[kf_valid]
        cam = None
        if eng.last_Tcw is not None:
            T = np.asarray(eng.last_Tcw)
            cam = (-T[:3, :3].T @ T[:3, 3]).tolist()
        return {
            "points": np.round(pts, 3).tolist(),
            "keyframes": np.round(centers, 3).tolist(),
            "camera": cam,
            "state": int(eng.state),
            "n_kfs": int(eng.n_kfs),
            "n_points": int(valid.sum()),
            "loops_closed": int(eng.stats.get("loops_closed", 0)),
            "localization": bool(eng.localization_only),
        }

    def frame_png(self) -> Optional[bytes]:
        """Annotated current frame (FrameDrawer.cc:34-206) — composed on
        demand at the viewer's poll rate; None before the first frame."""
        try:
            return self._engine.frame_overlay()
        except Exception:
            return None

    # ------------------------------------------------------- menu actions
    def toggle_localization(self) -> bool:
        """Viewer.cc:125-135 menu semantics."""
        if self._system is not None:
            if self._system.engine.localization_only:
                self._system.deactivate_localization_mode()
            else:
                self._system.activate_localization_mode()
        else:
            self._engine.localization_only = \
                not self._engine.localization_only
        return self._engine.localization_only

    def reset(self) -> None:
        if self._system is not None:
            self._system.reset()
            self._engine = self._system.engine
        elif hasattr(self._engine, "_auto_reset"):
            self._engine._auto_reset()

    # ------------------------------------------------------------- server
    def start(self) -> int:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body, ctype="application/json"):
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, _PAGE, "text/html")
                elif self.path == "/state":
                    self._send(200, json.dumps(viewer.state()))
                elif self.path.startswith("/frame.png"):
                    png = viewer.frame_png()
                    if png is None:
                        self._send(404, "{}")
                    else:
                        self._send(200, png, "image/png")
                else:
                    self._send(404, "{}")

            def do_POST(self):
                if self.path == "/toggle_localization":
                    on = viewer.toggle_localization()
                    self._send(200, json.dumps({"localization": on}))
                elif self.path == "/reset":
                    viewer.reset()
                    self._send(200, "{}")
                else:
                    self._send(404, "{}")

            def log_message(self, *a):      # quiet
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="live-viewer", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

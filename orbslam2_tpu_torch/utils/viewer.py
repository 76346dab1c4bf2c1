"""Offline map/trajectory visualization — the Viewer/MapDrawer/FrameDrawer
replacement (src/Viewer.cc, MapDrawer.cc, FrameDrawer.cc).

The reference opens a live Pangolin GUI; a TPU host is headless, so the
equivalent capability is offline export: PLY point clouds + camera
frusta (readable by MeshLab/CloudCompare), a self-contained HTML viewer
(three.js-free, canvas projection), and keypoint/track overlays rendered
into PNG via PIL.  All functions take the array MapState / engine outputs.

Port of ``orbslam2_tpu/utils/viewer.py``: the map is read from the
engine's device to the host explicitly.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """Map point cloud → ASCII PLY (MapDrawer::DrawMapPoints analogue)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            line = f"{points[i, 0]:.5f} {points[i, 1]:.5f} {points[i, 2]:.5f}"
            if colors is not None:
                c = colors[i].astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")


def camera_centers(poses_cw: Sequence[Optional[np.ndarray]]) -> np.ndarray:
    out = []
    for T in poses_cw:
        if T is None:
            continue
        out.append(-T[:3, :3].T @ T[:3, 3])
    return np.asarray(out) if out else np.zeros((0, 3))


def save_map_html(path: str, points: np.ndarray,
                  trajectory: Optional[np.ndarray] = None,
                  keyframes: Optional[np.ndarray] = None,
                  title: str = "orbslam2_tpu map") -> None:
    """Self-contained interactive HTML viewer (orbit + zoom, canvas 2D
    projection — no external assets, works offline)."""
    data = {
        "points": np.asarray(points, np.float32).round(4).tolist(),
        "traj": (np.asarray(trajectory, np.float32).round(4).tolist()
                 if trajectory is not None and len(trajectory) else []),
        "kfs": (np.asarray(keyframes, np.float32).round(4).tolist()
                if keyframes is not None and len(keyframes) else []),
    }
    html = _HTML_TEMPLATE.replace("__TITLE__", title).replace(
        "__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)


def draw_keypoints_png(path: str, image: np.ndarray, xy: np.ndarray,
                       matched: Optional[np.ndarray] = None,
                       state_text: str = "") -> None:
    """Current-frame overlay (FrameDrawer::DrawFrame analogue) → PNG."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).convert(
        "RGB")
    d = ImageDraw.Draw(img)
    for i, (x, y) in enumerate(xy):
        good = matched is not None and bool(matched[i])
        color = (0, 255, 0) if good else (255, 80, 80)
        d.rectangle([x - 3, y - 3, x + 3, y + 3], outline=color)
    if state_text:
        d.text((8, 8), state_text, fill=(255, 255, 0))
    img.save(path)


def export_engine_state(engine, out_dir: str) -> None:
    """One-call dump: map PLY + HTML + trajectory (Viewer menu's
    snapshot-equivalent for headless runs)."""
    os.makedirs(out_dir, exist_ok=True)
    pts = engine.map_points()
    save_ply(os.path.join(out_dir, "map.ply"), pts)
    poses = engine.frame_poses()
    traj = camera_centers(poses)
    kf_valid = engine.ms.kf_valid.cpu().numpy()
    kf_centers = engine.ms.kf_center().cpu().numpy()[kf_valid]
    save_map_html(os.path.join(out_dir, "map.html"), pts, traj, kf_centers)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">__TITLE__ — drag: orbit, wheel: zoom</div>
<canvas id="c"></canvas><script>
const D=__DATA__;const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=0.6,pitch=0.4,dist=30,cx=0,cy=0,cz=0;
if(D.points.length){let s=[0,0,0];for(const p of D.points){s[0]+=p[0];s[1]+=p[1];s[2]+=p[2];}
cx=s[0]/D.points.length;cy=s[1]/D.points.length;cz=s[2]/D.points.length;}
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
function proj(p){const x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
const x1=x*Math.cos(yaw)+z*Math.sin(yaw),z1=-x*Math.sin(yaw)+z*Math.cos(yaw);
const y2=y*Math.cos(pitch)-z1*Math.sin(pitch),z2=y*Math.sin(pitch)+z1*Math.cos(pitch);
const w=dist/(dist+z2+1e-6);if(w<=0)return null;
return [cv.width/2+x1*w*40, cv.height/2+y2*w*40];}
function draw(){ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
ctx.fillStyle='#9adfff';for(const p of D.points){const q=proj(p);if(q)ctx.fillRect(q[0],q[1],2,2);}
ctx.strokeStyle='#7CFC00';ctx.beginPath();let first=true;
for(const p of D.traj){const q=proj(p);if(!q)continue;
if(first){ctx.moveTo(q[0],q[1]);first=false;}else ctx.lineTo(q[0],q[1]);}ctx.stroke();
ctx.fillStyle='#ff5555';for(const p of D.kfs){const q=proj(p);if(q)ctx.fillRect(q[0]-2,q[1]-2,4,4);}}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-lx)*0.01;pitch+=(e.clientY-ly)*0.01;
lx=e.clientX;ly=e.clientY;draw();};
cv.onwheel=e=>{dist*=e.deltaY>0?1.1:0.9;draw();e.preventDefault();};
window.onresize=resize;resize();
</script></body></html>
"""

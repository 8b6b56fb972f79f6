"""Self-contained offline HTML viewer for point clouds and meshes (a numpy
copy of ``hcmvs_tpu/io/viewer.py``: the port imports nothing of the JAX
package).

The reference ships an interactive GLFW/OpenGL Viewer app
(ref: frame_main/apps/Viewer/Scene.cpp:268 — orbit camera over the scene's
point cloud / mesh).  The TPU-native framework targets headless
datacenter use, so the equivalent is an EXPORTED viewer: one `.html` file
with the geometry embedded (base64) and a dependency-free WebGL orbit
renderer — open it in any browser, no server, no network access.

    python -m hcmvs_tpu_torch.io.viewer scene_dense.ply -o scene.html
    python -m hcmvs_tpu_torch.io.viewer mesh.ply -o mesh.html
"""

from __future__ import annotations

import base64
import os
from typing import Optional

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>hcmvs viewer — %(title)s</title>
<style>
 html,body{margin:0;height:100%%;background:#101014;color:#ccc;
  font:12px monospace;overflow:hidden}
 canvas{display:block;width:100vw;height:100vh}
 #hud{position:fixed;left:8px;top:8px;pointer-events:none}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">%(title)s — %(n_points)d points, %(n_faces)d faces<br>
drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<script>
const PTS_B64 = "%(pts_b64)s";
const COL_B64 = "%(col_b64)s";
const IDX_B64 = "%(idx_b64)s";
function dec(b64, T){
  const s = atob(b64); const a = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) a[i] = s.charCodeAt(i);
  return new T(a.buffer);
}
const pts = dec(PTS_B64, Float32Array);
const cols = COL_B64.length ? dec(COL_B64, Uint8Array) : null;
const idx = IDX_B64.length ? dec(IDX_B64, Uint32Array) : null;
const n = pts.length / 3;
// center + scale
let cx=0, cy=0, cz=0;
for (let i = 0; i < n; i++){cx+=pts[3*i];cy+=pts[3*i+1];cz+=pts[3*i+2];}
cx/=n; cy/=n; cz/=n;
let r = 0;
for (let i = 0; i < n; i++){
  const dx=pts[3*i]-cx, dy=pts[3*i+1]-cy, dz=pts[3*i+2]-cz;
  r = Math.max(r, Math.sqrt(dx*dx+dy*dy+dz*dz));
}
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
const vsrc = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
 varying vec3 vc; void main(){ gl_Position = mvp*vec4(p,1.0);
 gl_PointSize = 2.0; vc = col; }`;
const fsrc = `precision mediump float; varying vec3 vc;
 void main(){ gl_FragColor = vec4(vc, 1.0); }`;
function sh(t, s){const o=gl.createShader(t);gl.shaderSource(o,s);
 gl.compileShader(o);return o;}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vsrc));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fsrc));
gl.linkProgram(prog); gl.useProgram(prog);
const pbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
gl.bufferData(gl.ARRAY_BUFFER, pts, gl.STATIC_DRAW);
const pa = gl.getAttribLocation(prog, "p");
gl.enableVertexAttribArray(pa);
gl.vertexAttribPointer(pa, 3, gl.FLOAT, false, 0, 0);
const cbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
let colf = new Float32Array(3*n);
if (cols) for (let i = 0; i < 3*n; i++) colf[i] = cols[i]/255;
else colf.fill(0.75);
gl.bufferData(gl.ARRAY_BUFFER, colf, gl.STATIC_DRAW);
const ca = gl.getAttribLocation(prog, "col");
gl.enableVertexAttribArray(ca);
gl.vertexAttribPointer(ca, 3, gl.FLOAT, false, 0, 0);
let ibuf = null, nidx = 0;
if (idx){ ibuf = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ibuf);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, idx, gl.STATIC_DRAW);
  nidx = idx.length; }
const ext = idx ? gl.getExtension("OES_element_index_uint") : null;
let az = 0.6, el = 0.4, dist = 2.8, panx = 0, pany = 0;
function mat(){
  const a = canvas.width/canvas.height, f = 2.2, zn = 0.01*r, zf = 40*r;
  const ce = Math.cos(el), se = Math.sin(el);
  const caz = Math.cos(az), saz = Math.sin(az);
  const eye = [cx + dist*r*ce*saz, cy + dist*r*se, cz + dist*r*ce*caz];
  const fwd = norm([cx-eye[0], cy-eye[1], cz-eye[2]]);
  const right = norm(cross(fwd, [0, 1, 0]));
  const up = cross(right, fwd);
  const e = [eye[0]+right[0]*panx+up[0]*pany,
             eye[1]+right[1]*panx+up[1]*pany,
             eye[2]+right[2]*panx+up[2]*pany];
  const t = [cx+right[0]*panx+up[0]*pany, cy+right[1]*panx+up[1]*pany,
             cz+right[2]*panx+up[2]*pany];
  const z = norm([e[0]-t[0], e[1]-t[1], e[2]-t[2]]);
  const x = norm(cross([0,1,0], z));
  const y = cross(z, x);
  const v = [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
   -(x[0]*e[0]+x[1]*e[1]+x[2]*e[2]),
   -(y[0]*e[0]+y[1]*e[1]+y[2]*e[2]),
   -(z[0]*e[0]+z[1]*e[1]+z[2]*e[2]), 1];
  const p = [f/a,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1,
             0,0,2*zf*zn/(zn-zf),0];
  return mul(p, v);
}
function norm(v){const l=Math.hypot(v[0],v[1],v[2])||1;
 return [v[0]/l,v[1]/l,v[2]/l];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]];}
function mul(a,b){const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function draw(){
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.063, 0.063, 0.078, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog, "mvp"), false, mat());
  if (ibuf && ext){
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ibuf);
    gl.drawElements(gl.TRIANGLES, nidx, gl.UNSIGNED_INT, 0);
  } else {
    gl.drawArrays(gl.POINTS, 0, n);
  }
}
let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if (!drag) return;
  const dx = e.clientX-drag[0], dy = e.clientY-drag[1];
  if (drag[2]) { panx -= dx*0.002*r*dist; pany += dy*0.002*r*dist; }
  else { az -= dx*0.005;
    el = Math.max(-1.5, Math.min(1.5, el + dy*0.005)); }
  drag = [e.clientX, e.clientY, drag[2]]; draw(); };
canvas.onwheel = e => { dist *= Math.exp(e.deltaY*0.001);
  dist = Math.max(0.05, Math.min(30, dist)); draw();
  e.preventDefault(); };
window.onresize = draw;
draw();
</script></body></html>
"""


def export_viewer_html(path: str, points: np.ndarray,
                       colors: Optional[np.ndarray] = None,
                       faces: Optional[np.ndarray] = None,
                       title: Optional[str] = None,
                       max_points: int = 1_500_000) -> None:
    """Write a dependency-free interactive viewer HTML.

    Args:
      points: (N, 3) float positions (mesh vertices when ``faces`` given).
      colors: optional (N, 3) uint8 (or float in [0,1]) per-point colors.
      faces: optional (F, 3) int triangle indices -> mesh rendering.
      max_points: point clouds larger than this are uniformly subsampled
        (browsers handle a few million points fine; .html size is the
        real constraint at ~16 bytes/point after base64).
    """
    pts = np.asarray(points, np.float32)
    if colors is not None:
        col = np.asarray(colors)
        if col.dtype != np.uint8:
            col = np.clip(col * 255, 0, 255).astype(np.uint8)
    else:
        col = None
    if faces is None and len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[sel]
        col = col[sel] if col is not None else None
    b64 = lambda a: base64.b64encode(  # noqa: E731
        np.ascontiguousarray(a).tobytes()).decode()
    html = _TEMPLATE % {
        "title": title or os.path.basename(path),
        "n_points": len(pts),
        "n_faces": 0 if faces is None else len(faces),
        "pts_b64": b64(pts),
        "col_b64": "" if col is None else b64(col),
        "idx_b64": "" if faces is None
        else b64(np.asarray(faces, np.uint32)),
    }
    with open(path, "w") as f:
        f.write(html)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Export an offline HTML viewer for a PLY cloud/mesh "
                    "(the reference Viewer app's headless equivalent)")
    ap.add_argument("input", help=".ply point cloud or mesh")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)
    from hcmvs_tpu_torch.io.ply import read_ply
    verts, extras = read_ply(args.input)
    out = args.output or os.path.splitext(args.input)[0] + ".html"
    export_viewer_html(out, verts,
                       colors=extras.get("colors"),
                       faces=extras.get("faces"),
                       title=os.path.basename(args.input))
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()

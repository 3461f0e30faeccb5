# Copied from simplex_tpu/services/viz.py; keep in step (tests/test_torch_core.py).
"""Solution visualization: tableau HTML + interactive geometric view.

Replaces the reference's two visualization engines (SURVEY.md §2.2):

* ``_tableau_to_html`` static tables with the pivot cell highlighted red
  (``solver_controller.py:257-287``) — reproduced here schema-compatible
  (``table table-bordered table-striped`` classes, th/td layout, 4-dp).
* gilp/plotly interactive 2D/3D feasible-region plot with iteration slider
  (``solver_controller.py:208-249``; behavior per reference
  ``docs/user_guide.md:192-219``: 2D for 2 vars, 3D for 3, tables only for
  >=4).  plotly is not available here, so the interactive view is a
  self-contained vanilla-JS + SVG widget: feasible-region polygon,
  constraint lines, vertex path of the simplex iterations with an
  iteration slider, and — matching gilp's second control — an
  objective-level slider sweeping an isoprofit line ``c.x = level`` over
  the objective's feasible range.  No external JS dependencies.
"""
from __future__ import annotations

import html as _html
import itertools
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PIVOT_STYLE = ('style="background-color:#fff0f0; color:#d00; '
                'font-weight:bold;"')


def tableau_to_html(table: List[List], pivot: Optional[Tuple[int, int]]) -> str:
    """One history table (headers row + labeled rows) → HTML string."""
    pr, pc = (pivot if pivot is not None else (-1, -1))
    out = ['<table class="table table-bordered table-striped" '
           'style="border:1px solid #ccc; justify-content:center; '
           'float:none; margin-left:auto; margin-right:auto;">']
    for r_idx, row in enumerate(table):
        out.append("<tr>")
        for c_idx, cell in enumerate(row):
            tag = "th" if (c_idx == 0 or r_idx == 0) else "td"
            style = ""
            if r_idx == pr + 1 and c_idx == pc + 1:  # +1 skips header row/col
                style = _PIVOT_STYLE
            text = f"{cell:.4f}" if isinstance(cell, float) else str(cell)
            out.append(f"<{tag} {style}>{_html.escape(text)}</{tag}>")
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def tables_to_html(tables: List[Dict]) -> str:
    """All history tables stacked with titles — the Plan-B static view."""
    parts = []
    for t in tables:
        parts.append(f"<h4 style='text-align:center'>"
                     f"{_html.escape(t['title'])}</h4>")
        parts.append(tableau_to_html(t["table"], t.get("pivot")))
    return "\n".join(parts)


# --------------------------------------------------------------------------- #
# Geometric view (2 variables): SVG feasible region + iteration slider        #
# --------------------------------------------------------------------------- #
def _feasible_vertices_2d(A: np.ndarray, b: np.ndarray,
                          ops: np.ndarray) -> List[Tuple[float, float]]:
    """Vertices of {x >= 0, A x (op) b} in 2-D via pairwise intersections."""
    # Treat every constraint as a halfplane a.x <= b (>= rows negated;
    # = rows become a +- pair).
    planes = [(np.array([-1.0, 0.0]), 0.0), (np.array([0.0, -1.0]), 0.0)]
    for i in range(len(b)):
        if ops[i] == -1:
            planes.append((A[i].astype(float), float(b[i])))
        elif ops[i] == 1:
            planes.append((-A[i].astype(float), -float(b[i])))
        else:
            planes.append((A[i].astype(float), float(b[i])))
            planes.append((-A[i].astype(float), -float(b[i])))

    verts = []
    for (a1, b1), (a2, b2) in itertools.combinations(planes, 2):
        M = np.array([a1, a2])
        if abs(np.linalg.det(M)) < 1e-12:
            continue
        x = np.linalg.solve(M, np.array([b1, b2]))
        if all(a @ x <= bb + 1e-7 * (1 + abs(bb)) for a, bb in planes):
            verts.append((float(x[0]), float(x[1])))
    # Deduplicate and order counter-clockwise around the centroid.
    uniq = []
    for v in verts:
        if not any(abs(v[0] - u[0]) + abs(v[1] - u[1]) < 1e-7 for u in uniq):
            uniq.append(v)
    if len(uniq) >= 3:
        cx = sum(v[0] for v in uniq) / len(uniq)
        cy = sum(v[1] for v in uniq) / len(uniq)
        uniq.sort(key=lambda v: np.arctan2(v[1] - cy, v[0] - cx))
    return uniq


def geometric_view_2d(A, b, ops, c, maximize: bool,
                      path: Sequence[Tuple[float, float]],
                      variables: Sequence[str]) -> str:
    """Self-contained SVG+JS widget for a 2-variable LP."""
    A = np.asarray(A, float).reshape(len(b), 2)
    b = np.asarray(b, float)
    ops = np.asarray(ops)
    verts = _feasible_vertices_2d(A, b, ops)

    pts = list(verts) + [tuple(map(float, p)) for p in path]
    if not pts:
        pts = [(0.0, 0.0), (1.0, 1.0)]
    xs = [p[0] for p in pts] + [0.0]
    ys = [p[1] for p in pts] + [0.0]
    span_x = max(xs) - min(xs) or 1.0
    span_y = max(ys) - min(ys) or 1.0
    x0, x1 = min(xs) - 0.15 * span_x, max(xs) + 0.15 * span_x
    y0, y1 = min(ys) - 0.15 * span_y, max(ys) + 0.15 * span_y

    data = {
        "vertices": verts,
        "path": [list(map(float, p)) for p in path],
        "constraints": [
            {"a": A[i].tolist(), "op": {-1: "<=", 0: "=", 1: ">="}[int(ops[i])],
             "b": float(b[i])}
            for i in range(len(b))
        ],
        "objective": list(map(float, c)),
        "maximize": bool(maximize),
        "view": [x0, y0, x1, y1],
        "vars": list(variables),
    }
    payload = json.dumps(data)
    return _GEO2D_TEMPLATE.replace("__DATA__", payload)


_GEO2D_TEMPLATE = """
<div class="stx-geo" style="max-width:720px;margin:0 auto;text-align:center">
  <svg id="stx-svg" viewBox="0 0 640 480" width="100%"
       style="background:#fcfcfe;border:1px solid #ddd;border-radius:6px"></svg>
  <div style="margin-top:8px">
    <input type="range" id="stx-slider" min="0" value="0" style="width:60%">
    <span id="stx-label" style="font-family:monospace"></span>
  </div>
  <div style="margin-top:4px">
    <input type="range" id="stx-zslider" min="0" max="100" value="0"
           style="width:60%">
    <span id="stx-zlabel" style="font-family:monospace;color:#0a7">
    </span>
  </div>
</div>
<script>
(function() {
  const D = __DATA__;
  const svg = document.getElementById('stx-svg');
  const NS = 'http://www.w3.org/2000/svg';
  const [x0, y0, x1, y1] = D.view;
  const W = 640, H = 480, PAD = 46;
  const sx = x => PAD + (x - x0) / (x1 - x0) * (W - 2*PAD);
  const sy = y => H - PAD - (y - y0) / (y1 - y0) * (H - 2*PAD);
  function el(tag, attrs, parent) {
    const e = document.createElementNS(NS, tag);
    for (const k in attrs) e.setAttribute(k, attrs[k]);
    (parent || svg).appendChild(e); return e;
  }
  // axes
  el('line', {x1: sx(Math.max(x0,0)), y1: sy(y0), x2: sx(Math.max(x0,0)),
              y2: sy(y1), stroke: '#999'});
  el('line', {x1: sx(x0), y1: sy(Math.max(y0,0)), x2: sx(x1),
              y2: sy(Math.max(y0,0)), stroke: '#999'});
  const lx = el('text', {x: W-10, y: sy(Math.max(y0,0))-6, 'text-anchor':'end',
                         'font-size':'12', fill:'#666'}); lx.textContent = D.vars[0];
  const ly = el('text', {x: sx(Math.max(x0,0))+8, y: 14, 'font-size':'12',
                         fill:'#666'}); ly.textContent = D.vars[1];
  // feasible region polygon
  if (D.vertices.length >= 3) {
    el('polygon', {points: D.vertices.map(v => sx(v[0])+','+sy(v[1])).join(' '),
                   fill: 'rgba(80,140,230,0.25)', stroke: '#4a7fd4'});
  }
  // constraint lines
  for (const con of D.constraints) {
    const [a1, a2] = con.a, bb = con.b;
    let p1, p2;
    if (Math.abs(a2) > 1e-12) { p1 = [x0, (bb - a1*x0)/a2]; p2 = [x1, (bb - a1*x1)/a2]; }
    else if (Math.abs(a1) > 1e-12) { p1 = [bb/a1, y0]; p2 = [bb/a1, y1]; }
    else continue;
    el('line', {x1: sx(p1[0]), y1: sy(p1[1]), x2: sx(p2[0]), y2: sy(p2[1]),
                stroke: '#c08', 'stroke-dasharray': '5,4', 'stroke-width': 1});
  }
  // objective-level slider: isoprofit line c.x = level swept over the
  // objective's range on the feasible set (gilp's second slider,
  // reference docs/user_guide.md:192-219).
  const isoG = el('g', {});
  const zslider = document.getElementById('stx-zslider');
  const zlabel = document.getElementById('stx-zlabel');
  const zpts = (D.vertices.length ? D.vertices : D.path);
  const zvals = zpts.map(v => D.objective[0]*v[0] + D.objective[1]*v[1]);
  const zmin = Math.min.apply(null, zvals), zmax = Math.max.apply(null, zvals);
  function drawIso() {
    while (isoG.firstChild) isoG.removeChild(isoG.firstChild);
    if (!(zmax > zmin)) { zlabel.textContent = ''; return; }
    const lvl = zmin + (zmax - zmin) * (+zslider.value) / 100;
    const [a1, a2] = D.objective;
    let p1, p2;
    if (Math.abs(a2) > 1e-12) { p1 = [x0, (lvl - a1*x0)/a2]; p2 = [x1, (lvl - a1*x1)/a2]; }
    else if (Math.abs(a1) > 1e-12) { p1 = [lvl/a1, y0]; p2 = [lvl/a1, y1]; }
    else { zlabel.textContent = ''; return; }
    el('line', {x1: sx(p1[0]), y1: sy(p1[1]), x2: sx(p2[0]), y2: sy(p2[1]),
                stroke: '#0a7', 'stroke-width': 2, 'stroke-dasharray': '8,5'},
       isoG);
    zlabel.textContent = ' Z = ' + lvl.toFixed(4);
  }
  zslider.addEventListener('input', drawIso);
  // simplex vertex path
  const pathG = el('g', {});
  const marker = el('circle', {r: 7, fill: '#d22', stroke: '#fff',
                               'stroke-width': 2});
  const slider = document.getElementById('stx-slider');
  const label = document.getElementById('stx-label');
  const P = D.path.length ? D.path : [[0,0]];
  slider.max = P.length - 1;
  function draw(k) {
    while (pathG.firstChild) pathG.removeChild(pathG.firstChild);
    for (let i = 1; i <= k; i++) {
      el('line', {x1: sx(P[i-1][0]), y1: sy(P[i-1][1]), x2: sx(P[i][0]),
                  y2: sy(P[i][1]), stroke: '#d22', 'stroke-width': 2.5}, pathG);
    }
    marker.setAttribute('cx', sx(P[k][0]));
    marker.setAttribute('cy', sy(P[k][1]));
    const z = D.objective[0]*P[k][0] + D.objective[1]*P[k][1];
    label.textContent = ' iter ' + k + ':  (' + P[k][0].toFixed(3) + ', '
      + P[k][1].toFixed(3) + ')  Z=' + z.toFixed(4);
  }
  slider.addEventListener('input', () => draw(+slider.value));
  draw(0);
  drawIso();
})();
</script>
"""


# --------------------------------------------------------------------------- #
# Geometric view (3 variables): rotatable SVG polyhedron + iteration slider   #
# --------------------------------------------------------------------------- #
def _halfspaces_3d(A: np.ndarray, b: np.ndarray, ops: np.ndarray):
    """Constraint set as halfspaces a.x <= b (plus x >= 0)."""
    planes = [(-np.eye(3)[i], 0.0) for i in range(3)]
    for i in range(len(b)):
        if ops[i] == -1:
            planes.append((A[i].astype(float), float(b[i])))
        elif ops[i] == 1:
            planes.append((-A[i].astype(float), -float(b[i])))
        else:
            planes.append((A[i].astype(float), float(b[i])))
            planes.append((-A[i].astype(float), -float(b[i])))
    return planes


def _feasible_polytope_3d(A: np.ndarray, b: np.ndarray, ops: np.ndarray):
    """Vertices + edges of {x >= 0, A x (op) b} in 3-D.

    Vertices are feasible intersections of 3 planes; an edge joins two
    vertices that share (at least) 2 active constraints.  O(k^3) over the
    constraint count — presentation code for human-scale problems, mirroring
    the reference's gilp 3-D view (its docs: 3-D plot for 3 variables).
    """
    planes = _halfspaces_3d(A, b, ops)
    k = len(planes)
    verts: List[np.ndarray] = []
    active: List[set] = []
    for i, j, l in itertools.combinations(range(k), 3):
        M = np.array([planes[i][0], planes[j][0], planes[l][0]])
        if abs(np.linalg.det(M)) < 1e-10:
            continue
        x = np.linalg.solve(M, np.array(
            [planes[i][1], planes[j][1], planes[l][1]]))
        if not np.all(np.isfinite(x)):
            continue
        if all(a @ x <= bb + 1e-7 * (1 + abs(bb)) for a, bb in planes):
            acts = {t for t, (a, bb) in enumerate(planes)
                    if abs(a @ x - bb) <= 1e-7 * (1 + abs(bb))}
            merged = False
            for v_idx, v in enumerate(verts):
                if np.sum(np.abs(v - x)) < 1e-7 * (1 + np.sum(np.abs(x))):
                    active[v_idx] |= acts
                    merged = True
                    break
            if not merged:
                verts.append(x)
                active.append(acts)
    edges = []
    for p, q in itertools.combinations(range(len(verts)), 2):
        if len(active[p] & active[q]) >= 2:
            edges.append((p, q))
    return [v.tolist() for v in verts], edges


def geometric_view_3d(A, b, ops, c, maximize: bool,
                      path: Sequence[Sequence[float]],
                      variables: Sequence[str]) -> str:
    """Self-contained rotatable SVG widget for a 3-variable LP."""
    A = np.asarray(A, float).reshape(len(b), 3)
    b = np.asarray(b, float)
    ops = np.asarray(ops)
    verts, edges = _feasible_polytope_3d(A, b, ops)

    pts = [list(map(float, v)) for v in verts] + \
          [list(map(float, p)) for p in path] + [[0.0, 0.0, 0.0]]
    arr = np.asarray(pts)
    center = ((arr.max(axis=0) + arr.min(axis=0)) / 2.0).tolist()
    radius = float(np.max(np.linalg.norm(arr - np.asarray(center), axis=1)))

    data = {
        "vertices": verts,
        "edges": edges,
        "path": [list(map(float, p)) for p in path],
        "objective": list(map(float, c)),
        "maximize": bool(maximize),
        "center": center,
        "radius": radius or 1.0,
        "vars": list(variables),
    }
    return _GEO3D_TEMPLATE.replace("__DATA__", json.dumps(data))


_GEO3D_TEMPLATE = """
<div class="stx-geo3d" style="max-width:720px;margin:0 auto;text-align:center">
  <svg id="stx3-svg" viewBox="0 0 640 480" width="100%"
       style="background:#fcfcfe;border:1px solid #ddd;border-radius:6px;
              cursor:grab"></svg>
  <div style="margin-top:8px">
    <input type="range" id="stx3-slider" min="0" value="0" style="width:60%">
    <span id="stx3-label" style="font-family:monospace"></span>
  </div>
  <div style="margin-top:4px">
    <input type="range" id="stx3-zslider" min="0" max="100" value="0"
           style="width:60%">
    <span id="stx3-zlabel" style="font-family:monospace;color:#0a7"></span>
  </div>
  <div style="font-size:12px;color:#888">drag to rotate</div>
</div>
<script>
(function() {
  const D = __DATA__;
  const svg = document.getElementById('stx3-svg');
  const NS = 'http://www.w3.org/2000/svg';
  const W = 640, H = 480;
  let rotX = -1.1, rotZ = 0.6;
  const scale = 190 / D.radius;
  function proj(p) {
    const x = p[0] - D.center[0], y = p[1] - D.center[1],
          z = p[2] - D.center[2];
    const cz = Math.cos(rotZ), szn = Math.sin(rotZ);
    const x1 = cz*x - szn*y, y1 = szn*x + cz*y, z1 = z;
    const cx = Math.cos(rotX), sx = Math.sin(rotX);
    const y2 = cx*y1 - sx*z1, z2 = sx*y1 + cx*z1;
    return [W/2 + x1*scale, H/2 + y2*scale, z2];
  }
  function el(tag, attrs, parent) {
    const e = document.createElementNS(NS, tag);
    for (const k in attrs) e.setAttribute(k, attrs[k]);
    (parent || svg).appendChild(e); return e;
  }
  const slider = document.getElementById('stx3-slider');
  const label = document.getElementById('stx3-label');
  const zslider = document.getElementById('stx3-zslider');
  const zlabel = document.getElementById('stx3-zlabel');
  const P = D.path.length ? D.path : [[0,0,0]];
  slider.max = P.length - 1;
  const zpts = (D.vertices.length ? D.vertices : P);
  const zvals = zpts.map(v =>
    D.objective[0]*v[0] + D.objective[1]*v[1] + D.objective[2]*v[2]);
  const zmin = Math.min.apply(null, zvals), zmax = Math.max.apply(null, zvals);
  function draw() {
    while (svg.firstChild) svg.removeChild(svg.firstChild);
    // axes from origin
    const O = proj([0,0,0]);
    const axes = [[D.radius,0,0],[0,D.radius,0],[0,0,D.radius]];
    axes.forEach((a, i) => {
      const E = proj(a);
      el('line', {x1:O[0], y1:O[1], x2:E[0], y2:E[1], stroke:'#bbb'});
      const t = el('text', {x:E[0], y:E[1], 'font-size':'11', fill:'#888'});
      t.textContent = D.vars[i];
    });
    // polytope edges
    for (const [p, q] of D.edges) {
      const a = proj(D.vertices[p]), b = proj(D.vertices[q]);
      el('line', {x1:a[0], y1:a[1], x2:b[0], y2:b[1],
                  stroke:'#4a7fd4', 'stroke-width':1.6, opacity:0.85});
    }
    for (const v of D.vertices) {
      const s = proj(v);
      el('circle', {cx:s[0], cy:s[1], r:3, fill:'#4a7fd4'});
    }
    // objective-level slider: isoprofit PLANE c.x = level clipped to the
    // polytope — each polytope edge crossing the plane contributes one
    // intersection point; the points, ordered around their projected
    // centroid, bound the translucent level polygon (gilp's second
    // slider in 3-D, reference docs/user_guide.md:192-219).
    if (zmax > zmin) {
      const lvl = zmin + (zmax - zmin) * (+zslider.value) / 100;
      const fv = D.vertices.map(v =>
        D.objective[0]*v[0] + D.objective[1]*v[1] + D.objective[2]*v[2] - lvl);
      const cut = [];
      for (const [p, q] of D.edges) {
        const fp = fv[p], fq = fv[q];
        if ((fp < 0) !== (fq < 0) && Math.abs(fp - fq) > 1e-12) {
          const t = fp / (fp - fq);
          const a = D.vertices[p], b = D.vertices[q];
          cut.push([a[0] + t*(b[0]-a[0]), a[1] + t*(b[1]-a[1]),
                    a[2] + t*(b[2]-a[2])]);
        }
      }
      if (cut.length >= 3) {
        const scr = cut.map(proj);
        const cx0 = scr.reduce((s,p)=>s+p[0],0)/scr.length;
        const cy0 = scr.reduce((s,p)=>s+p[1],0)/scr.length;
        const order = scr.map((p,i)=>[Math.atan2(p[1]-cy0, p[0]-cx0), i])
                         .sort((a,b)=>a[0]-b[0]).map(t=>t[1]);
        el('polygon', {points: order.map(i => scr[i][0]+','+scr[i][1]).join(' '),
                       fill:'rgba(10,170,119,0.18)', stroke:'#0a7',
                       'stroke-width':1.5, 'stroke-dasharray':'7,4'});
      }
      zlabel.textContent = ' Z = ' + lvl.toFixed(4);
    }
    // simplex path up to slider position
    const k = +slider.value;
    for (let i = 1; i <= k; i++) {
      const a = proj(P[i-1]), b = proj(P[i]);
      el('line', {x1:a[0], y1:a[1], x2:b[0], y2:b[1], stroke:'#d22',
                  'stroke-width':2.5});
    }
    const m = proj(P[k]);
    el('circle', {cx:m[0], cy:m[1], r:7, fill:'#d22', stroke:'#fff',
                  'stroke-width':2});
    const z = D.objective[0]*P[k][0] + D.objective[1]*P[k][1]
            + D.objective[2]*P[k][2];
    label.textContent = ' iter ' + k + ':  (' + P[k].map(
      v => v.toFixed(2)).join(', ') + ')  Z=' + z.toFixed(4);
  }
  slider.addEventListener('input', draw);
  zslider.addEventListener('input', draw);
  let drag = null;
  svg.addEventListener('pointerdown', e => {
    drag = [e.clientX, e.clientY]; svg.setPointerCapture(e.pointerId);
  });
  svg.addEventListener('pointermove', e => {
    if (!drag) return;
    rotZ += (e.clientX - drag[0]) * 0.01;
    rotX += (e.clientY - drag[1]) * 0.01;
    drag = [e.clientX, e.clientY]; draw();
  });
  svg.addEventListener('pointerup', () => { drag = null; });
  draw();
})();
</script>
"""


def build_visualization_html(lp, tables: List[Dict],
                             vertex_path: Optional[List] = None) -> str:
    """Pick the visualization: geometric widget + tables, or tables only.

    Mirrors the reference's dimensionality rule (gilp via
    ``docs/user_guide.md:192-219``): 2-D plot for 2 variables, 3-D for 3,
    tables only for >= 4.
    """
    parts = []
    if lp.n_vars == 2 and vertex_path:
        parts.append(geometric_view_2d(
            lp.A, lp.b, lp.ops, lp.c, lp.maximize,
            vertex_path, lp.variables,
        ))
    elif lp.n_vars == 3 and vertex_path:
        parts.append(geometric_view_3d(
            lp.A, lp.b, lp.ops, lp.c, lp.maximize,
            vertex_path, lp.variables,
        ))
    parts.append(tables_to_html(tables))
    return "\n".join(parts)

"""The viewer's embedded client page (single file, no build step; counterpart of
mesheditor_tpu/app/page.py, the same bytes).

Canvas shows /frame PNGs; mouse and key events post to /event; struck audio plays from
/audio. Interaction grammar follows the reference's Blender-alike bindings
(the reference app's README.md:20-27): orbit = drag, pan = shift-drag, zoom = wheel,
G/R/S = transform modes, Esc = select mode, K = strike mode, F = frame scene."""

PAGE_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8"/>
<title>mesheditor_tpu</title>
<style>
 body { margin:0; background:#15171c; color:#cfd3dc; font:13px system-ui, sans-serif;
        display:flex; height:100vh; overflow:hidden; }
 #side { width:230px; padding:10px; background:#1d2027; overflow-y:auto; }
 #main { flex:1; display:flex; flex-direction:column; }
 #canvas { flex:1; object-fit:contain; background:#0d0e11; cursor:crosshair; }
 .obj { padding:3px 6px; border-radius:4px; cursor:pointer; }
 .obj.sel { background:#3a5f9e; color:#fff; }
 #bar { padding:6px 10px; background:#1d2027; display:flex; gap:8px; align-items:center; }
 button { background:#2a2e37; color:#cfd3dc; border:1px solid #3a3f4b; border-radius:4px;
          padding:3px 10px; cursor:pointer; }
 button.active { background:#3a5f9e; color:#fff; }
 #timeline { flex:1; }
 #status { font-size:11px; color:#7d8494; padding:4px 10px; }
</style>
</head>
<body>
<div id="side">
  <h3 style="margin-top:0">Scene</h3>
  <div id="objects"></div>
  <hr/>
  <button id="add">+ object</button>
  <button id="del">delete</button>
  <hr/>
  <button id="verify">verify replay</button>
  <div id="verdict"></div>
  <hr/>
  <h3>Audio</h3>
  <div id="audiostats" style="font-size:11px; line-height:1.6"></div>
  <div id="solves" style="font-size:11px; color:#9aa3b5"></div>
  <canvas id="wave" width="210" height="56"
          style="background:#0d0e11; border-radius:4px; margin-top:6px"></canvas>
  <canvas id="spec" width="210" height="56"
          style="background:#0d0e11; border-radius:4px; margin-top:4px"></canvas>
  <div id="peaks" style="font-size:10px; color:#7d8494"></div>
  <hr/>
  <h3>Inspector</h3>
  <div id="inspector" style="font-size:11px; line-height:1.7"></div>
  <hr/>
  <h3>Physics</h3>
  <div id="physworld" style="font-size:11px; color:#9aa3b5"></div>
  <div id="physbodies" style="font-size:11px; line-height:1.7"></div>
  <button id="addbody">+ body on selected</button>
</div>
<div id="main">
  <div id="bar">
    <button data-mode="select" class="mode active">select</button>
    <button data-mode="translate" class="mode">move (G)</button>
    <button data-mode="rotate" class="mode">rotate (R)</button>
    <button data-mode="scale" class="mode">scale (S)</button>
    <button data-mode="strike" class="mode">strike (K)</button>
    <button id="framebtn">frame (F)</button>
    <input id="timeline" type="range" min="0" max="10" step="0.02" value="0"/>
    <span id="tlabel">t=0.0</span>
  </div>
  <img id="canvas"/>
  <div id="status"></div>
</div>
<script>
const canvas = document.getElementById('canvas');
let version = -1, state = null, dragging = null, moved = false;

async function post(ev) {
  const r = await fetch('/event', {method:'POST', body: JSON.stringify(ev)});
  state = await r.json();
  applyState();
}
function applyState() {
  if (!state) return;
  if (state.version !== version) {
    version = state.version;
    canvas.src = '/frame?v=' + version;
  }
  const list = document.getElementById('objects');
  list.innerHTML = '';
  for (const o of state.objects) {
    const d = document.createElement('div');
    d.className = 'obj' + (o.selected ? ' sel' : '');
    d.textContent = o.name + ' (#' + o.entity + ')';
    d.onclick = () => post({type:'click_entity', entity:o.entity});
    list.appendChild(d);
  }
  for (const b of document.querySelectorAll('.mode'))
    b.classList.toggle('active', b.dataset.mode === state.mode);
  document.getElementById('status').textContent =
    'mode=' + state.mode + '  selected=' + (state.selected_name || 'none')
    + '  session=' + state.session_dir;
  if (state.struck && state.has_audio) {
    const a = new Audio('/audio?ts=' + Date.now());
    a.play().catch(()=>{});
    drawWaveform();
  }
  if (state.audio) {
    const s = state.audio;
    document.getElementById('audiostats').innerHTML =
      'voices <b>' + s.active_voices + '</b> &nbsp; impacts <b>' + s.active_impacts
      + '</b><br/>bank ' + s.bank_objects + ' obj × ' + s.bank_modes + ' modes'
      + '<br/>dropped ' + s.events_dropped + ' · refused v' + s.voices_refused
      + ' t' + s.tracks_refused;
    const sv = document.getElementById('solves');
    sv.innerHTML = s.solves.map(j =>
      'solve ' + j.name + ': ' + (j.error ? ('failed — ' + j.error)
        : j.done ? (j.modes + ' modes ✓')
        : (Math.round(100 * j.fraction) + '%')
    )).join('<br/>');
  }
}
async function drawWaveform() {
  const w = await (await fetch('/waveform')).json();
  if (!w.available) return;
  const cw = document.getElementById('wave'), cs = document.getElementById('spec');
  const g = cw.getContext('2d'), gs = cs.getContext('2d');
  g.clearRect(0, 0, cw.width, cw.height);
  g.fillStyle = '#5a8fd8';
  const n = w.env_hi.length, mid = cw.height / 2;
  const amp = Math.max(...w.env_hi.map(Math.abs), ...w.env_lo.map(Math.abs), 1e-9);
  for (let i = 0; i < n; i++) {
    const x = i / n * cw.width;
    const y0 = mid - w.env_hi[i] / amp * mid, y1 = mid - w.env_lo[i] / amp * mid;
    g.fillRect(x, y0, Math.max(cw.width / n, 1), Math.max(y1 - y0, 1));
  }
  gs.clearRect(0, 0, cs.width, cs.height);
  gs.fillStyle = '#d8a15a';
  const m = w.spectrum.length;
  for (let i = 0; i < m; i++) {
    const x = i / m * cs.width, hgt = w.spectrum[i] * cs.height;
    gs.fillRect(x, cs.height - hgt, Math.max(cs.width / m, 1), hgt);
  }
  document.getElementById('peaks').textContent =
    'peaks: ' + w.peaks_hz.map(f => Math.round(f) + 'Hz').join(' ');
}
async function drawInspector() {
  const host = document.getElementById('inspector');
  if (!state || state.selected < 0) { host.textContent = '(select an object)'; return; }
  const p = await (await fetch('/inspect?entity=' + state.selected)).json();
  host.innerHTML = '';
  for (const [cname, rows] of Object.entries(p.components)) {
    const d = document.createElement('div');
    d.innerHTML = '<b>' + cname + '</b>';
    for (const f of rows) {
      const row = document.createElement('div');
      if (f.kind === 'bool') {
        const cb = document.createElement('input');
        cb.type = 'checkbox'; cb.checked = !!f.value;
        cb.onchange = () => post({type:'field_edit', entity:p.entity,
          component:cname, field:f.name, value:cb.checked}).then(drawInspector);
        row.append(cb, ' ' + f.name);
      } else if (f.kind === 'float' || f.kind === 'int') {
        const inp = document.createElement('input');
        inp.type = 'number'; inp.value = f.value; inp.step = 'any';
        inp.style.width = '70px';
        if (f.limits) { inp.min = f.limits[0]; inp.max = f.limits[1]; }
        inp.onchange = () => post({type:'field_edit', entity:p.entity,
          component:cname, field:f.name, value:+inp.value}).then(drawInspector);
        row.append(f.name + ' ', inp);
      } else {
        row.textContent = f.name + ': ' + JSON.stringify(f.value);
      }
      d.appendChild(row);
    }
    host.appendChild(d);
  }
}
async function drawPhysics() {
  const p = await (await fetch('/physics')).json();
  const w = document.getElementById('physworld');
  w.textContent = p.world.error ? ('world: ' + p.world.error)
    : ('world: ' + p.world.bodies + ' bodies (' + p.world.dynamic + ' dynamic)'
       + (p.world.joints && p.world.joints.length ? (', joints: ' + p.world.joints.join(', ')) : ''));
  const host = document.getElementById('physbodies');
  host.innerHTML = '';
  for (const b of p.bodies) {
    const d = document.createElement('div');
    d.innerHTML = '<b>' + b.name + '</b> — ' + b.shape + ', ' + b.motion;
    for (const f of b.fields) {
      const row = document.createElement('div');
      if (f.kind === 'bool') {
        const cb = document.createElement('input');
        cb.type = 'checkbox'; cb.checked = !!f.value;
        cb.onchange = () => post({type:'physics_edit', entity:b.entity,
                                  field:f.name, value:cb.checked}).then(drawPhysics);
        row.append(cb, ' ' + f.name);
      } else if (f.kind === 'float' || f.kind === 'int') {
        const inp = document.createElement('input');
        inp.type = 'number'; inp.value = f.value; inp.step = 'any';
        inp.style.width = '70px';
        if (f.limits) { inp.min = f.limits[0]; inp.max = f.limits[1]; }
        inp.onchange = () => post({type:'physics_edit', entity:b.entity,
                                   field:f.name, value:+inp.value}).then(drawPhysics);
        row.append(f.name + ' ', inp);
      } else {
        row.textContent = f.name + ': ' + f.value;
      }
      d.appendChild(row);
    }
    host.appendChild(d);
  }
}
document.getElementById('addbody').onclick =
  () => post({type:'add_body'}).then(drawPhysics);
setInterval(async () => {
  const r = await fetch('/state');
  const s = await r.json();
  if (s.version !== version || JSON.stringify(s.audio) !== JSON.stringify(state && state.audio)) {
    state = s; applyState(); drawPhysics(); drawInspector();
  }
}, 1500);
drawPhysics();
drawInspector();
function pos(e) {
  const r = canvas.getBoundingClientRect();
  const sx = canvas.naturalWidth / r.width, sy = canvas.naturalHeight / r.height;
  return {x: (e.clientX - r.left) * sx, y: (e.clientY - r.top) * sy};
}
canvas.onmousedown = e => {
  const p = pos(e);
  dragging = {button: e.button, shift: e.shiftKey, last: p};
  moved = false;
  if (!e.shiftKey && e.button === 0) post({type:'drag_start', ...p});
  e.preventDefault();
};
window.onmousemove = e => {
  if (!dragging) return;
  const p = pos(e);
  const dx = p.x - dragging.last.x, dy = p.y - dragging.last.y;
  if (Math.abs(dx) + Math.abs(dy) > 1) moved = true;
  if (dragging.shift) post({type:'pan', dx, dy});
  else if (dragging.button === 2 || dragging.button === 1) post({type:'orbit', dx, dy});
  else post({type:'drag_move', ...p});
  dragging.last = p;
};
window.onmouseup = e => {
  if (!dragging) return;
  const p = pos(e);
  const wasDrag = moved, btn = dragging.button, shift = dragging.shift;
  dragging = null;
  if (btn === 0 && !shift) {
    post({type:'drag_end'});
    if (!wasDrag) post({type:'click', ...p});
  }
};
canvas.oncontextmenu = e => e.preventDefault();
canvas.onwheel = e => { post({type:'zoom', dy: Math.sign(e.deltaY)}); e.preventDefault(); };
window.onkeydown = e => {
  const m = {g:'translate', r:'rotate', s:'scale', k:'strike', Escape:'select'}[e.key];
  if (m) post({type:'mode', mode:m});
  if (e.key === 'f') post({type:'frame'});
  if (e.key === 'x' || e.key === 'Delete') post({type:'delete'});
};
for (const b of document.querySelectorAll('.mode'))
  b.onclick = () => post({type:'mode', mode:b.dataset.mode});
document.getElementById('add').onclick = () => post({type:'add', name:'object'});
document.getElementById('del').onclick = () => post({type:'delete'});
document.getElementById('framebtn').onclick = () => post({type:'frame'});
document.getElementById('timeline').oninput = e => {
  document.getElementById('tlabel').textContent = 't=' + (+e.target.value).toFixed(1);
  post({type:'timeline', t: +e.target.value});
};
document.getElementById('verify').onclick = async () => {
  const r = await fetch('/verify-replay', {method:'POST', body:'{}'});
  const v = await r.json();
  document.getElementById('verdict').textContent =
    v.byte_exact ? 'replay byte-exact ✓' : ('DIVERGED: ' + v.fixture);
};
fetch('/state').then(r=>r.json()).then(s=>{state=s; applyState();});
</script>
</body>
</html>
"""

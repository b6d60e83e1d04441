"""Host viewer: interactive rendering + control panel over HTTP.

Counterpart of `opengl_raytracing_tpu/app/viewer.py`, with the same page,
panel schema and endpoints.  The reference's GLFW window + ImGui panel
become a browser page: the frame loop runs on the app's device in a
render thread and streams the presented image, quantized to uint8 on the
device, with the ImGui control surface rebuilt as an HTML panel
(reference: src/ui/gui.cpp:213-887):

  * `GET /`            — viewer page: stream, param sections with widgets,
                         model/env pickers, debug console with filter,
                         FPS meter, keybind legend, pointer-lock mouse
                         look + scroll FOV zoom (src/io/input.cpp:161-206)
  * `GET /stream`      — multipart/x-mixed-replace PNG stream
  * `GET /frame.png`   — one frame
  * `GET /act?name=X`  — input action (same names as app/input.py;
                         `look dx dy` / `zoom d` URL-encoded)
  * `GET /set?field=v` — RenderParams override (widget writes)
  * `GET /schema`      — panel schema: sections/fields/ranges (JSON)
  * `GET /pick?kind=model|env&index=N` — asset picker request
  * `GET /log?filter=S&n=N` — debug console scrollback (gui.cpp:16-104)
  * `GET /state`       — JSON status (fps, modes, full params, pickers,
                         frames encoded and frames failed)

Run:  python -m opengl_raytracing_tpu_torch.app.viewer --size 640x360 --scene bvh
(on the CUDA card; `--cpu` renders on the CPU).
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
import torch

from ..utils.checkpoint import params_to_dict
from ..utils.image import encode_jpeg, encode_png
from ..utils.log import default_logger, log
from ..models.graph import STATS as GRAPH_STATS, quantize_u8
from .headless import build_parser, make_app

# Panel schema mirroring the ImGui sections (reference: gui.cpp:213-621).
# Widget kinds: bool (int 0/1 checkbox), int (slider), float (slider),
# color (3x [0,1]), vec3 (3x float), choice (dropdown of labeled ints).
PANEL_SCHEMA = [
    ("Core", [  # gui.cpp:242-258
        ("spp_per_frame", "int", 1, 64, "Samples per pixel per frame"),
        ("exposure", "float", 0.05, 8.0, "Tonemap exposure"),
    ]),
    ("Materials", [  # gui.cpp:262-341
        ("mat_albedo_color", "color", 0, 1, "Albedo sphere color"),
        ("mat_albedo_spec_strength", "float", 0.0, 1.0, "Albedo specular"),
        ("mat_albedo_gloss", "float", 1.0, 512.0, "Albedo gloss"),
        ("mat_glass_enabled", "bool", 0, 1, "Glass sphere"),
        ("mat_glass_color", "color", 0, 1, "Glass tint"),
        ("mat_glass_ior", "float", 1.0, 2.5, "Index of refraction"),
        ("mat_glass_distortion", "float", 0.0, 1.0, "Refraction distortion"),
        ("mat_mirror_enabled", "bool", 0, 1, "Mirror sphere"),
        ("mat_mirror_color", "color", 0, 1, "Mirror tint"),
        ("mat_mirror_gloss", "float", 1.0, 1024.0, "Mirror gloss"),
    ]),
    ("Environment", [  # gui.cpp:345-520
        ("enable_env_map", "bool", 0, 1, "Environment cubemap"),
        ("env_map_intensity", "float", 0.0, 4.0, "Env intensity"),
        ("sun_enabled", "bool", 0, 1, "Sun light"),
        ("sun_color", "color", 0, 1, "Sun color"),
        ("sun_intensity", "float", 0.0, 2.0, "Sun intensity"),
        ("sun_yaw", "float", -180.0, 180.0, "Sun yaw (deg)"),
        ("sun_pitch", "float", -89.0, 89.0, "Sun pitch (deg)"),
        ("sky_enabled", "bool", 0, 1, "Sky dome"),
        ("sky_color", "color", 0, 1, "Sky color"),
        ("sky_intensity", "float", 0.0, 4.0, "Sky intensity"),
        ("sky_yaw", "float", -180.0, 180.0, "Sky yaw (deg)"),
        ("sky_pitch", "float", -90.0, 90.0, "Sky pitch (deg)"),
        ("point_light_enabled", "bool", 0, 1, "Point light"),
        ("point_light_color", "color", 0, 1, "Point light color"),
        ("point_light_intensity", "float", 0.0, 100.0, "Point intensity"),
        ("point_light_pos", "vec3", -10.0, 10.0, "Point light position"),
        ("point_light_orbit_enabled", "bool", 0, 1, "Orbit animation"),
        ("point_light_orbit_radius", "float", 0.0, 10.0, "Orbit radius"),
        ("point_light_orbit_speed", "float", 0.0, 180.0, "Orbit speed"),
        ("point_light_yaw", "float", -180.0, 180.0, "Orbit yaw"),
        ("point_light_pitch", "float", -89.0, 89.0, "Orbit pitch"),
    ]),
    ("Jitter", [  # gui.cpp:524-536
        ("enable_jitter", "bool", 0, 1, "Subpixel jitter"),
        ("jitter_still_scale", "float", 0.0, 1.0, "Still scale"),
        ("jitter_moving_scale", "float", 0.0, 1.0, "Moving scale"),
    ]),
    ("Global illumination", [  # gui.cpp:540-552
        ("enable_gi", "bool", 0, 1, "One-bounce GI"),
        ("gi_scale_analytic", "float", 0.0, 1.0, "GI scale (analytic)"),
        ("gi_scale_bvh", "float", 0.0, 1.0, "GI scale (BVH)"),
    ]),
    ("Ambient occlusion", [  # gui.cpp:556-574
        ("enable_ao", "bool", 0, 1, "AO"),
        ("ao_samples", "int", 1, 32, "AO samples"),
        ("ao_radius", "float", 0.05, 4.0, "AO radius"),
        ("ao_bias", "float", 0.0, 0.01, "AO bias"),
        ("ao_min", "float", 0.0, 1.0, "AO floor"),
    ]),
    ("TAA", [  # gui.cpp:578-600
        ("enable_taa", "bool", 0, 1, "Temporal AA"),
        ("taa_still_thresh", "float", 0.0, 0.001, "Still threshold"),
        ("taa_hard_moving_thresh", "float", 0.0, 1.0, "Hard kill thresh"),
        ("taa_history_min_weight", "float", 0.0, 1.0, "History min w"),
        ("taa_history_avg_weight", "float", 0.0, 1.0, "History avg w"),
        ("taa_history_max_weight", "float", 0.0, 1.0, "History max w"),
        ("taa_history_box_size", "float", 0.0, 0.5, "Box clamp size"),
    ]),
    ("SVGF", [  # gui.cpp:604-621
        ("enable_svgf", "bool", 0, 1, "SVGF filter"),
        ("svgf_var_max", "float", 0.0, 0.5, "Variance clamp"),
        ("svgf_k_var", "float", 0.0, 4.0, "k_var (still)"),
        ("svgf_k_color", "float", 0.0, 4.0, "k_color (still)"),
        ("svgf_k_var_motion", "float", 0.0, 4.0, "k_var (moving)"),
        ("svgf_k_color_motion", "float", 0.0, 4.0, "k_color (moving)"),
        ("svgf_strength", "float", 0.0, 1.0, "Filter strength"),
    ]),
    ("Debug", [
        ("motion_scale", "float", 0.0, 16.0, "Motion debug scale"),
        ("ordered_primary", "choice", 0, 2,
         "Primary walk: 0 off / 1 ordered / 2 auto"),
    ]),
]

# Hard clamps applied server-side on /set (reference clamps its widget
# ranges in ImGui; hotkey exposure clamp: src/io/input.cpp:147-153).
_SET_CLAMPS = {name: (kind, lo, hi)
               for _, fields in PANEL_SCHEMA
               for name, kind, lo, hi, _ in fields}

_PAGE = r"""<!doctype html><html><head><title>opengl_raytracing_tpu</title>
<style>
 body{background:#141414;color:#ddd;font-family:monospace;margin:0;
      display:flex;height:100vh;overflow:hidden}
 #left{flex:1;display:flex;flex-direction:column;min-width:0}
 #view{flex:1;display:flex;align-items:center;justify-content:center;
       background:#000;position:relative}
 #v{image-rendering:pixelated;max-width:100%;max-height:100%;cursor:crosshair}
 #hud{position:absolute;top:6px;left:8px;background:#000a;padding:2px 8px;
      font-size:12px}
 #console{height:160px;background:#0a0a0a;border-top:1px solid #333;
          display:flex;flex-direction:column}
 #conbar{padding:2px 6px;background:#1a1a1a}
 #conlog{flex:1;overflow-y:auto;margin:0;padding:4px 8px;font-size:11px;
         white-space:pre-wrap}
 #panel{width:360px;overflow-y:auto;background:#1b1b1b;
        border-left:1px solid #333;padding:6px;font-size:12px}
 details{margin-bottom:4px;border:1px solid #2c2c2c}
 summary{background:#262626;padding:3px 6px;cursor:pointer;user-select:none}
 .row{display:flex;align-items:center;padding:2px 6px;gap:6px}
 .row label{flex:0 0 150px;overflow:hidden;text-overflow:ellipsis;
            white-space:nowrap}
 .row input[type=range]{flex:1;min-width:40px}
 .row input[type=number]{width:64px;background:#111;color:#ddd;
                         border:1px solid #444}
 .row select{background:#111;color:#ddd;border:1px solid #444;flex:1}
 .val{width:52px;text-align:right;color:#9c9}
 button{background:#2c2c2c;color:#ddd;border:1px solid #555;cursor:pointer;
        margin:1px;padding:2px 8px}
 #legend{font-size:11px;color:#999;padding:4px 6px;line-height:1.5}
 input[type=text]{background:#111;color:#ddd;border:1px solid #444}
</style></head><body>
<div id="left">
 <div id="view"><img id="v" src="/stream"><div id="hud">--</div></div>
 <div id="console"><div id="conbar">console filter
   <input id="confilter" type="text" size="16">
   <button onclick="conClear=logN">clear view</button></div>
  <pre id="conlog"></pre></div>
</div>
<div id="panel">
 <details open><summary>Modes</summary>
  <div class="row"><button onclick="act('toggle_ray_mode')">F2 ray/raster</button>
   <button onclick="act('toggle_bvh')">F5 BVH</button>
   <button onclick="act('toggle_motion_debug')">F6 motion</button>
   <button onclick="act('reset')">R reset</button></div>
  <div class="row"><span id="modes"></span></div>
  <div class="row"><label>resize</label>
   <input id="rsz" type="text" size="9" placeholder="640x360">
   <button onclick="fetch('/resize?size='+
     encodeURIComponent(document.getElementById('rsz').value))">apply</button>
  </div>
 </details>
 <details open><summary>Assets</summary>
  <div class="row"><label>model</label><select id="pick_model"></select></div>
  <div class="row"><label>cubemap</label><select id="pick_env"></select></div>
 </details>
 <div id="sections"></div>
 <details><summary>Keybinds</summary><div id="legend">
  WASD+QE move &middot; drag / pointer-lock mouse look &middot; wheel FOV
  zoom &middot; F2 ray/raster &middot; F5 BVH &middot; F6 motion debug
  &middot; R reset accumulation &middot; F3 / &uarr;&darr; SPP presets
  &middot; 1-4 SPP direct &middot; [ ] exposure &middot; P pointer lock
  &middot; ESC release pointer</div></details>
</div>
<script>
const act=n=>fetch('/act?name='+encodeURIComponent(n));
const setp=(f,v)=>fetch('/set?'+f+'='+encodeURIComponent(v));
let schema=null, state=null, conClear=0, logN=0;

function widget(sec,f){
 const[name,kind,lo,hi,label]=f;
 const row=document.createElement('div');row.className='row';
 row.innerHTML='<label title="'+name+'">'+label+'</label>';
 if(kind=='bool'){
  const c=document.createElement('input');c.type='checkbox';c.id='w_'+name;
  c.onchange=()=>setp(name,c.checked?1:0);row.appendChild(c);
 }else if(kind=='choice'){
  const s=document.createElement('select');s.id='w_'+name;
  for(let i=lo;i<=hi;i++){const o=document.createElement('option');
   o.value=i;o.textContent=i;s.appendChild(o);}
  s.onchange=()=>setp(name,s.value);row.appendChild(s);
 }else if(kind=='color'||kind=='vec3'){
  for(let k=0;k<3;k++){
   const n=document.createElement('input');n.type='number';
   n.step=kind=='color'?0.05:0.1;n.min=lo;n.max=hi;n.id='w_'+name+'_'+k;
   n.onchange=()=>{const v=[0,1,2].map(j=>
     document.getElementById('w_'+name+'_'+j).value||0).join(',');
    setp(name,v);};
   row.appendChild(n);}
 }else{
  const r=document.createElement('input');r.type='range';r.id='w_'+name;
  r.min=lo;r.max=hi;r.step=(hi-lo)/200;
  const v=document.createElement('span');v.className='val';
  v.id='wv_'+name;
  r.oninput=()=>{v.textContent=(+r.value).toPrecision(3);
   setp(name,r.value);};
  row.appendChild(r);row.appendChild(v);
 }
 return row;
}

fetch('/schema').then(r=>r.json()).then(s=>{
 schema=s;const root=document.getElementById('sections');
 for(const[sec,fields]of s){
  const d=document.createElement('details');
  if(sec=='Core')d.open=true;
  const t=document.createElement('summary');t.textContent=sec;
  d.appendChild(t);
  for(const f of fields)d.appendChild(widget(sec,f));
  root.appendChild(d);
 }
 sync();
});

function syncWidget(f,val){
 const[name,kind]=f;
 const active=document.activeElement&&document.activeElement.id||'';
 if(kind=='bool'){const c=document.getElementById('w_'+name);
  if(c&&active!=c.id)c.checked=!!val;}
 else if(kind=='choice'){const s=document.getElementById('w_'+name);
  if(s&&active!=s.id)s.value=val;}
 else if(kind=='color'||kind=='vec3'){
  for(let k=0;k<3;k++){const n=document.getElementById('w_'+name+'_'+k);
   if(n&&active!=n.id)n.value=(+val[k]).toPrecision(3);}}
 else{const r=document.getElementById('w_'+name);
  if(r&&active!=r.id){r.value=val;
   const v=document.getElementById('wv_'+name);
   if(v)v.textContent=(+val).toPrecision(3);}}
}

function syncPicker(id,entries,selected,kind){
 const s=document.getElementById(id);
 if(!s||document.activeElement==s)return;
 if(s.options.length!=entries.length){
  s.innerHTML='';
  entries.forEach((e,i)=>{const o=document.createElement('option');
   o.value=i;o.textContent=e.split('/').pop();s.appendChild(o);});
  s.onchange=()=>fetch('/pick?kind='+kind+'&index='+s.value);
 }
 if(selected>=0)s.value=selected;
}

function sync(){
 fetch('/state').then(r=>r.json()).then(j=>{
  state=j;
  document.getElementById('hud').textContent=
   j.fps.toFixed(1)+' fps ('+j.ms_per_frame.toFixed(1)+' ms) frame '+
   j.frame_index+(j.camera?' cam ['+j.camera.map(x=>x.toFixed(1))+']':'');
  document.getElementById('modes').textContent=
   (j.ray_mode?'RAY':'RASTER')+(j.use_bvh?' | BVH':' | analytic')+
   (j.show_motion?' | motion':'');
  if(schema)for(const[sec,fields]of schema)
   for(const f of fields)if(f[0]in j.params)syncWidget(f,j.params[f[0]]);
  syncPicker('pick_model',j.model_entries,j.model_selected,'model');
  syncPicker('pick_env',j.env_entries,j.env_selected,'env');
 }).catch(()=>{});
 const flt=document.getElementById('confilter').value;
 fetch('/log?n=400&filter='+encodeURIComponent(flt)).then(r=>r.json())
  .then(j=>{logN=j.total;
   const el=document.getElementById('conlog');
   const atEnd=el.scrollTop+el.clientHeight>=el.scrollHeight-4;
   el.textContent=j.lines.slice(Math.max(0,conClear-j.total+j.lines.length))
     .join('\n');
   if(atEnd)el.scrollTop=el.scrollHeight;}).catch(()=>{});
}
setInterval(sync,700);

// keyboard (reference: src/io/input.cpp:16-156)
const keymap={'w':'move_w','a':'move_a','s':'move_s','d':'move_d',
 'q':'move_q','e':'move_e','r':'reset','F2':'toggle_ray_mode',
 'F5':'toggle_bvh','F6':'toggle_motion_debug','F3':'spp_cycle',
 '[':'exposure_down',']':'exposure_up','ArrowUp':'spp_up',
 'ArrowDown':'spp_down','1':'spp_preset_1','2':'spp_preset_2',
 '3':'spp_preset_3','4':'spp_preset_4','p':'toggle_pointer_lock'};
document.addEventListener('keydown',ev=>{
 if(ev.target.tagName=='INPUT'||ev.target.tagName=='SELECT')return;
 const a=keymap[ev.key];
 if(a){act(a);ev.preventDefault();}
 if(ev.key=='p')document.getElementById('v').requestPointerLock();
});

// mouse look: pointer lock OR drag on the stream; deltas accumulate and
// flush at ~30Hz (reference: src/io/input.cpp:161-189)
const img=document.getElementById('v');
let accDX=0,accDY=0,dragging=false;
img.addEventListener('click',()=>{
 if(document.pointerLockElement!=img)img.requestPointerLock();});
img.addEventListener('mousedown',()=>dragging=true);
document.addEventListener('mouseup',()=>dragging=false);
document.addEventListener('mousemove',ev=>{
 if(document.pointerLockElement==img){accDX+=ev.movementX;
  accDY-=ev.movementY;}
 else if(dragging){accDX+=ev.movementX;accDY-=ev.movementY;}
});
setInterval(()=>{
 if(accDX||accDY){act('look '+accDX.toFixed(1)+' '+accDY.toFixed(1));
  accDX=accDY=0;}
},33);
// scroll = FOV zoom (reference: src/io/input.cpp:196-206)
img.addEventListener('wheel',ev=>{
 act('zoom '+(ev.deltaY<0?1:-1));ev.preventDefault();},{passive:false});
</script></body></html>"""


class ViewerState:
    def __init__(self, application, stream_level: int = 1,
                 stream_format: str = "png", jpeg_quality: int = 85):
        self.application = application
        self.lock = threading.Lock()
        self.png: bytes = b""
        self.running = True
        # frames encoded for the stream, and steps that raised (each is
        # logged with its traceback; the last good frame keeps serving);
        # the host's ms of the last 30 steps (step + uint8 copy queued)
        # and encodes, for /state
        self.frames_encoded = 0
        self.failed_frames = 0
        self.step_ms = collections.deque(maxlen=30)
        self.encode_ms = collections.deque(maxlen=30)
        # PNG zlib level for the stream: 0 = stored (fastest encode,
        # ~3x bytes — right for localhost), 1 = fast deflate (default).
        # stream_format "jpeg" swaps the stream parts AND /frame.png to
        # baseline JPEG (utils.image.encode_jpeg, ~10x smaller than
        # stored PNG at q85 — right for remote links); the endpoint
        # keeps its historical path name but serves image/jpeg.
        self.stream_level = stream_level
        self.stream_format = stream_format
        self.jpeg_quality = jpeg_quality
        self.stream_ctype = (b"image/jpeg" if stream_format == "jpeg"
                             else b"image/png")
        # ray frames leave their uint8 image on the device (quantized in
        # the captured frame)
        application.want_u8 = True

    def _encode(self, arr: np.ndarray) -> None:
        t0 = time.perf_counter()
        if self.stream_format == "jpeg":
            self.png = encode_jpeg(arr[::-1], quality=self.jpeg_quality)
        else:
            self.png = encode_png(arr[::-1], level=self.stream_level)
        self.encode_ms.append((time.perf_counter() - t0) * 1e3)
        self.frames_encoded += 1

    def loop(self, target_fps: float = 30.0):
        device = self.application.app.device
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            self._loop(target_fps)

    def _loop(self, target_fps: float):
        # One-frame pipeline: on the card, step N+1 is queued before frame
        # N's uint8 image is encoded.  Frame N's image goes to pinned host
        # memory by an asynchronous copy with an event behind it, so the
        # host waits for that copy alone, not for step N+1; two pinned
        # buffers take turns.  On the CPU the copy is the tensor itself.
        pinned = [None, None]
        turn = 0
        pending = None  # (event or None, host uint8 tensor)
        while self.running:
            if self.application.input.quit:
                # ESC parity (reference: input.cpp quitRequested -> main
                # loop exit): /act?name=quit ends the render loop
                self.running = False
                break
            t0 = time.time()
            try:
                with self.lock:
                    img = self.application.step()
                    dev = (self.application.last_u8
                           if self.application.last_u8 is not None
                           else quantize_u8(img))
                    if dev.is_cuda:
                        buf = pinned[turn]
                        if buf is None or buf.shape != dev.shape:
                            buf = pinned[turn] = torch.empty(
                                dev.shape, dtype=torch.uint8,
                                pin_memory=True)
                        buf.copy_(dev, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record()
                        turn = 1 - turn
                        ready = (event, buf)
                    else:
                        ready = (None, dev)
                self.step_ms.append((time.time() - t0) * 1e3)
                if pending is not None:
                    if pending[0] is not None:
                        pending[0].synchronize()
                    self._encode(pending[1].numpy())
                pending = ready
            except Exception as exc:  # noqa: BLE001
                # a failed frame must not kill the stream thread (the
                # reference logs render errors and keeps its loop alive);
                # the last good frame keeps serving while we retry, and
                # /state reports the count
                self.failed_frames += 1
                log("GUI", "frame failed (%d so far): %s\n%s",
                    self.failed_frames, exc, traceback.format_exc())
                pending = None
                time.sleep(0.5)
            dt = time.time() - t0
            time.sleep(max(0.0, 1.0 / target_fps - dt))


def _mean(values) -> float:
    return round(float(np.mean(values)), 3) if values else 0.0


def make_handler(vs: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _ok(self, ctype, body):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._ok("application/json", json.dumps(obj).encode())

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            app = vs.application
            if url.path == "/":
                self._ok("text/html", _PAGE.encode())
            elif url.path == "/schema":
                self._json(PANEL_SCHEMA)
            elif url.path == "/frame.png":
                ctype = ("image/jpeg" if vs.stream_format == "jpeg"
                         else "image/png")
                self._ok(ctype, vs.png or b"")
            elif url.path == "/stream":
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=f")
                self.end_headers()
                try:
                    while vs.running:
                        png = vs.png
                        if png:
                            self.wfile.write(b"--f\r\nContent-Type: "
                                             + vs.stream_ctype
                                             + b"\r\n\r\n")
                            self.wfile.write(png + b"\r\n")
                        time.sleep(1.0 / 30.0)
                except (BrokenPipeError, ConnectionResetError):
                    pass
            elif url.path == "/act":
                name = unquote(q.get("name", [""])[0])
                try:
                    with vs.lock:
                        app.act(name)
                    self._json({"ok": True})
                except ValueError as exc:
                    self._json({"ok": False, "err": str(exc)})
            elif url.path == "/set":
                try:
                    with vs.lock:
                        for field, vals in q.items():
                            self._apply_set(app, field, vals[0])
                    self._json({"ok": True})
                except (AttributeError, ValueError, TypeError) as exc:
                    self._json({"ok": False, "err": str(exc)})
            elif url.path == "/resize":
                # reference resize callback recreates accum/gbuffer
                # (src/app/application.cpp:216-231)
                try:
                    w, h = (int(x) for x in
                            q.get("size", ["0x0"])[0].lower().split("x"))
                    if not (8 <= h <= 4320 and 8 <= w <= 7680):
                        raise ValueError(f"bad size {w}x{h}")
                    with vs.lock:
                        app.app.resize(h, w)
                    self._json({"ok": True, "height": h, "width": w})
                except (ValueError, TypeError) as exc:
                    self._json({"ok": False, "err": str(exc)})
            elif url.path == "/pick":
                kind = q.get("kind", [""])[0]
                idx = int(q.get("index", ["-1"])[0])
                picker = (app.app.model_picker if kind == "model"
                          else app.app.env_picker if kind == "env" else None)
                if picker is None:
                    self._json({"ok": False, "err": f"bad kind {kind!r}"})
                else:
                    with vs.lock:
                        picker.request(idx)
                    self._json({"ok": True, "requested": picker.selected})
            elif url.path == "/log":
                n = int(q.get("n", ["200"])[0])
                needle = unquote(q.get("filter", [""])[0]) or None
                logger = default_logger()
                lines = logger.filtered(needle)
                # total: FILTERED count — the page's clear-view marker is
                # in the same units as the returned lines
                self._json({"total": len(lines),
                            "lines": lines[-n:]})
            elif url.path == "/state":
                # vs.lock: a step rebinds the render state and the
                # params; read them between steps
                with vs.lock:
                    snap = self._state_snapshot(app.app)
                self._json(snap)
            else:
                self.send_error(404)

        @staticmethod
        def _state_snapshot(a):
            return {
                    "fps": round(a.fps, 1),
                    "ms_per_frame": round(float(np.mean(
                        a.frame_times_ms[-30:])) if a.frame_times_ms
                        else 0.0, 2),
                    "frame_index": int(a.render_state.frame_index),
                    "ray_mode": a.ray_mode, "use_bvh": a.use_bvh,
                    "show_motion": a.show_motion,
                    "spp": a.params.spp_per_frame,
                    "exposure": float(a.params.exposure),
                    "camera": [round(float(x), 3) for x in
                               np.asarray(a.camera.position)],
                    "fov": round(a.camera.fov, 1),
                    "params": params_to_dict(a.params),
                    "model_entries": a.model_picker.entries,
                    "model_selected": a.model_picker.selected,
                    "env_entries": a.env_picker.entries,
                    "env_selected": a.env_picker.selected,
                    "device": str(a.device),
                    "frames_encoded": vs.frames_encoded,
                    "failed_frames": vs.failed_frames,
                    "jit": vs.application.jit,
                    "eager_frames": vs.application.eager_frames,
                    "captures": GRAPH_STATS["captures"],
                    "replays": GRAPH_STATS["replays"],
                    "step_ms": _mean(vs.step_ms),
                    "encode_ms": _mean(vs.encode_ms),
            }

        @staticmethod
        def _apply_set(app, field, raw):
            cur = getattr(app.app.params, field)  # raises on bad field
            if isinstance(cur, tuple):
                val = tuple(float(x) for x in raw.split(","))
                if len(val) != len(cur):
                    raise ValueError(f"{field} wants {len(cur)} components")
            elif isinstance(cur, int):
                val = int(float(raw))
            else:
                val = float(raw)
            clamp = _SET_CLAMPS.get(field)
            if clamp is not None:
                _, lo, hi = clamp
                if isinstance(val, tuple):
                    # colors/vec3s clamp per component like ImGui's
                    # bounded widgets (gui.cpp color pickers are [0,1])
                    val = tuple(min(max(v, lo), hi) for v in val)
                else:
                    val = min(max(val, lo), hi)
                    val = int(val) if isinstance(cur, int) else float(val)
            app.app.params = app.app.params.replace(**{field: val})
            # keep the hotkey mirrors in sync (the reference seeds
            # input.exposure from params at startup, application.cpp:309);
            # otherwise the next ]/ArrowUp press would compute from a
            # stale value and snap the panel setting back
            if field == "exposure":
                app.input.exposure = float(val)
            elif field == "spp_per_frame":
                app.input.spp_per_frame = int(val)

    return Handler


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--stream-level", type=int, default=1,
                        choices=range(0, 10),
                        help="PNG zlib level for the stream (0 = stored, "
                             "fastest encode for localhost)")
    parser.add_argument("--stream-format", choices=("png", "jpeg"),
                        default="png",
                        help="stream codec: jpeg is ~10x smaller at q85 "
                             "(right for remote links)")
    parser.add_argument("--jpeg-quality", type=int, default=85)
    args = parser.parse_args(argv)
    args._viewer = True  # turbo defaults to 8 here (see build_parser)
    application = make_app(args)
    vs = ViewerState(application, stream_level=args.stream_level,
                     stream_format=args.stream_format,
                     jpeg_quality=args.jpeg_quality)
    t = threading.Thread(target=vs.loop, args=(args.fps,), daemon=True)
    t.start()
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(vs))
    log("GUI", "viewer at http://localhost:%d (%s, %s)", args.port,
        args.size, application.app.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        vs.running = False
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    main()

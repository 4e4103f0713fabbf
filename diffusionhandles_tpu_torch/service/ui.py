"""Browser UI for the 3-step editing flow.

A copy of the JAX package's `service/ui.py` page (reference:
diffhandles_pipeline_webapp.py's Gradio Blocks UI: upload and prompt,
foreground prompt, transform sliders, previews), served at GET / of the
pipeline service. It speaks the services' wire protocol, which both
packages share, so the same page drives either; images travel as the
codec's base64 ndarrays.
"""

PIPELINE_UI_HTML = """<!DOCTYPE html>
<html>
<head>
<title>DiffusionHandles TPU</title>
<style>
body { font-family: sans-serif; max-width: 1100px; margin: 20px auto; }
fieldset { margin-bottom: 16px; border: 1px solid #bbb; border-radius: 6px; }
label { display: inline-block; min-width: 140px; }
canvas, img.result { border: 1px solid #999; image-rendering: pixelated; }
button { padding: 6px 14px; margin: 4px; }
.row { display: flex; gap: 16px; align-items: flex-start; }
#status { color: #06c; font-weight: bold; }
input[type=number] { width: 70px; }
</style>
</head>
<body>
<h1>DiffusionHandles — TPU</h1>
<p id="status">idle</p>

<fieldset><legend>Step 1 — input image (~expensive: inversion)</legend>
<label>Image</label><input type="file" id="imgfile" accept="image/*"><br>
<label>Prompt</label><input type="text" id="prompt" size="60"
  value="a photo of an object on a table"><br>
<button onclick="setInputImage()">Set input image</button>
<div class="row"><canvas id="inputview" width="256" height="256"></canvas>
<img id="depthview" class="result" width="256"></div>
</fieldset>

<fieldset><legend>Step 2 — foreground object</legend>
<label>Foreground prompt</label>
<input type="text" id="fgprompt" size="40" value="object"><br>
<label>or mask image</label>
<input type="file" id="maskfile" accept="image/*"><br>
<button onclick="setForeground()">Set foreground</button>
</fieldset>

<fieldset><legend>Step 3 — 3D transform</legend>
<label>Rotation angle (deg)</label>
<input type="number" id="angle" value="0" step="5"><br>
<label>Rotation axis</label>
x <input type="number" id="ax" value="0" step="0.1">
y <input type="number" id="ay" value="1" step="0.1">
z <input type="number" id="az" value="0" step="0.1"><br>
<label>Translation</label>
x <input type="number" id="tx" value="0" step="0.05">
y <input type="number" id="ty" value="0" step="0.05">
z <input type="number" id="tz" value="0" step="0.05"><br>
<button onclick="previewEdit()">Preview (fast, no diffusion)</button>
<button onclick="transformForeground()">Run guided edit</button>
<div class="row">
<div><h4>preview</h4><img id="previewview" class="result" width="256"></div>
<div><h4>edited</h4><img id="editview" class="result" width="256"></div>
</div>
</fieldset>

<script>
const status = (m) => document.getElementById('status').textContent = m;

function b64encodeF32(arr) {
  const bytes = new Uint8Array(arr.buffer);
  let s = '';
  for (let i = 0; i < bytes.length; i += 8192)
    s += String.fromCharCode.apply(null, bytes.subarray(i, i + 8192));
  return btoa(s);
}
function ndarray(arr, shape) {
  return {__ndarray__: b64encodeF32(arr), dtype: 'float32', shape: shape};
}
function decodeNd(obj) {
  const raw = atob(obj.__ndarray__);
  const bytes = new Uint8Array(raw.length);
  for (let i = 0; i < raw.length; i++) bytes[i] = raw.charCodeAt(i);
  return {data: new Float32Array(bytes.buffer), shape: obj.shape};
}
async function call(endpoint, payload) {
  status(endpoint + ' ...');
  const resp = await fetch(endpoint, {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(payload)});
  const out = await resp.json();
  if (!out.ok) { status('error: ' + out.error); throw new Error(out.error); }
  status('idle');
  return out.data;
}
function fileToTensor(file, cb) {
  const img = new Image();
  img.onload = () => {
    const size = 512;
    const cv = document.createElement('canvas');
    cv.width = size; cv.height = size;
    const ctx = cv.getContext('2d');
    ctx.drawImage(img, 0, 0, size, size);
    const data = ctx.getImageData(0, 0, size, size).data;
    const t = new Float32Array(3 * size * size);
    for (let y = 0; y < size; y++) for (let x = 0; x < size; x++) {
      const i = (y * size + x) * 4;
      t[0 * size * size + y * size + x] = data[i] / 255;
      t[1 * size * size + y * size + x] = data[i + 1] / 255;
      t[2 * size * size + y * size + x] = data[i + 2] / 255;
    }
    const view = document.getElementById('inputview').getContext('2d');
    view.drawImage(cv, 0, 0, 256, 256);
    cb(ndarray(t, [1, 3, size, size]));
  };
  img.src = URL.createObjectURL(file);
}
function tensorToImg(nd, el) {
  const {data, shape} = decodeNd(nd);
  const c = shape[1], h = shape[2], w = shape[3];
  const cv = document.createElement('canvas');
  cv.width = w; cv.height = h;
  const ctx = cv.getContext('2d');
  const im = ctx.createImageData(w, h);
  let lo = Infinity, hi = -Infinity;
  for (const v of data) { if (v < lo) lo = v; if (v > hi) hi = v; }
  const scale = (c === 1) ? 255 / Math.max(hi - lo, 1e-9) : 255;
  for (let y = 0; y < h; y++) for (let x = 0; x < w; x++) {
    const j = (y * w + x) * 4;
    for (let ch = 0; ch < 3; ch++) {
      const v = data[Math.min(ch, c - 1) * h * w + y * w + x];
      im.data[j + ch] = (c === 1) ? (v - lo) * scale : v * scale;
    }
    im.data[j + 3] = 255;
  }
  ctx.putImageData(im, 0, 0);
  document.getElementById(el).src = cv.toDataURL();
}
let imgTensor = null;
async function setInputImage() {
  const f = document.getElementById('imgfile').files[0];
  if (!f) { status('choose an image first'); return; }
  fileToTensor(f, async (nd) => {
    imgTensor = nd;
    const out = await call('set_input_image',
      {img: nd, prompt: document.getElementById('prompt').value});
    tensorToImg(out.depth, 'depthview');
  });
}
async function setForeground() {
  const mf = document.getElementById('maskfile').files[0];
  if (mf) {
    fileToTensor(mf, async (nd) => {
      // reduce rgb mask to single channel server-side via fg_mask contract
      await call('set_foreground', {fg_mask: nd});
    });
  } else {
    await call('set_foreground',
      {fg_prompt: document.getElementById('fgprompt').value});
  }
}
function xform() {
  const g = (id) => parseFloat(document.getElementById(id).value);
  return {rot_angle: g('angle'), rot_axis: [g('ax'), g('ay'), g('az')],
          translation: [g('tx'), g('ty'), g('tz')]};
}
async function previewEdit() {
  const out = await call('preview_edit',
    Object.assign({mode: 'depth'}, xform()));
  tensorToImg(out.preview, 'previewview');
}
async function transformForeground() {
  const out = await call('transform_foreground', xform());
  tensorToImg(out.edited_img, 'editview');
}
</script>
</body>
</html>
"""

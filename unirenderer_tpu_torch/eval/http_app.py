"""Stdlib HTTP frontend of the decomposition app (counterpart of
`unirenderer_tpu/eval/http_app.py`): one HTML page, uploads as base64
JSON, maps back as base64 PNGs, over `eval/app.AppBackend`.  The server
binds to 127.0.0.1 and is single-threaded: one request at a time runs on
the card, in the server's thread, on the default stream.  A request that
raises is answered with a JSON 500 naming the error.

    python -m unirenderer_tpu_torch.eval.http_app
        [--config tiny|small|medium|flagship] [--ckpt DIR|.npz]
        [--vae-ckpt DIR|.npz] [--steps 20] [--ensemble 5] [--port 7860]
        [--device cuda]

Random weights from a generator seeded 0 unless `--ckpt` / `--vae-ckpt`
name flax params: a `.npz` (`core/checkpoint.load_params_npz`) or a
checkpoint directory (`CheckpointManager.restore_params`).  bf16 on the
card, f32 on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

import numpy as np
import torch

PAGE = """<!doctype html>
<html><head><title>uni-renderer</title><style>
 body { font-family: sans-serif; margin: 2em; max-width: 64em; }
 .maps { display: flex; flex-wrap: wrap; gap: 8px; }
 .maps figure { margin: 0; }
 .maps img { width: 160px; image-rendering: pixelated; }
 figcaption { font-size: 0.8em; text-align: center; }
 button { margin: 0.5em 0; }  #status { color: #666; }
</style></head><body>
<h1>Uni-Renderer &mdash; inverse rendering</h1>
<p>input image <input type=file id=img accept=image/*>
   mask (optional) <input type=file id=mask accept=image/*></p>
<p>box prompt x0,y0,x1,y1 (optional) <input type=text id=box size=20>
   point prompt x,y[,x,y...] (optional; negative pair = background click)
   <input type=text id=pt size=20></p>
<p id=prevwrap style="display:none">click the preview to add point
   prompts (shift-click = background):<br>
   <img id=prev style="max-width:320px;cursor:crosshair"></p>
<button onclick=run('decompose')>Decompose</button>
<span id=status></span>
<div class=maps id=out></div>
<h2>Relight</h2>
<p>environment (latlong) <input type=file id=env accept=image/*></p>
<button onclick=run('relight')>Relight</button>
<div class=maps id=relit></div>
<script>
async function b64(id) {
  const f = document.getElementById(id).files[0];
  if (!f) return null;
  const buf = await f.arrayBuffer();
  return btoa(String.fromCharCode(...new Uint8Array(buf)));
}
document.getElementById('img').addEventListener('change', e => {
  const f = e.target.files[0];
  if (!f) return;
  const prev = document.getElementById('prev');
  prev.src = URL.createObjectURL(f);
  document.getElementById('prevwrap').style.display = 'block';
});
document.getElementById('prev').addEventListener('click', e => {
  const img = e.target, r = img.getBoundingClientRect();
  // map display coords to natural-image coords (the backend resizes to
  // its working resolution preserving relative position)
  let x = Math.round((e.clientX - r.left) * img.naturalWidth / r.width);
  let y = Math.round((e.clientY - r.top) * img.naturalHeight / r.height);
  if (e.shiftKey) { x = -x; y = -y; }
  const pt = document.getElementById('pt');
  pt.value = pt.value ? pt.value + ',' + x + ',' + y : x + ',' + y;
});
async function run(mode) {
  const s = document.getElementById('status');
  s.textContent = 'running ' + mode + '…';
  const body = {image: await b64('img'), mask: await b64('mask'),
                box: document.getElementById('box').value || null,
                point: document.getElementById('pt').value || null,
                env: await b64('env')};
  const r = await fetch('/api/' + mode, {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body)});
  const j = await r.json();
  if (j.error) { s.textContent = 'error: ' + j.error; return; }
  s.textContent = 'done';
  const div = document.getElementById(mode === 'relight' ? 'relit' : 'out');
  div.innerHTML = '';
  for (const [name, png] of Object.entries(j.maps)) {
    div.innerHTML += '<figure><img src="data:image/png;base64,' + png +
                     '"><figcaption>' + name + '</figcaption></figure>';
  }
}
</script></body></html>"""


def _decode_image(b64s: Optional[str]) -> Optional[np.ndarray]:
    if not b64s:
        return None
    from PIL import Image
    with Image.open(io.BytesIO(base64.b64decode(b64s))) as img:
        return np.asarray(img.convert("RGB"))


def _encode_png(arr_u8: np.ndarray) -> str:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr_u8, np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def make_handler(backend):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                self.send_error(404)
                return
            self._send(200, PAGE.encode(), "text/html; charset=utf-8")

        def do_POST(self):
            if self.path not in ("/api/decompose", "/api/relight"):
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n))
                image = _decode_image(req.get("image"))
                if image is None:
                    raise ValueError("no input image")
                mask = _decode_image(req.get("mask"))
                box, point = req.get("box"), req.get("point")
                if self.path == "/api/decompose":
                    maps = backend.decompose(image, mask, box, point)
                else:
                    env = _decode_image(req.get("env"))
                    maps = {"relit": backend.relight(image, mask, box, env,
                                                     point_text=point)}
                code, payload = 200, {"maps": {k: _encode_png(v)
                                               for k, v in maps.items()}}
            except Exception as e:     # the server keeps serving: a JSON 500
                traceback.print_exc()
                code, payload = 500, {"error": f"{type(e).__name__}: {e}"}
            self._send(code, json.dumps(payload).encode(),
                       "application/json")

        def log_message(self, fmt, *args):              # quiet
            pass

    return Handler


def load_flat(path: str):
    """flax params ({path: array}) from a `.npz` or a checkpoint
    directory; raises when there is none."""
    from unirenderer_tpu_torch.core.checkpoint import (
        CheckpointManager, load_params_npz,
    )
    flat = (load_params_npz(path)[0] if path.endswith(".npz")
            else CheckpointManager(path).restore_params())
    if flat is None:
        raise FileNotFoundError(f"no restorable checkpoint at {path}")
    return flat


def build_backend(config_name: str, ckpt: Optional[str],
                  vae_ckpt: Optional[str], steps: int, ensemble: int,
                  device="cuda"):
    """An AppBackend over the named preset on `device` (bf16 on the card,
    f32 on the CPU), random weights from a generator seeded 0, then the
    dual-stream and VAE params of `ckpt` / `vae_ckpt`, loaded strictly."""
    from unirenderer_tpu_torch.core import config as cfgmod
    from unirenderer_tpu_torch.eval.app import AppBackend
    from unirenderer_tpu_torch.pipelines import UniRendererPipeline

    cfg = getattr(cfgmod, config_name)()
    dtype = (torch.float32 if torch.device(device).type == "cpu"
             else torch.bfloat16)
    pipe = UniRendererPipeline.create(
        cfg, torch.Generator(device=device).manual_seed(0), device=device,
        dtype=dtype)
    pipe.load_flax(dual=load_flat(ckpt) if ckpt else None,
                   vae=load_flat(vae_ckpt) if vae_ckpt else None)
    return AppBackend(pipe, steps=steps, ensemble=ensemble)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="flagship",
                    choices=("tiny", "small", "medium", "flagship"))
    ap.add_argument("--ckpt")
    ap.add_argument("--vae-ckpt")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ensemble", type=int, default=5)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device",
                    help="default: $UNIRENDER_PLATFORM, else cuda")
    args = ap.parse_args(argv)
    from unirenderer_tpu_torch.utils.runtime import setup_runtime
    args.device = str(setup_runtime(args.device))

    backend = build_backend(args.config, args.ckpt, args.vae_ckpt,
                            args.steps, args.ensemble, args.device)
    srv = HTTPServer(("127.0.0.1", args.port), make_handler(backend))
    print(f"serving on http://127.0.0.1:{srv.server_port}  "
          f"(config={args.config}, steps={args.steps}, "
          f"ensemble={args.ensemble}, device={args.device})", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()

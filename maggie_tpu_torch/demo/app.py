"""The matting demo's model side and its HTTP server on the port (port of
``demo/app.py``).

``inference_image``: mask files (or MaskRCNN, which raises its recipe) ->
the image model -> per-instance green-screen composites. ``inference_video``:
a frame directory and per-frame mask directories, or masks for the first
frame only, which ``FlowPropagator`` carries to every frame -> the video
model over 3-frame windows with overlap 2 (the whole forward on each, the
previous window's middle alpha carried) -> matte frames muxed into one video.

``launch_http`` serves both: ``GET /`` the page, ``POST /image`` (multipart:
``image`` and the ``masks`` files; answers a PNG row of the segmentation and
the composites) and ``POST /video`` (a form naming server-side ``frames``
and ``masks`` dirs and the propagator ``prop``; answers the written paths).
The JAX package's Gradio UI is not ported (the card's host has no
``gradio``). The models run on the card unless ``--device cpu`` is given;
without a GPU that raises.

Usage:
  python -m maggie_tpu_torch.demo.app --weights w.safetensors \\
      [--video-weights wv.safetensors] [--port 7860] [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import os
import tempfile

import numpy as np

from .predict import _read_masks, build, matte, video_windows
from .segmenters import (FlowPropagator, MaskFileSegmenter, MaskRCNNOnnxSegmenter,
                         Sam2Propagator, XMemPropagator, label_map_to_instances)

_STATE: dict = {}


def _image_model(args):
    if "image_model" not in _STATE:
        _STATE["image_model"] = build(args.config or "configs/maggie_image.yaml", args.weights,
                                      video=False, device=getattr(args, "device", None))
    return _STATE["image_model"]


def _video_model(args):
    if "video_model" not in _STATE:
        _STATE["video_model"] = build(args.video_config or "configs/maggie_video.yaml",
                                      args.video_weights or args.weights, video=True,
                                      device=getattr(args, "device", None))
    return _STATE["video_model"]


def _matte_composites(image, alpha: np.ndarray) -> list:
    """Green-screen composites per instance (reference
    ``maggie_predictor.py:70-78``)."""
    from PIL import Image
    img = np.array(image.convert("RGB"))
    green = np.zeros_like(img)
    green[:, :, 1] = 255
    out = []
    for i in range(alpha.shape[0]):
        a = alpha[i][:, :, None]
        out.append(Image.fromarray((img * a + (1 - a) * green).astype(np.uint8)))
    return out


def inference_image(args, image, mask_files: list[str] | None):
    """Returns ``(visualization, composites)`` for one PIL image."""
    seg = MaskFileSegmenter(mask_files) if mask_files else MaskRCNNOnnxSegmenter()
    vis, label_map = seg.segment(image)
    inst_masks = label_map_to_instances(label_map)
    if not inst_masks:
        raise RuntimeError("No person detected!")
    alpha, _ = matte(_image_model(args), [image], [inst_masks])
    return vis, _matte_composites(image, alpha[0, 0])


def _propagated_masks(frames_dir, frame_names, masks_dir, propagator):
    """Per-frame instance-mask lists when ``masks_dir`` covers only the
    first frame: the propagator (``flow``; ``xmem`` and ``sam2`` raise their
    recipes) over the whole sequence once, as the reference's XMem/SAM2 pass
    (``demo/app.py:35-43``)."""
    from PIL import Image
    prop = {"flow": FlowPropagator, "xmem": XMemPropagator, "sam2": Sam2Propagator}[propagator]()
    frames = [Image.open(os.path.join(frames_dir, f)) for f in frame_names]
    mdir0 = (os.path.join(masks_dir, os.path.splitext(frame_names[0])[0]) if masks_dir else "")
    if os.path.isdir(mdir0):
        first = _read_masks(mdir0)
        label = np.zeros_like(first[0], dtype=np.uint8)
        for i, m in enumerate(first):
            label[(m > 127) & (label == 0)] = i + 1
        n = len(first)
    else:  # no masks at all: detect people on the first frame
        _, label = MaskRCNNOnnxSegmenter().segment(frames[0])
        n = int(label.max())
    label_maps = prop.propagate(frames, label)
    return [[((lm == i + 1) * 255).astype(np.uint8) for i in range(n)] for lm in label_maps]


def _mux_video(frame_paths: list[str], out_base: str, fps: int = 8) -> str | None:
    """Mux matte frames into one video file (reference ffmpeg muxing,
    ``demo/app.py:73-78``): the ffmpeg binary when present, else a PIL
    animated GIF. The JAX package's cv2 MJPG AVI writer between the two is
    left out: the port imports no cv2. Returns the written path, or None if
    both fail."""
    import shutil
    import subprocess
    from PIL import Image
    if shutil.which("ffmpeg"):
        out = out_base + ".mp4"
        listing = out_base + "_frames.txt"
        # ffmpeg concat quoting: single-quoted path with embedded quotes
        # escaped as '\''; the demuxer ignores the duration of the LAST
        # listed entry, so the final frame is repeated to honor its period.
        q = lambda p: "'" + p.replace("'", r"'\''") + "'"  # noqa: E731
        with open(listing, "w") as f:
            f.writelines(f"file {q(p)}\nduration {1 / fps}\n" for p in frame_paths)
            f.write(f"file {q(frame_paths[-1])}\n")
        r = subprocess.run(["ffmpeg", "-y", "-f", "concat", "-safe", "0", "-i", listing,
                            "-pix_fmt", "yuv420p", out], capture_output=True)
        if r.returncode == 0:
            return out
    try:
        out = out_base + ".gif"
        ims = [Image.open(p).convert("RGB") for p in frame_paths]
        ims[0].save(out, save_all=True, append_images=ims[1:], duration=int(1000 / fps), loop=0)
        return out
    except Exception:
        return None


def inference_video(args, frames_dir: str, masks_dir: str | None, propagator: str, out_dir: str):
    """Streaming video matting over a frame directory. ``masks_dir`` holds one
    subdir per frame with per-instance PNGs; if it covers only the first
    frame (or is absent: MaskRCNN on frame 0), the propagator fills in the
    rest. Returns ``(frame_paths, video_path)``: one composite grid a frame,
    muxed into one video file."""
    from PIL import Image
    model = _video_model(args)
    frame_names = sorted(os.listdir(frames_dir))
    have_all = bool(masks_dir) and all(
        os.path.isdir(os.path.join(masks_dir, os.path.splitext(f)[0])) for f in frame_names)
    per_frame = (None if have_all else
                 _propagated_masks(frames_dir, frame_names, masks_dir, propagator))
    if per_frame is not None:
        masks_at = per_frame.__getitem__
    else:
        masks_at = lambda t: _read_masks(  # noqa: E731
            os.path.join(masks_dir, os.path.splitext(frame_names[t])[0]))
    os.makedirs(out_dir, exist_ok=True)
    written = []
    windows = video_windows(model, len(frame_names),
                            lambda t: Image.open(os.path.join(frames_dir, frame_names[t])),
                            masks_at)
    for start, frames, alpha, keep in windows:
        for t in keep:
            comp = _matte_composites(frames[t], alpha[0, t])
            path = os.path.join(out_dir, f"{os.path.splitext(frame_names[start + t])[0]}.jpg")
            grid = np.concatenate([np.array(c) for c in comp], axis=1)
            Image.fromarray(grid).save(path)
            written.append(path)
    video = _mux_video(written, os.path.join(out_dir, "matte_video"))
    return written, video


_PAGE = """<!doctype html><title>MaGGIe demo</title>
<style>body{font-family:sans-serif;max-width:760px;margin:2em auto}
.tab{border:1px solid #ccc;padding:1em;margin:1em 0}</style>
<h2>MaGGIe: Mask Guided Gradual Human Instance Matting</h2>
<div class=tab><h3>image</h3>
<form method=post action=/image enctype=multipart/form-data>
Image: <input type=file name=image required><br>
Instance masks (optional; else MaskRCNN backend):
<input type=file name=masks multiple><br>
<input type=submit value="Run matting"></form></div>
<div class=tab><h3>video</h3>
<form method=post action=/video>
Frames dir: <input name=frames size=40><br>
Masks dir (optional): <input name=masks size=40><br>
Propagator: <select name=prop><option>flow</option><option>xmem</option><option>sam2</option></select>
<input type=submit value="Run matting"></form></div>"""


def launch_http(args, ready=None):
    """Serve on ``args.port`` (0: a free port) until shut down. ``ready``,
    when given, is called with the server before it serves (a caller on
    another thread learns the port from ``server_address`` and stops it
    with ``shutdown()``)."""
    import email
    import email.policy
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="text/html"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._send(200, _PAGE)

        def _parts(self):
            length = int(self.headers["Content-Length"])
            raw = self.rfile.read(length)
            msg = email.message_from_bytes(
                b"Content-Type: " + self.headers["Content-Type"].encode() + b"\r\n\r\n" + raw,
                policy=email.policy.default)
            return list(msg.iter_parts())

        def do_POST(self):
            try:
                if self.path == "/image":
                    image, mask_paths = None, []
                    tmp = tempfile.mkdtemp()
                    for p in self._parts():
                        payload = p.get_payload(decode=True)
                        if p.get_param("name", header="content-disposition") == "image":
                            image = Image.open(io.BytesIO(payload))
                        elif payload:
                            fp = os.path.join(tmp, p.get_filename() or "m.png")
                            with open(fp, "wb") as f:
                                f.write(payload)
                            mask_paths.append(fp)
                    vis, mattes = inference_image(args, image, mask_paths or None)
                    row = np.concatenate([np.array(vis.convert("RGB"))]
                                         + [np.array(m) for m in mattes], axis=1)
                    buf = io.BytesIO()
                    Image.fromarray(row).save(buf, "PNG")
                    self._send(200, buf.getvalue(), "image/png")
                elif self.path == "/video":
                    q = parse_qs(self.rfile.read(int(self.headers["Content-Length"])).decode())
                    files, video = inference_video(
                        args, q["frames"][0], (q.get("masks") or [None])[0] or None,
                        (q.get("prop") or ["flow"])[0], tempfile.mkdtemp())
                    self._send(200, "<br>".join(([f"video: {video}"] if video else []) + files))
                else:
                    self._send(404, "not found")
            except Exception as e:  # surface recipe errors in the browser
                self._send(500, f"<pre>{e}</pre>")

        def log_message(self, *a):
            pass

    srv = HTTPServer(("0.0.0.0", args.port), Handler)
    print(f"maggie_tpu_torch demo on http://localhost:{srv.server_address[1]}", flush=True)
    if ready is not None:
        ready(srv)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="")
    ap.add_argument("--video-weights", default="")
    ap.add_argument("--config", default=None)
    ap.add_argument("--video-config", default=None)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    resolve_device(args.device)   # refuse a host without a GPU before serving
    launch_http(args)


if __name__ == "__main__":
    main()

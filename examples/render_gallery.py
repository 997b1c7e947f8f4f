"""Converged visual goldens: render every demo scene and compare against
the reference's capture gallery.

The reference's regression oracle is 26 screenshots in
/root/reference/captures (README.md "Ensemble des scenes avec une light
intensity a 0.4 et un indice de refraction de 1"): N-04-1.png is the Nth
scene of the Q..I keyboard carousel at light 0.4 / IOR 1. This script
renders the same 8 scenes (plus the new mesh fixtures) at 800x625 (the
capture viewport's 1.28 aspect) with those settings, using the
NCC-fitted poses from examples/fit_poses.py, writes PNGs to
examples/captures/, and records masked luminance comparisons (64x50
grid; window chrome cropped and the capture's ImGui panel excluded)
to examples/captures/gallery.json. With fitted poses the NCC column is
a real geometry check — 0.98/0.97 on the Cornell boxes — gated by
tests/test_gallery_goldens.py.

    python examples/render_gallery.py [--spp 256] [--quick]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# scene key order Q..I of the reference carousel (montecarlo.cpp:249-290)
REF_CAPTURE_ORDER = [
    "box_diffuse", "box_balls", "menger", "box_no_top",
    "materials", "4boules", "menger_lights", "colonnes",
]
REF_DIR = "/root/reference/captures"

# per-scene orbit poses approximating the reference captures' trackball
# state (the default head-on pose puts a column in front of the colonnes
# camera; the capture looks down the colonnade). Overridden by
# captures/poses.json when present — the NCC-fit poses produced by
# examples/fit_poses.py, which make the gallery's luma_ncc a meaningful
# geometry regression check instead of pose noise.
POSES = {
    "colonnes": dict(yaw=10.0, pitch=-5.0, zoom=0.6),
}


def load_poses(outdir):
    path = os.path.join(outdir, "poses.json")
    poses = dict(POSES)
    try:
        with open(path) as f:
            fit = json.load(f)
        for name, p in fit.items():
            pose = {k: p[k] for k in ("yaw", "pitch", "zoom", "roll",
                                      "fov") if k in p}
            if "center" in p:
                pose["center"] = tuple(p["center"])
            poses[name] = pose
    except (OSError, ValueError, KeyError):
        pass
    return poses


def read_png(path):
    """Minimal PNG reader (8-bit RGB/RGBA, non-interlaced)."""
    import struct
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, w = 8, None
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 8 - 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype in (2, 6), (depth, ctype)
            nch = 3 if ctype == 2 else 4
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * nch + 1
    out = np.empty((h, w, nch), np.uint8)
    prev = np.zeros(w * nch, np.uint8)
    for y in range(h):
        filt = raw[y * stride]
        line = np.frombuffer(raw[y * stride + 1:(y + 1) * stride],
                             np.uint8).astype(np.int32)
        if filt == 0:
            rec = line
        elif filt == 1:
            rec = line.copy()
            for i in range(nch, len(rec)):
                rec[i] = (rec[i] + rec[i - nch]) & 0xFF
        elif filt == 2:
            rec = (line + prev) & 0xFF
        elif filt == 3:
            rec = line.copy()
            for i in range(len(rec)):
                a = rec[i - nch] if i >= nch else 0
                rec[i] = (rec[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif filt == 4:
            rec = line.copy()
            for i in range(len(rec)):
                a = int(rec[i - nch]) if i >= nch else 0
                b = int(prev[i])
                c = int(prev[i - nch]) if i >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (
                    b if pb <= pc else c)
                rec[i] = (rec[i] + pred) & 0xFF
        else:
            raise ValueError(f"filter {filt}")
        prev = rec.astype(np.uint8)
        out[y] = prev.reshape(w, nch)
    return out[..., :3].astype(np.float32) / 255.0


VIEWPORT = (1280, 1000)    # the app's window size (montecarlo.cpp:801)
# ImGui settings panel region to EXCLUDE from comparisons, as fractions
# of the viewport (the captures are full-window screenshots with the
# panel overlaid top-left — comparing under it measures the panel, not
# the render)
PANEL_FRAC = (0.56, 0.48)


def ref_viewport(img):
    """Crop the window chrome from a reference screenshot: the GL
    viewport is 1280x1000, 10 px in from the bottom/left window border
    (title bar on top takes the rest)."""
    h, w = img.shape[:2]
    vw, vh = VIEWPORT
    if h <= vh or w <= vw:
        return img
    x0 = (w - vw) // 2
    y0 = h - 10 - vh
    return img[y0:y0 + vh, x0:x0 + vw]


def panel_mask(gh=50, gw=64):
    m = np.ones((gh, gw), bool)
    m[:int(PANEL_FRAC[1] * gh), :int(PANEL_FRAC[0] * gw)] = False
    return m


def masked_ncc(a, b, m=None):
    if m is not None:
        a, b = a[m], b[m]
    a = a - a.mean()
    b = b - b.mean()
    d = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / d) if d > 0 else 0.0


def downsample_luma(img, gw=64, gh=50):
    """Mean luminance on a gw x gh grid (shape-normalizing)."""
    h, w = img.shape[:2]
    lum = img @ np.array([0.299, 0.587, 0.114], np.float32)
    ys = (np.arange(gh + 1) * h) // gh
    xs = (np.arange(gw + 1) * w) // gw
    out = np.empty((gh, gw), np.float32)
    for j in range(gh):
        for i in range(gw):
            out[j, i] = lum[ys[j]:ys[j + 1], xs[i]:xs[i + 1]].mean()
    return out


def ncc(a, b):
    a = a - a.mean()
    b = b - b.mean()
    d = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / d) if d > 0 else 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--light", type=float, default=0.4)
    ap.add_argument("--ior", type=float, default=1.0)
    ap.add_argument("--bounces", type=int, default=9)
    ap.add_argument("--quick", action="store_true",
                    help="200x150 @ 16 spp smoke mode")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "captures"))
    args = ap.parse_args()

    import jax
    from montecarlo_pathtracing_tpu.utils.profiling import (
        enable_compilation_cache)
    enable_compilation_cache()
    from montecarlo_pathtracing_tpu.scene import scenes
    from montecarlo_pathtracing_tpu.scene.device import compile_scene
    from montecarlo_pathtracing_tpu.render.renderer import (
        RenderConfig, Renderer)

    # 800x625 matches the capture viewport's 1.28 aspect (1280x1000)
    w, h, spp = (200, 150, 16) if args.quick else (800, 625, args.spp)
    os.makedirs(args.out, exist_ok=True)
    report = {"config": {"width": w, "height": h, "spp": spp,
                         "light": args.light, "ior": args.ior,
                         "bounces": args.bounces,
                         "platform": jax.devices()[0].platform},
              "scenes": {}}

    names = args.scenes or list(scenes.SCENES)
    poses = load_poses(args.out)
    from montecarlo_pathtracing_tpu.render.camera import default_rt_camera
    from montecarlo_pathtracing_tpu.utils import transforms as tf
    for name in names:
        t0 = time.perf_counter()
        dev = compile_scene(scenes.build(name, light_intensity=args.light))
        pose = dict(poses.get(name, {}))
        roll = pose.pop("roll", 0.0)
        fov = pose.pop("fov", 1.0)
        proj, view = default_rt_camera(w, h, **pose)
        if fov != 1.0:
            # focal-length scale (<1 widens): the reference captures were
            # taken at window sizes/aspects that change the GL projection,
            # which orbit zoom (a radius scale) cannot express
            proj = proj.copy()
            proj[0, 0] *= fov
            proj[1, 1] *= fov
        if roll:
            # screen-plane rotation (trackball edge-drag Z-rotate)
            view = tf.rotate_z(roll).astype(np.float32) @ view
        r = Renderer(dev, RenderConfig(
            width=w, height=h, nb_bounces=args.bounces,
            refract_ind=args.ior, tile_rays=1 << 17),
            proj, view)
        img = r.run(spp)
        png = os.path.join(args.out, f"{name}.png")
        r.save_png(png)
        entry = {
            "png": os.path.basename(png),
            "pose": poses.get(name, {}),
            "seconds": round(time.perf_counter() - t0, 1),
            "mean": round(float(img.mean()), 5),
            "p99": round(float(np.quantile(img, 0.99)), 4),
            "nonzero_frac": round(float((img.sum(-1) > 0).mean()), 4),
        }
        if name in REF_CAPTURE_ORDER:
            refp = os.path.join(
                REF_DIR, f"{REF_CAPTURE_ORDER.index(name) + 1}-04-1.png")
            if os.path.exists(refp):
                ref = ref_viewport(read_png(refp))   # drop window chrome
                ours = np.clip(img[::-1], 0.0, 1.0)  # row0=bottom -> top
                ga = downsample_luma(ours)
                gb = downsample_luma(ref)
                m = panel_mask()                     # exclude the ImGui UI
                entry["ref_capture"] = os.path.basename(refp)
                entry["ref_luma_mean"] = round(float(gb[m].mean()), 4)
                entry["our_luma_mean"] = round(float(ga[m].mean()), 4)
                entry["luma_ncc"] = round(masked_ncc(ga, gb, m), 3)
        report["scenes"][name] = entry
        print(name, entry, flush=True)

    # merge partial runs (--scenes ...) into an existing gallery.json
    gpath = os.path.join(args.out, "gallery.json")
    if args.scenes and os.path.exists(gpath):
        with open(gpath) as f:
            old = json.load(f)
        old["scenes"].update(report["scenes"])
        old["config"] = report["config"]
        report = old
    with open(gpath, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", gpath)


if __name__ == "__main__":
    main()

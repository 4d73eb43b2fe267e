"""Writes the committed JPEG test files of tests/data/jpeg/ with PIL, and
their imageio.v2.imread decodes beside them: the small ones' arrays in
decodes.npz, the frame's SHA-256 and per-channel sums in decodes.json (its
array would outweigh the JPEGs):

- frame_1000x1000_420.jpg: a 1000² RGB frame, 4:2:0, quality 90, the size
  and sampling of the dataset's frames;
- mask_224x224_gray.jpg: a 1-component silhouette mask with the valid-flag
  pixel set, quality 95;
- odd_157x93_422_rst.jpg: an odd-size RGB image, 4:2:2, quality 75, a
  restart marker every 3 MCUs.

    python tests/make_jpeg_fixtures.py

tests/test_torch_jpeg.py and chip_smoke.py's jpeg_check read them. The
images are drawn from a seed; rerunning rewrites the same files for the
same PIL/libjpeg build.
"""

import hashlib
import io
import json
import os

import imageio.v2 as imageio
import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")


def scene(h: int, w: int, seed: int, noise: float) -> np.ndarray:
    """A smooth RGB scene: gradients, a few discs and Gaussian texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([80 + 100 * x / w, 60 + 120 * y / h, 140 + 60 * np.sin((x + y) / 90)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.05, 0.25) * min(h, w)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(scale=noise, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def mask(h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    m = (((y - h * 0.55) / (h * 0.35)) ** 2 + ((x - w * 0.5) / (w * 0.18)) ** 2 < 1)
    m |= (((y - h * 0.18) / (h * 0.1)) ** 2 + ((x - w * 0.5) / (w * 0.08)) ** 2 < 1)
    out = (m * 255).astype(np.uint8)
    out[0, 0] = 255  # the valid-flag marker
    return out


FILES = {
    "frame_1000x1000_420.jpg": (lambda: scene(1000, 1000, 0, 0.0),
                                dict(quality=90, subsampling=2)),
    "mask_224x224_gray.jpg": (lambda: mask(224, 224), dict(quality=95)),
    "odd_157x93_422_rst.jpg": (lambda: scene(93, 157, 1, 4.0),
                               dict(quality=75, subsampling=1, restart_marker_blocks=3)),
}


def main():
    os.makedirs(OUT, exist_ok=True)
    decodes = {}
    for name, (make, options) in FILES.items():
        buf = io.BytesIO()
        Image.fromarray(make()).save(buf, "JPEG", **options)
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(buf.getvalue())
        decodes[os.path.splitext(name)[0]] = imageio.imread(os.path.join(OUT, name))
    frame = decodes.pop("frame_1000x1000_420")
    with open(os.path.join(OUT, "decodes.json"), "w") as f:
        json.dump({"frame_1000x1000_420": {
            "shape": list(frame.shape), "sha256": hashlib.sha256(frame.tobytes()).hexdigest(),
            "channel_sums": frame.sum(axis=(0, 1), dtype=np.int64).tolist()}}, f, indent=1)
    np.savez_compressed(os.path.join(OUT, "decodes.npz"), **decodes)


if __name__ == "__main__":
    main()

"""Image I/O and normalization.

Reference parity:
- prepare_img: float [0,1] RGB HWC -> x*255 - ImageNet mean, neutral std
  (reference neural_style_transfer.py:22-23, :375-383). The reference
  produces NCHW torch tensors; here the public layout is NHWC (as in the
  JAX package) and batching is explicit.
- unprepare_img: add the mean back, /255, float32, NO clipping — clipping
  happens at encode time (reference neural_style_transfer.py:386-393,
  lab.py:152, tlbot.py:61).
- load_image: read, BGR->RGB, float32, /255 (reference lab.py:115-123).
"""

from __future__ import annotations

import os

import numpy as np

IMAGENET_MEAN_255 = np.array([123.675, 116.28, 103.53], dtype=np.float32)


def load_image(img_path: str) -> np.ndarray:
    """Load an image file as float32 RGB HWC in [0, 1]."""
    if not os.path.exists(img_path):
        raise Exception(f"Path does not exist: {img_path}")
    import cv2

    img = cv2.imread(img_path)
    if img is None:
        raise Exception(f"Could not decode image: {img_path}")
    img = img[:, :, ::-1]  # BGR -> RGB
    return np.ascontiguousarray(img, dtype=np.float32) / 255.0


def decode_image(data: bytes) -> np.ndarray:
    """Decode an in-memory image (e.g. a Telegram download) to RGB [0,1]."""
    import cv2

    buf = np.frombuffer(data, np.uint8)
    img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    if img is None:
        raise Exception("Could not decode image bytes")
    img = img[:, :, ::-1]
    return np.ascontiguousarray(img, dtype=np.float32) / 255.0


def prepare_img(img: np.ndarray) -> np.ndarray:
    """[0,1] RGB HWC -> preprocessed NHWC float32 batch of 1."""
    out = img.astype(np.float32) * 255.0 - IMAGENET_MEAN_255
    return out[None, ...]


def unprepare_img(img) -> np.ndarray:
    """Preprocessed NHWC (batch of 1) -> [0,1]-ish RGB HWC (unclipped)."""
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    return (arr + IMAGENET_MEAN_255) / 255.0


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """[0,1] RGB HWC float -> JPEG bytes (clip at encode time, ref lab.py:151-156)."""
    import cv2

    u8 = np.clip(img * 255.0, 0, 255).astype("uint8")
    ok, buf = cv2.imencode(".jpg", u8[:, :, ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    if not ok:
        raise Exception("JPEG encoding failed")
    return buf.tobytes()


def save_image(img: np.ndarray, path: str, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality=quality))

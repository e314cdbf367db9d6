"""Dataset readers: directories of images, TUM and EUROC layouts.

Counterpart of `uwslam_tpu.io.dataset` (`list_images`, `Sequence`,
`open_directory`, `open_tum`, `open_euroc`, `FramePrefetcher`,
`DeviceFramePrefetcher`), after
uw-slam's dataset plumbing: directory scan, sort and the >= 15 image check
(src/System.cpp:290-350), TUM's timestamped names, EUROC's
mav0/cam0/data/<ns>.png.

Decoding tries, in order: the repository's native decoder (`io.native`),
PIL, and a small numpy reader of binary PGM (P5), so a machine with neither
libpng nor PIL still reads PGM frames. Anything else then raises.
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass

import numpy as np

from . import native

MIN_IMAGES = 15  # uw-slam src/System.cpp:347 requires >= 15 images


def _read_token(data: bytes, pos: int) -> tuple[bytes, int]:
    """Next whitespace-separated header token of a PNM file ('#' comments
    run to the end of the line)."""
    while pos < len(data):
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
        elif data[pos:pos + 1].isspace():
            pos += 1
        else:
            break
    start = pos
    while pos < len(data) and not data[pos:pos + 1].isspace():
        pos += 1
    return data[start:pos], pos


def read_pgm(path: str) -> np.ndarray:
    """Binary PGM (P5, 8- or 16-bit big-endian) -> (H, W) float32."""
    with open(path, "rb") as f:
        data = f.read()
    magic, pos = _read_token(data, 0)
    if magic != b"P5":
        raise IOError(f"not a binary PGM (P5): {path}")
    fields = []
    for _ in range(3):
        tok, pos = _read_token(data, pos)
        fields.append(int(tok))
    width, height, maxval = fields
    pos += 1                      # the single whitespace after maxval
    dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    n = width * height
    pixels = np.frombuffer(data, dtype=dtype, count=n, offset=pos)
    return pixels.reshape(height, width).astype(np.float32)


def _decode_image(path: str) -> np.ndarray:
    """Decode to gray float32 (16-bit PNG keeps raw values)."""
    if native.available():
        try:
            return native.decode(path)
        except IOError:
            pass          # an exotic format: try the next decoder
    try:
        from PIL import Image
    except ImportError:
        if os.path.splitext(path)[1].lower() == ".pgm":
            return read_pgm(path)
        raise IOError(
            f"cannot decode {path}: the native decoder and PIL are unavailable "
            "and only binary PGM is read without them"
        ) from None
    with Image.open(path) as im:
        if im.mode in ("I;16", "I"):
            return np.asarray(im, dtype=np.float32)
        return np.asarray(im.convert("L"), dtype=np.float32)


def list_images(directory: str, exts=(".png", ".jpg", ".jpeg", ".pgm")) -> list[str]:
    """Image paths sorted numerically by stem when every stem is a number
    (TUM and EUROC timestamps; "99.png" before "100.png"), else by name.
    Raises ValueError below 15 images."""
    names = [n for n in os.listdir(directory) if os.path.splitext(n)[1].lower() in exts]
    try:
        names.sort(key=lambda n: float(os.path.splitext(n)[0]))
    except ValueError:
        names.sort()
    paths = [os.path.join(directory, n) for n in names]
    if len(paths) < MIN_IMAGES:
        raise ValueError(
            f"insufficient images in {directory}: {len(paths)} < {MIN_IMAGES}"
        )
    return paths


@dataclass
class Sequence:
    """A monocular (optionally + depth) image sequence."""

    image_paths: list[str]
    depth_paths: list[str] | None = None
    timestamps: np.ndarray | None = None  # (N,) float64 seconds
    name: str = ""

    def __len__(self):
        return len(self.image_paths)

    def load(self, i: int) -> tuple[np.ndarray, np.ndarray | None]:
        img = _decode_image(self.image_paths[i])
        depth = (
            _decode_image(self.depth_paths[i]) if self.depth_paths is not None else None
        )
        return img, depth


def _timestamp(path: str) -> float:
    stem = os.path.splitext(os.path.basename(path))[0]
    try:
        return float(stem)
    except ValueError:
        return 0.0


def open_tum(rgb_dir: str, depth_dir: str | None = None, start: int = 0) -> Sequence:
    """TUM layout: rgb/<timestamp>.png [+ depth/<timestamp>.png], depth
    associated to each image by the nearest timestamp."""
    imgs = list_images(rgb_dir)[start:]
    depths = None
    if depth_dir is not None:
        dpaths = list_images(depth_dir)
        dts = np.array([_timestamp(p) for p in dpaths])
        depths = [dpaths[int(np.abs(dts - _timestamp(p)).argmin())] for p in imgs]
    ts = np.array([_timestamp(p) for p in imgs])
    return Sequence(imgs, depths, ts, name="tum")


def open_euroc(mav_dir: str, cam: str = "cam0", start: int = 0) -> Sequence:
    """EUROC layout: <mav_dir>/<cam>/data/<ns>.png; timestamps in seconds."""
    imgs = list_images(os.path.join(mav_dir, cam, "data"))[start:]
    ts = np.array([_timestamp(p) * 1e-9 for p in imgs])
    return Sequence(imgs, None, ts, name="euroc")


def open_directory(directory: str, start: int = 0) -> Sequence:
    """A bare directory of images; timestamps from numeric names when they
    increase strictly, else None (frame indices are used downstream)."""
    imgs = list_images(directory)[start:]
    ts = np.array([_timestamp(p) for p in imgs])
    if not (np.diff(ts) > 0).all():
        ts = None
    return Sequence(imgs, None, ts, name=os.path.basename(directory))


class FramePrefetcher:
    """Decodes frames on a background thread, `lookahead` ahead of the
    consumer. Iterate for (index, (image, depth)); `close()` stops and
    joins the thread. A decode error is raised in the consumer."""

    def __init__(self, seq: Sequence, lookahead: int = 4):
        self._seq = seq
        self._q: queue.Queue = queue.Queue(maxsize=lookahead)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for i in range(len(self._seq)):
                if not self._put((i, self._seq.load(i))):
                    return
        except Exception as exc:     # handed to the consumer, which raises it
            self._put(exc)
            return
        self._put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)


def as_uint8_if_exact(img: np.ndarray) -> np.ndarray:
    """An 8-bit frame decoded to f32 goes back to uint8 (a quarter of the
    bytes to upload) when that loses nothing: every value integral and in
    [0, 255]. Anything else (16-bit frames, negative or fractional values)
    is returned as it is."""
    if img.dtype == np.uint8:
        return img
    if img.size and img.min() >= 0.0 and img.max() <= 255.0 and (img == np.rint(img)).all():
        return img.astype(np.uint8)
    return img


class DeviceFramePrefetcher:
    """Wraps `FramePrefetcher` and uploads each frame to `device` one frame
    ahead of the consumer, so the host-to-device copy of frame i+1 overlaps
    the device work of frame i. On a CUDA device the frame goes through
    pinned host memory on a side stream, with an event that the consumer's
    current stream waits on before the frame is handed over. 8-bit frames
    travel as uint8 (`as_uint8_if_exact`); the consumer converts on the
    device. Yields (index, (frame tensor on the device, None)); a frame
    with a depth image passes through un-uploaded as (index, (image,
    depth)): the RGB-D path is not pipelined."""

    def __init__(self, seq: Sequence, device, lookahead: int = 4):
        import torch

        self._inner = FramePrefetcher(seq, lookahead=lookahead)
        self._device = torch.device(device)
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None

    def _upload(self, img: np.ndarray):
        """-> (tensor on the device, event or None)."""
        import torch

        host = torch.from_numpy(np.ascontiguousarray(as_uint8_if_exact(img)))
        if self._stream is None:
            return host.to(self._device), None
        with torch.cuda.stream(self._stream):
            dev = host.pin_memory().to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return dev, event

    def _hand_over(self, held):
        import torch

        i, dev, event = held
        if event is not None:
            torch.cuda.current_stream(self._device).wait_event(event)
            dev.record_stream(torch.cuda.current_stream(self._device))
        return i, (dev, None)

    def __iter__(self):
        held = None  # (index, device tensor, event)
        for i, (img, depth) in self._inner:
            if depth is not None:
                if held is not None:
                    yield self._hand_over(held)
                    held = None
                yield i, (img, depth)
                continue
            upload = self._upload(img)
            if held is not None:
                yield self._hand_over(held)
            held = (i, *upload)
        if held is not None:
            yield self._hand_over(held)

    def close(self):
        self._inner.close()

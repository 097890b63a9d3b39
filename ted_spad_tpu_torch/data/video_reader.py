"""Host video decode for the port (counterpart of ted_spad_tpu/data/video_reader.py,
RGB and planar YUV420 reads): a ctypes binding of the native C++/FFmpeg decoder in
native/videodec/libvideodec.so (the GIL is released during decode, so a Python
thread pool decodes several videos at once), and ``SyntheticVideoReader`` for
procedural ``synthetic://`` videos that need no media files.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import numpy as np

_LIB_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native", "videodec")
_LIB_PATH = os.path.abspath(os.path.join(_LIB_DIR, "libvideodec.so"))
_lib = None
_lib_error: str | None = None


def _load_library():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        # Always run make (a no-op when the .so is fresh), under an exclusive lock:
        # decode pool threads may race here and make writes the .so non-atomically.
        try:
            with open(os.path.join(os.path.dirname(_LIB_PATH), ".build.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                subprocess.run(
                    ["make", "-C", os.path.dirname(_LIB_PATH)], check=True, capture_output=True
                )
        except (OSError, subprocess.CalledProcessError):
            if not os.path.exists(_LIB_PATH):
                raise  # nothing to load and no way to build it
            # No build toolchain, but a prebuilt .so exists: load it as it is.
        lib = ctypes.CDLL(_LIB_PATH)
        lib.vd_open_opts.restype = ctypes.c_void_p
        lib.vd_open_opts.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
        lib.vd_close.argtypes = [ctypes.c_void_p]
        lib.vd_num_frames.restype = ctypes.c_int64
        lib.vd_num_frames.argtypes = [ctypes.c_void_p]
        lib.vd_fps.restype = ctypes.c_double
        lib.vd_fps.argtypes = [ctypes.c_void_p]
        lib.vd_width.restype = ctypes.c_int
        lib.vd_width.argtypes = [ctypes.c_void_p]
        lib.vd_height.restype = ctypes.c_int
        lib.vd_height.argtypes = [ctypes.c_void_p]
        lib.vd_read_indices.restype = ctypes.c_int64
        lib.vd_read_indices.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        lib.vd_read_strided.restype = ctypes.c_int64
        lib.vd_read_strided.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        lib.vd_last_error.restype = ctypes.c_char_p
        for name in ("vd_native_width", "vd_native_height", "vd_full_range", "vd_colorspace"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.vd_read_strided_yuv.restype = ctypes.c_int64
        lib.vd_read_strided_yuv.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int64] + [ctypes.POINTER(ctypes.c_uint8)] * 3
        _lib = lib
    except (OSError, subprocess.CalledProcessError, AttributeError) as e:
        _lib_error = str(e)
        _lib = None
    return _lib


class VideoReader:
    """Strided RGB24 (or planar YUV420) frame reader over one video file.

    ``threads``: decoder thread_count (0 = libavcodec auto). Decode is bit-exact:
    the decoder's in-loop deblocking filter stays on."""

    def __init__(self, path: str, out_w: int = 0, out_h: int = 0, threads: int = 0):
        lib = _load_library()
        if lib is None:
            raise RuntimeError(f"native videodec unavailable: {_lib_error}")
        self._lib = lib
        self._h = lib.vd_open_opts(path.encode(), out_w, out_h, threads, 0)
        if not self._h:
            raise IOError(f"cannot open {path}: {lib.vd_last_error().decode()}")
        self.path = path
        self.width = lib.vd_width(self._h)
        self.height = lib.vd_height(self._h)
        self.fps = lib.vd_fps(self._h)
        self._num_frames = int(lib.vd_num_frames(self._h))
        if self._num_frames < 0:
            lib.vd_close(self._h)
            self._h = None
            raise IOError(f"{path}: frame count unknown (no nb_frames and no usable duration)")

    def _handle(self):
        if not self._h:
            raise IOError(f"VideoReader for {self.path} is closed")
        return self._h

    def __len__(self) -> int:
        return self._num_frames

    @property
    def colorspace(self) -> int:
        """The stream's colorspace family: 601, 709, 0 (untagged: swscale assumes 601) or
        -1 (another, e.g. BT.2020, which the YUV ingest path refuses)."""
        return int(self._lib.vd_colorspace(self._handle()))

    def _raise_or_pad(self, got: int, n: int, planes, fills) -> None:
        """``got < 0``: the native layer reported a decode FAILURE, so raise (the
        corrupt-video tolerance skips the file). ``got < n``: benign EOF (estimated
        frame counts overshoot): pad each plane with its last delivered frame, or its
        fill value when none was delivered."""
        if got < 0:
            raise IOError(f"read failed for {self.path}: {self._lib.vd_last_error().decode()}")
        if got < n:
            for out, fill in zip(planes, fills):
                if got == 0:
                    out[:] = fill
                else:
                    out[got:] = out[got - 1]

    def read_strided(self, start: int, n: int, stride: int) -> np.ndarray:
        """DALI-style sequence read: n frames at ``start + i*stride`` (dali_extraction.py:72)."""
        out = np.empty((n, self.height, self.width, 3), dtype=np.uint8)
        got = self._lib.vd_read_strided(
            self._handle(), start, n, stride, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        self._raise_or_pad(got, n, (out,), (0,))
        return out

    def get_batch(self, indices) -> np.ndarray:
        """decord ``VideoReader.get_batch`` semantics (ucf101_dl.py:68, 91): the frames
        at ``indices`` in the requested order -> (n, H, W, 3) uint8. The palindrome
        completion of short clips asks for non-monotonic lists, so each distinct frame
        is decoded once, in ascending order (the decoder seeks forward), and the
        frames are gathered back into request order."""
        req = np.asarray([int(i) for i in indices], dtype=np.int64)
        uniq = np.unique(req)
        dec = np.empty((len(uniq), self.height, self.width, 3), dtype=np.uint8)
        got = self._lib.vd_read_indices(
            self._handle(), uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(uniq),
            dec.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        self._raise_or_pad(got, len(uniq), (dec,), (0,))
        return dec[np.searchsorted(uniq, req)]

    def read_strided_yuv(self, start: int, n: int, stride: int):
        """Planar read of the same frames: ``(y (n, H, W), u (n, H/2, W/2), v (n, H/2,
        W/2), full_range)`` uint8 at the stream's native resolution, 1.5 bytes per pixel
        and no host colour conversion. Short reads at the end pad with the last frame
        (with black, Y 0 and U = V = 128, when none was read)."""
        h = self._handle()
        nh, nw = self._lib.vd_native_height(h), self._lib.vd_native_width(h)
        y = np.empty((n, nh, nw), np.uint8)
        u = np.empty((n, nh // 2, nw // 2), np.uint8)
        v = np.empty((n, nh // 2, nw // 2), np.uint8)
        ptr = ctypes.POINTER(ctypes.c_uint8)
        got = self._lib.vd_read_strided_yuv(h, start, n, stride, y.ctypes.data_as(ptr),
                                            u.ctypes.data_as(ptr), v.ctypes.data_as(ptr))
        self._raise_or_pad(got, n, (y, u, v), (0, 128, 128))
        return y, u, v, bool(self._lib.vd_full_range(h))

    def close(self):
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- never raise from a finalizer
            pass


class SyntheticVideoReader:
    """Deterministic procedural video: frame ``i`` is a pattern keyed by (seed, i).
    ``seed // 1000`` selects a stable visual structure (stripe frequency, motion
    direction), ``seed % 1000`` a per-video phase."""

    def __init__(self, num_frames: int = 300, height: int = 240, width: int = 320, seed: int = 0,
                 fps: float = 30.0):
        self._n = num_frames
        self.height = height
        self.width = width
        self.fps = fps
        self.seed = seed

    def _frame(self, i: int) -> np.ndarray:
        yy, xx = np.mgrid[0 : self.height, 0 : self.width]
        cls = self.seed // 1000
        noise = self.seed % 1000
        freq = 1 + (cls % 5)
        direction = 1 if cls % 2 == 0 else -1
        phase = (noise * 13 + direction * i * 6) % 256
        r = (xx * freq * 255 // max(self.width - 1, 1) + phase) % 256
        g = (yy * freq * 255 // max(self.height - 1, 1) + 2 * phase) % 256
        b = np.full_like(r, (i * 7 * direction + noise) % 256)
        return np.stack([r, g, b], axis=-1).astype(np.uint8)

    def __len__(self) -> int:
        return self._n

    colorspace = 601  # the emulated planar encode below is BT.601

    def get_batch(self, indices) -> np.ndarray:
        """The frames at ``indices`` in the requested order; past-EOF indices clamp to
        the last frame, as the native reader pads."""
        return np.stack([self._frame(min(int(i), self._n - 1)) for i in indices])

    def read_strided(self, start: int, n: int, stride: int) -> np.ndarray:
        return self.get_batch([start + i * stride for i in range(n)])

    def read_strided_yuv(self, start: int, n: int, stride: int):
        """Planar read emulated from the RGB frames: a BT.601 limited-range encode with
        2x2 box-averaged chroma, as the JAX package's synthetic reader does."""
        rgb = self.read_strided(start, n, stride).astype(np.float32)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
        u = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
        v = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0

        def sub(p):
            h2, w2 = p.shape[-2] // 2, p.shape[-1] // 2
            return p[..., : h2 * 2, : w2 * 2].reshape(p.shape[0], h2, 2, w2, 2).mean((2, 4))

        def to_u8(p):
            return np.clip(np.round(p), 0, 255).astype(np.uint8)

        return to_u8(y), to_u8(sub(u)), to_u8(sub(v)), False

    def close(self):
        pass


def open_video(path: str, out_w: int = 0, out_h: int = 0, threads: int = 0):
    """A real video through the native decoder, or a procedural one for
    ``synthetic://n=N,h=H,w=W,seed=S`` uris (``threads`` then unused)."""
    if path.startswith("synthetic://"):
        kv = dict(part.split("=") for part in path[len("synthetic://") :].split(",") if part)
        return SyntheticVideoReader(
            num_frames=int(kv.get("n", 300)),
            height=int(kv.get("h", 240)),
            width=int(kv.get("w", 320)),
            seed=int(kv.get("seed", 0)),
        )
    return VideoReader(path, out_w, out_h, threads=threads)

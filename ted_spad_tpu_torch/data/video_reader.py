"""Host video decode and encode for the port (counterpart of
ted_spad_tpu/data/video_reader.py): a ctypes binding of the port's C++/FFmpeg layer,
csrc/videodec.cpp -- RGB and planar YUV420 reads (the GIL is released during decode,
so a Python thread pool decodes several videos at once) and the streaming mp4 encoder
(``VideoWriter``, ``write_mp4``) --, ``write_y4m``, a pure numpy YUV4MPEG2 writer, and
``SyntheticVideoReader`` for procedural ``synthetic://`` videos that need no media
files.

The layer is built with g++ at first use into
``build/ted_spad_tpu_torch/libvideodec-<hash>.so`` under the repository root, the hash
covering the source and the flags, as utils/cuda_build.py keys the kernels. It is the
JAX package's native/videodec with swscale's output staged at aligned line sizes, so
native-size reads at widths that 16 does not divide are stable and right there (the
JAX package's reads are not; at other widths and at scaled reads the bytes are its).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "videodec.cpp")
_LIB_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ted_spad_tpu_torch")
_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
_lib = None
_lib_error: str | None = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the layer of this source and these flags is built."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_CXX_FLAGS + _LIBS).encode()).hexdigest()[:12]
    return os.path.join(_LIB_DIR, f"libvideodec-{digest}.so")


def build_library() -> str:
    """Compile csrc/videodec.cpp with g++ unless its library exists, under an exclusive
    file lock (decode pool threads and processes may race here), and return its path.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    target = library_path()
    os.makedirs(_LIB_DIR, exist_ok=True)
    with open(os.path.join(_LIB_DIR, ".videodec.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(target):
            tmp = f"{target}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, _SOURCE, *_LIBS],
                                      capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"videodec build failed: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"videodec build failed (g++ exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
    return target


def _load_library():
    global _lib, _lib_error
    with _lib_lock:
        if _lib is None and _lib_error is None:
            try:
                _lib = _bind(ctypes.CDLL(build_library()))
            except (OSError, RuntimeError, AttributeError) as e:
                _lib_error = str(e)
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the layer's C signatures on ``lib``."""
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
    lib.ve_open_cs.restype = ctypes.c_void_p
    lib.ve_open_cs.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                               ctypes.c_char_p, ctypes.c_int]
    lib.ve_write.restype = ctypes.c_int
    lib.ve_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.ve_close.restype = ctypes.c_int
    lib.ve_close.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the native decode / encode library builds (or is built) and loads."""
    return _load_library() is not None


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


class VideoWriter:
    """Streaming RGB24 -> mp4 encoder over the native layer (libx264, mpeg4 where x264
    is missing; the reference's imageio.mimwrite, visualize_anonymization.py:84-115).
    Odd frame sizes are cropped by one pixel (yuv420p needs even sizes).

    ``colorspace``: 0 writes an untagged stream converted with swscale's default
    (BT.601) matrix; 601 / 709 tag the stream (limited range) and convert with that
    matrix, so decoders that honour the tag, this package's reader included, get the
    input RGB back."""

    def __init__(self, path: str, width: int, height: int, fps: float = 25.0, codec: str = "",
                 colorspace: int = 0):
        lib = _load_library()
        if lib is None:
            raise RuntimeError(f"native videodec unavailable: {_lib_error}")
        if colorspace not in (0, 601, 709):
            raise ValueError(f"colorspace must be 0, 601 or 709, got {colorspace}")
        self._lib = lib
        self.width = width - width % 2
        self.height = height - height % 2
        self._h = lib.ve_open_cs(path.encode(), self.width, self.height, float(fps), codec.encode(),
                                 colorspace)
        if not self._h:
            raise IOError(f"cannot open encoder for {path}: {lib.vd_last_error().decode()}")
        self.path = path

    def write(self, frame: np.ndarray) -> None:
        """Encode one (H, W, 3) uint8 RGB frame, cropped to the encoder's size."""
        frame = np.asarray(frame)
        if (frame.ndim != 3 or frame.shape[0] < self.height or frame.shape[1] < self.width
                or frame.shape[2] != 3):
            # ve_write reads height * width * 3 bytes whatever it is given: a smaller
            # frame would be read out of bounds.
            raise ValueError(f"frame shape {frame.shape} does not fit a {self.height}x{self.width}x3 "
                             f"encoder (larger frames are cropped, never padded)")
        frame = np.ascontiguousarray(frame[: self.height, : self.width], dtype=np.uint8)
        if self._lib.ve_write(self._h, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))) != 0:
            raise IOError(f"encode failed: {self._lib.vd_last_error().decode()}")

    def close(self) -> None:
        if self._h:
            rc = self._lib.ve_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError(f"finalizing {self.path} failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- never raise from a finalizer
            pass


def write_mp4(path: str, frames: np.ndarray, fps: float = 25.0, codec: str = "",
              colorspace: int = 0) -> str:
    """(T, H, W, 3) uint8 RGB frames -> an .mp4 through the native encoder;
    ``colorspace`` as in ``VideoWriter``."""
    frames = np.asarray(frames, dtype=np.uint8)
    _, h, w, _ = frames.shape
    with VideoWriter(path, w, h, fps=fps, codec=codec, colorspace=colorspace) as vw:
        for frame in frames:
            vw.write(frame)
    return path


class Y4MWriter:
    """Streaming RGB24 -> YUV4MPEG2 (C444, BT.601 full range) in numpy alone (no
    encoder library), frame by frame; the bytes of ``write_y4m`` over the same frames."""

    def __init__(self, path: str, width: int, height: int, fps: int = 25):
        self.path, self.width, self.height = path, width, height
        self._f = open(path, "wb")
        self._f.write(f"YUV4MPEG2 W{width} H{height} F{fps}:1 Ip A1:1 C444 XCOLORRANGE=FULL\n".encode())

    def write(self, frame: np.ndarray) -> None:
        """Append one (H, W, 3) uint8 RGB frame of the writer's size."""
        frame = np.asarray(frame, dtype=np.uint8)
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"frame shape {frame.shape} is not the writer's "
                             f"({self.height}, {self.width}, 3)")
        rgb = frame.astype(np.float32)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
        self._f.write(b"FRAME\n")
        for plane in (y, cb, cr):
            self._f.write(np.clip(plane + 0.5, 0, 255).astype(np.uint8).tobytes())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_y4m(path: str, frames: np.ndarray, fps: int = 25) -> str:
    """(T, H, W, 3) uint8 RGB -> a YUV4MPEG2 file, C444, BT.601 full range, in numpy
    alone, so a real container reaches the decoder without an encoder library."""
    frames = np.asarray(frames, dtype=np.uint8)
    _, h, w, _ = frames.shape
    with Y4MWriter(path, w, h, fps) as writer:
        for frame in frames:
            writer.write(frame)
    return path

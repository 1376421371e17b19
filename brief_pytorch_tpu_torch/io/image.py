"""Image / volume I/O: TIFF volumes (3-D), PNG/JPG images (2-D), MP4
video (3-D).

Torch-free port of brief_pytorch_tpu/io/image.py (reference
utils/tool.py:32-103).  TIFF goes through the minimal baseline-TIFF codec
of brief_pytorch_tpu/io/image.py:58-138 (uncompressed, grayscale,
strips); a compressed TIFF (the repository's demo volumes under
dataset/example are LZW with a horizontal predictor) is read as the
reference reads every TIFF, through cv2.imreadmulti.  PNG/JPG and MP4 go
through cv2 as in the JAX package (cv2.imread / cv2.imwrite, a DIVX
cv2.VideoWriter at 25 fps, cv2.VideoCapture), except that a grayscale
PNG of uint8 or uint16 is written by the port's own minimal writer, so
the MIP previews need no cv2.  cv2 is imported only where it is used;
without it those paths raise.  Layouts match the reference: 3-D ->
(d, h, w, c), a video (frames, h, w, 3) in BGR as cv2 returns it; 2-D ->
(h, w, c).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _cv2(path: str, what: str):
    """cv2, imported where a format needs it."""
    try:
        import cv2
    except ImportError:
        raise ValueError(f"{path}: {what} needs cv2 (opencv-python), which "
                         "is not installed") from None
    return cv2


def get_dimension(path: str) -> int:
    """2 for PNG/JPG, 3 for TIFF/MP4 (reference utils/tool.py:32-42)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".tif", ".tiff", ".mp4"):
        return 3
    if ext in (".png", ".jpg"):
        return 2
    raise NotImplementedError(ext)


# ------------------------------------------------------------------ TIFF ---
def _read_compressed_tiff(path: str, compression: int) -> np.ndarray:
    """A compressed TIFF through cv2, as brief_pytorch_tpu/io/image.py:38-43
    reads it."""
    cv2 = _cv2(path, f"TIFF compression {compression} (the port's own "
                     "reader takes uncompressed TIFF only)")
    ok, pages = cv2.imreadmulti(path, flags=cv2.IMREAD_UNCHANGED)
    if not ok or not pages:
        raise ValueError(f"{path}: cv2 could not read it")
    return np.stack(pages)


def read_tiff(path: str) -> np.ndarray:
    """Minimal baseline-TIFF reader (uncompressed, grayscale, strips); a
    compressed file goes to cv2 (_read_compressed_tiff)."""
    with open(path, "rb") as f:
        data = f.read()
    endian = "<" if data[:2] == b"II" else ">"
    (magic,) = struct.unpack(endian + "H", data[2:4])
    if magic != 42:
        raise ValueError(f"{path}: not a classic TIFF")
    (off,) = struct.unpack(endian + "I", data[4:8])
    pages = []
    while off:
        (n_tags,) = struct.unpack(endian + "H", data[off:off + 2])
        tags = {}
        for i in range(n_tags):
            t = off + 2 + 12 * i
            tag, typ, cnt = struct.unpack(endian + "HHI", data[t:t + 8])
            fmt = {1: "B", 3: "H", 4: "I"}.get(typ)
            if fmt is None:
                continue
            size = struct.calcsize(fmt) * cnt
            if size <= 4:
                vals = struct.unpack(endian + fmt * cnt, data[t + 8:t + 8 + size])
            else:
                (voff,) = struct.unpack(endian + "I", data[t + 8:t + 12])
                vals = struct.unpack(endian + fmt * cnt, data[voff:voff + size])
            tags[tag] = vals
        w = tags[256][0]
        h = tags[257][0]
        bits = tags.get(258, (8,))[0]
        if tags.get(259, (1,))[0] != 1:
            return _read_compressed_tiff(path, tags[259][0])
        offsets = tags[273]
        counts = tags.get(279, (h * w * bits // 8,))
        raw = b"".join(data[o:o + c] for o, c in zip(offsets, counts))
        dtype = {8: np.uint8, 16: np.uint16, 32: np.float32}[bits]
        page = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder(endian))
        pages.append(page[: h * w].reshape(h, w).astype(dtype))
        (off,) = struct.unpack(endian + "I",
                               data[off + 2 + 12 * n_tags:off + 6 + 12 * n_tags])
    return np.stack(pages)


def save_tiff(path: str, volume: np.ndarray) -> None:
    """Minimal baseline-TIFF writer (uncompressed, grayscale, one strip/page)."""
    volume = np.asarray(volume)
    if volume.ndim in (3, 4) and volume.shape[-1] == 1:
        volume = volume[..., 0]     # (d, h, w, 1) volume or (h, w, 1) image
    if volume.ndim == 2:
        volume = volume[None]
    volume = np.ascontiguousarray(volume.astype(volume.dtype.newbyteorder("<")))
    d, h, w = volume.shape[:3]
    bits = volume.dtype.itemsize * 8
    sample_format = 3 if volume.dtype.kind == "f" else 1
    # layout: header | page0 data | page0 IFD | page1 data | page1 IFD | ...
    chunks = [volume[i].tobytes() for i in range(d)]
    with open(path, "wb") as f:
        f.write(b"II*\x00")
        f.write(struct.pack("<I", 8 + len(chunks[0])))
        cursor = 8
        for i in range(d):
            f.write(chunks[i])
            data_off = cursor
            cursor += len(chunks[i])
            tags = [
                (256, 4, 1, w),
                (257, 4, 1, h),
                (258, 3, 1, bits),
                (259, 3, 1, 1),
                (262, 3, 1, 1),
                (273, 4, 1, data_off),
                (279, 4, 1, len(chunks[i])),
                (339, 3, 1, sample_format),
            ]
            ifd = struct.pack("<H", len(tags))
            for tag, typ, cnt, val in tags:
                ifd += struct.pack("<HHII", tag, typ, cnt, val)
            ifd_len = 2 + 12 * len(tags) + 4
            # the next IFD follows the next page's pixel data
            next_off = cursor + ifd_len + len(chunks[i + 1]) if i + 1 < d \
                else 0
            ifd += struct.pack("<I", next_off)
            f.write(ifd)
            cursor += ifd_len


# ------------------------------------------------------------------- PNG ---
def save_png(path: str, img: np.ndarray) -> None:
    """Grayscale 8- or 16-bit PNG (no filtering), for MIP previews."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.dtype == np.uint8:
        depth, rows = 8, img
    else:
        depth, rows = 16, img.astype(">u2")
    h, w = rows.shape
    raw = b"".join(b"\x00" + rows[r].tobytes() for r in range(h))

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


# ----------------------------------------------------------------- video ---
def read_video(path: str) -> np.ndarray:
    """Every frame of a video, (frames, h, w, 3) uint8 BGR
    (JAX io/image.py:140-151)."""
    cv2 = _cv2(path, "video")
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    if not frames:
        raise ValueError(f"{path}: cv2 read no frame")
    return np.stack(frames)


def save_video(fps: int, path: str, imgs: np.ndarray) -> None:
    """(frames, h, w, 3) uint8 BGR -> a DIVX video (JAX
    io/image.py:154-161)."""
    cv2 = _cv2(path, "video")
    h, w = imgs.shape[1], imgs.shape[2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc("D", "I", "V", "X"),
                          fps, (w, h))
    for img in imgs:
        out.write(np.ascontiguousarray(img))
    out.release()


# -------------------------------------------------------------- dispatch ---
def read_img(path: str) -> np.ndarray:
    """3-D -> (d, h, w, c); 2-D -> (h, w, c) (reference
    utils/tool.py:73-92)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".tif", ".tiff", ".mp4"):
        img = read_tiff(path) if ext != ".mp4" else read_video(path)
        if img.ndim == 3:
            img = img[..., None]
        return img
    if ext in (".png", ".jpg"):
        img = _cv2(path, ext).imread(path, -1)
        if img is None:
            raise ValueError(f"{path}: cv2 could not read it")
        if img.ndim == 2:
            img = img[..., None]
        return img
    raise NotImplementedError(ext)


def save_img(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".tif", ".tiff"):
        save_tiff(path, img)
    elif ext == ".mp4":
        save_video(25, path, img)
    elif ext in (".png", ".jpg"):
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        if ext == ".png" and img.ndim == 2 and \
                img.dtype in (np.uint8, np.uint16):
            save_png(path, img)
        elif not _cv2(path, ext).imwrite(path, img):
            raise ValueError(f"{path}: cv2 could not write it")
    else:
        raise NotImplementedError(ext)


def get_folder_size(folder_path: str) -> int:
    """Recursive on-disk size in bytes (reference utils/io.py:216-227)."""
    if not os.path.isdir(folder_path):
        return os.path.getsize(folder_path)
    total = 0
    for dirpath, _dirnames, filenames in os.walk(folder_path):
        for fname in filenames:
            fp = os.path.join(dirpath, fname)
            if not os.path.islink(fp):
                total += os.path.getsize(fp)
    return total

"""Archive I/O: zip containers, genuine .7z (libarchive), and the
binary+yaml bundle used for entropy-coded payloads.

Copy of brief_pytorch_tpu/io/archive.py
(pure Python: the port keeps its own).

Capability parity: reference utils/io.py:216-313 (write_zip/read_zip,
write_7z/extract_7z/read_7z with BZIP2/LZMA/ZSTD filter presets,
write_binary_yaml_zip/read_binary_yaml_zip).  py7zr is not available in
this image; the 7z paths run through the system libarchive instead
(io/sevenzip.py, ctypes) — genuine reference-produced .7z archives read
correctly and archives written here open in 7-Zip/py7zr.  When libarchive
is absent, writing falls back to the legacy B7Z1 container (stdlib
LZMA/BZip2 codecs over a flat index) and reading a genuine .7z fails
loudly with guidance; read_7z dispatches on the container magic either
way, so B7Z1 archives from earlier builds keep reading.
"""
from __future__ import annotations

import bz2
import io as _io
import lzma
import os
import struct
import zipfile
import zlib
from typing import Dict, List, Optional

import yaml

# method -> (compress, decompress); mirrors reference SEVENZFILTER presets.
_CODECS = {
    "default": (lambda b: lzma.compress(b, preset=6), lzma.decompress),
    "lzma2_7": (lambda b: lzma.compress(b, preset=7), lzma.decompress),
    "bzip2_7": (lambda b: bz2.compress(b, 7), bz2.decompress),
    "zstd_7": (lambda b: zlib.compress(b, 7), zlib.decompress),  # zstd absent
}

_MAGIC = b"B7Z1"


# ----------------------------------------------------------------- zip ----
def write_zip(file_path_list: List[str], save_path: str,
              arcname_list: Optional[List[str]] = None) -> None:
    """(reference utils/io.py:256-260)"""
    if arcname_list is None:
        arcname_list = [os.path.basename(p) for p in file_path_list]
    with zipfile.ZipFile(save_path, "w") as zf:
        for path, arcname in zip(file_path_list, arcname_list):
            zf.write(path, arcname)


def read_zip(file_path: str) -> Dict[str, bytes]:
    """basename -> content (reference utils/io.py:261-267)"""
    out = {}
    with zipfile.ZipFile(file_path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                out[os.path.basename(name)] = f.read()
    return out


# ------------------------------------------------------------ 7z-style ----
def _walk_files(path: str, arcbase: Optional[str]) -> List:
    """(arcname, abspath) pairs for a file or directory."""
    base = arcbase if arcbase is not None else os.path.basename(path)
    if os.path.isfile(path):
        return [(base, path)]
    out = []
    for dirpath, _dirs, files in os.walk(path):
        rel = os.path.relpath(dirpath, path)
        for f in sorted(files):
            arc = os.path.join(base, f) if rel == "." else \
                os.path.join(base, rel, f)
            out.append((arc, os.path.join(dirpath, f)))
    return out


def write_7z(file_path_list: List[str], save_path: str,
             arcname_list=None, method: str = "default") -> None:
    """Solid-compress files/dirs into one archive
    (reference utils/io.py:268-277).  arcname_list may be a list or a single
    string applied to the first entry, like the reference's usage.

    Writes a GENUINE .7z via libarchive when available (interops with the
    reference's py7zr reader and with 7-Zip); falls back to the legacy
    B7Z1 container otherwise."""
    from brief_pytorch_tpu_torch.io import sevenzip
    if sevenzip.available():
        method_map = {"default": "default", "lzma2_7": "default",
                      "lzma": "lzma", "bzip2_7": "bzip2", "bzip2": "bzip2",
                      "zstd_7": "zstd", "zstd": "zstd"}
        sevenzip.write_7z(file_path_list, save_path, arcname_list,
                          method_map.get(method, "default"))
        return
    if arcname_list is None:
        arcname_list = [None] * len(file_path_list)
    if isinstance(arcname_list, str):
        arcname_list = [arcname_list] + [None] * (len(file_path_list) - 1)
    entries = []
    for path, arc in zip(file_path_list, arcname_list):
        entries.extend(_walk_files(path, arc))
    payload = _io.BytesIO()
    index = []
    for arc, path in entries:
        with open(path, "rb") as f:
            data = f.read()
        index.append((arc, len(data)))
        payload.write(data)
    compress, _ = _CODECS[method]
    blob = compress(payload.getvalue())
    header = yaml.safe_dump({"method": method, "index": [list(e) for e in index]},
                            sort_keys=False).encode()
    with open(save_path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(blob)


_REAL_7Z_MAGIC = b"7z\xbc\xaf\x27\x1c"   # genuine .7z container signature


def read_7z(file_path: str) -> Dict[str, _io.BytesIO]:
    """arcname -> BytesIO (reference utils/io.py:282-287 contract).

    Dispatches on the container magic: genuine 7-Zip archives (including
    ones produced by the reference's py7zr write_7z) go through libarchive
    (io/sevenzip.py); the legacy B7Z1 container keeps its stdlib path.
    """
    with open(file_path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            with open(file_path, "rb") as g:
                head6 = g.read(6)
            if head6 == _REAL_7Z_MAGIC:
                from brief_pytorch_tpu_torch.io import sevenzip
                if sevenzip.available():
                    return sevenzip.read_7z(file_path)
                raise ValueError(
                    f"{file_path} is a genuine 7-Zip archive and no "
                    "libarchive is available to read it. Extract it "
                    "externally (`7z x` or py7zr) and re-pack with "
                    "write_7z, or read the extracted files directly.")
            raise ValueError(
                f"{file_path} is not a brief-tpu B7Z1 archive "
                f"(magic {magic!r}, expected {_MAGIC!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = yaml.safe_load(f.read(hlen).decode())
        blob = f.read()
    _, decompress = _CODECS[header["method"]]
    payload = decompress(blob)
    out = {}
    off = 0
    for arc, n in header["index"]:
        out[arc] = _io.BytesIO(payload[off:off + n])
        off += n
    return out


def extract_7z(file_path: str, extract_to_dir: str) -> None:
    """(reference utils/io.py:278-281)"""
    data = read_7z(file_path)
    for arc, buf in data.items():
        dest = os.path.join(extract_to_dir, arc)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "wb") as f:
            f.write(buf.getvalue())


# ------------------------------------------------- binary + yaml bundle ----
def write_binary_yaml_zip(binary_list_dict: Dict[str, List[bytes]],
                          sideinfos_dict: dict, save_path: str) -> None:
    """Bundle entropy-coded strings + sideinfos into one zip
    (reference utils/io.py:284-299) — the NFLR compressed-file container."""
    with zipfile.ZipFile(save_path, "w") as zf:
        for key, binaries in binary_list_dict.items():
            for batch_idx, binary in enumerate(binaries):
                zf.writestr(f"{key}_{batch_idx}", binary)
        zf.writestr("sideinfos.yaml",
                    yaml.safe_dump(sideinfos_dict, sort_keys=False))


def read_binary_yaml_zip(binary_name_list: List[str], file_path: str):
    """Inverse of write_binary_yaml_zip (reference utils/io.py:300-313)."""
    zip_data = read_zip(file_path)
    sideinfos = yaml.safe_load(zip_data["sideinfos.yaml"].decode())
    binary_list_dict: Dict[str, List[bytes]] = {}
    for name in binary_name_list:
        binaries = []
        idx = 0
        while f"{name}_{idx}" in zip_data:
            binaries.append(zip_data[f"{name}_{idx}"])
            idx += 1
        binary_list_dict[name] = binaries
    return binary_list_dict, sideinfos

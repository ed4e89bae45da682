"""Minimal NIfTI-1 reader (numpy-only).

The reference loads medical volumes through MONAI's LoadImaged + nibabel
(src/data/get_train_and_val_dataloader.py:69, requirements.txt monai[nibabel]).
nibabel is not a baked-in dependency here, so this module implements the small part
of NIfTI-1 the pipeline needs: header parse (dims, datatype, scl slope/inter,
vox_offset), optional gzip, and data load in fortran order as (X, Y, Z[, T]).

A copy of ``ddpm_ood_tpu/data/nifti.py``, which ``data/transforms.py`` needs:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO

import numpy as np

_NIFTI1_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}


def _read_header(f: BinaryIO):
    hdr = f.read(348)
    if len(hdr) < 348:
        raise ValueError("Truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    byte_order = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError("Not a NIfTI-1 file")
        byte_order = ">"
    magic = hdr[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"Bad NIfTI magic: {magic!r}")
    dim = struct.unpack(byte_order + "8h", hdr[40:56])
    datatype = struct.unpack(byte_order + "h", hdr[70:72])[0]
    scl_slope = struct.unpack(byte_order + "f", hdr[112:116])[0]
    scl_inter = struct.unpack(byte_order + "f", hdr[116:120])[0]
    vox_offset = struct.unpack(byte_order + "f", hdr[108:112])[0]
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    if datatype not in _NIFTI1_DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_NIFTI1_DTYPES[datatype]).newbyteorder(byte_order)
    return shape, dtype, float(scl_slope), float(scl_inter), int(vox_offset)


def load_nifti(path: str) -> np.ndarray:
    """Load a .nii / .nii.gz volume as float32 (X, Y, Z[, T]), scl slope/inter applied."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        shape, dtype, slope, inter, vox_offset = _read_header(f)
        f.seek(vox_offset)
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
    arr = data.reshape(shape, order="F").astype(np.float32)
    if slope not in (0.0, 1.0) or inter != 0.0:
        slope_eff = slope if slope != 0.0 else 1.0
        arr = arr * slope_eff + inter
    return arr


def save_nifti(path: str, arr: np.ndarray) -> None:
    """Write a minimal little-endian float32 NIfTI-1 (identity affine). Used by the
    dataset-prep scripts and tests; readable by nibabel/MONAI."""
    arr = np.asarray(arr, dtype=np.float32)
    ndim = arr.ndim
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, 16)  # float32
    struct.pack_into("<h", hdr, 72, 32)  # bitpix
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    pixdim = [1.0] * 8
    struct.pack_into("<8f", hdr, 76, *pixdim)
    # sform identity
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, 1.0, 0.0, 0.0, 0.0)
    struct.pack_into("<4f", hdr, 296, 0.0, 1.0, 0.0, 0.0)
    struct.pack_into("<4f", hdr, 312, 0.0, 0.0, 1.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(arr.flatten(order="F").tobytes())

"""Self-contained NIfTI-1 codec (.nii / .nii.gz), host side: the port's
own copy of the JAX package's `utils/nifti.py` (numpy, gzip, struct).

The reference reads volumes with nibabel (`utils/data.py:32-41`,
`detection/model_utils.py:126`); this codec keeps the input pipeline free
of a third-party dependency between disk bytes and device buffers.
Supports the header fields the MRI stack uses: dims, datatype, scaling
(scl_slope/scl_inter), qform/sform affines, and gzip containers.
"""
from __future__ import annotations

import dataclasses
import gzip
import struct
from typing import Optional

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_BITPIX = {k: np.dtype(v).itemsize * 8 for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray
    affine: np.ndarray  # 4x4 voxel -> world (RAS) transform

    @property
    def shape(self):
        return self.data.shape

    def get_fdata(self) -> np.ndarray:
        """nibabel-compatible accessor: float64 scaled data."""
        return np.asarray(self.data, dtype=np.float64)


def _quaternion_to_affine(b, c, d, qx, qy, qz, dx, dy, dz, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    r = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
    ])
    qfac = -1.0 if qfac < 0 else 1.0
    aff = np.eye(4)
    aff[:3, :3] = r * np.array([dx, dy, dz * qfac])
    aff[:3, 3] = [qx, qy, qz]
    return aff


def load_nifti(path: str) -> NiftiImage:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()

    if len(raw) < 348:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")

    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    bo = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        bo = ">"

    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(bo + "8h", raw, 40)
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(s) for s in dim[1:1 + ndim])

    (datatype,) = struct.unpack_from(bo + "h", raw, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

    pixdim = struct.unpack_from(bo + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(bo + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(bo + "2f", raw, 112)
    qform_code, sform_code = struct.unpack_from(bo + "2h", raw, 252)

    offset = int(vox_offset) if vox_offset >= 348 else 352
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    else:
        data = np.asarray(data)

    if sform_code > 0:
        rows = struct.unpack_from(bo + "12f", raw, 280)
        affine = np.vstack([np.array(rows).reshape(3, 4), [0, 0, 0, 1]])
    elif qform_code > 0:
        b, c, d = struct.unpack_from(bo + "3f", raw, 256)
        qx, qy, qz = struct.unpack_from(bo + "3f", raw, 268)
        affine = _quaternion_to_affine(
            b, c, d, qx, qy, qz, pixdim[1], pixdim[2], pixdim[3], pixdim[0])
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0,
                          pixdim[3] or 1.0, 1.0])
    return NiftiImage(data=data, affine=affine)


def save_nifti(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write a .nii/.nii.gz with an sform affine (code 2)."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, dtype=np.float64)

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    ndim = data.ndim
    dims = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, _BITPIX[code])
    # pixdim from affine column norms
    zooms = [float(np.linalg.norm(affine[:3, i])) or 1.0 for i in range(3)]
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, *([1.0] * 4))
    struct.pack_into("<f", hdr, 108, 352.0)      # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope / inter
    struct.pack_into("<2h", hdr, 252, 0, 2)      # qform off, sform aligned
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].reshape(-1))
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)

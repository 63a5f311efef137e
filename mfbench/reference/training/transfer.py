"""The single-buffer batch transfer form: one uint8 buffer a batch.

Port of ``morefusion_tpu/training/transfer.py``. Each field of a training
batch is packed on the host into one ``(B, K)`` uint8 buffer, so a batch
reaches the card in one copy:

- rgb ships as YCrCb 4:2:0 (cv2's ``COLOR_RGB2YCrCb``, the chroma averaged
  over 2 x 2 pixels in integers as ``(s + 2) >> 2``);
- the organized point cloud ships as the depth ``z`` quantized to uint8
  over each example's finite range (code 0 is NaN; a float32 minimum and
  step ahead of the codes) plus 4 affine coefficients an example, from
  which the card rebuilds ``x = z (a + b j)`` and ``y = z (c + d i)``
  (:func:`reconstruct_pcd`);
- boolean grids ship bit-packed (``np.packbits``, most significant bit
  first);
- every other field ships as its raw bytes.

``TransferSchema.pack`` runs on the host, bit for bit the JAX package's;
``unpack`` runs on the buffer's device in torch operations. A raw field
whose bytes start at an offset that is not a multiple of its item size
is copied out contiguous before its bytes are reinterpreted, since
``Tensor.view(dtype)`` needs an aligned storage offset.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

# the canonical field order; a schema is this list filtered by key presence
_CANONICAL: Tuple[Tuple[str, str], ...] = (
    ("rgb", "yuv420"),
    ("z", "q8"),
    ("pcd_coef", "raw"),
    ("pcd", "raw"),
    ("grid_target", "bits"),
    ("grid_nontarget_empty", "bits"),
    ("class_id", "raw"),
    ("quaternion_true", "raw"),
    ("translation_true", "raw"),
    ("origin", "raw"),
    ("pitch", "raw"),
)

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


class TransferSchema:
    """The static layout of a packed transfer buffer, built from one host
    batch: ``fields`` holds ``(name, kind, dtype, shape, offset, nbytes)``
    per field (the unpacked dtype and per-example shape, the byte range in
    a row) and ``row_bytes`` the bytes an example."""

    def __init__(self, batch: Dict[str, np.ndarray]):
        known = {name for name, _ in _CANONICAL}
        leftover = set(batch) - known
        if leftover:
            # a field the table does not know would be dropped silently
            raise ValueError(
                f"batch keys {sorted(leftover)} missing from "
                "transfer._CANONICAL — add them to the schema table")
        self.fields: List[Tuple[str, str, np.dtype, tuple, int, int]] = []
        offset = 0
        for name, kind in _CANONICAL:
            if name not in batch:
                continue
            arr = np.asarray(batch[name])
            shape = arr.shape[1:]
            if kind == "bits":
                assert arr.dtype == np.bool_, (name, arr.dtype)
                n = int(np.prod(shape, dtype=np.int64))
                assert n % 8 == 0, name
                nbytes = n // 8
                dtype = np.dtype(np.bool_)
            elif kind == "yuv420":
                H, W, C = shape
                if arr.dtype != np.uint8 or C != 3 or H % 2 or W % 2:
                    kind = "raw"  # odd shapes and dtypes ship raw
                    dtype = arr.dtype
                    nbytes = (int(np.prod(shape, dtype=np.int64))
                              * dtype.itemsize)
                else:
                    nbytes = H * W + 2 * (H // 2) * (W // 2)
                    dtype = np.dtype(np.float32)  # the unpacked dtype
            elif kind == "q8":
                H, W = shape
                # uint8 codes (0 = NaN) + float32 zmin / zscale an example
                nbytes = H * W + 8
                dtype = np.dtype(np.float32)
            else:
                dtype = arr.dtype
                nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self.fields.append((name, kind, dtype, shape, offset, nbytes))
            offset += nbytes
        self.row_bytes = offset

    def pack(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Host: the batch's dict -> a ``(B, row_bytes)`` uint8 array."""
        import cv2

        B = len(next(iter(batch.values())))
        buf = np.empty((B, self.row_bytes), np.uint8)
        for name, kind, dtype, shape, offset, nbytes in self.fields:
            arr = np.ascontiguousarray(batch[name])
            dst = buf[:, offset:offset + nbytes]
            if kind == "bits":
                dst[...] = np.packbits(arr.reshape(B, -1), axis=1)
            elif kind == "yuv420":
                H, W, _ = shape
                n_y = H * W
                n_c = (H // 2) * (W // 2)
                # one cvtColor over the whole batch: a pixelwise op, so
                # stacking the examples as (B * H, W) rows is exact
                ycc = cv2.cvtColor(
                    arr.reshape(B * H, W, 3), cv2.COLOR_RGB2YCrCb
                ).reshape(B, H, W, 3)
                dst[:, :n_y] = ycc[..., 0].reshape(B, -1)
                # 2 x 2 mean of the chroma in uint16:
                # (sum + 2) >> 2 == round(mean) of 4 samples
                for ch, lo in ((1, n_y), (2, n_y + n_c)):
                    c16 = ycc[..., ch].reshape(
                        B, H // 2, 2, W // 2, 2).astype(np.uint16)
                    s = (c16[:, :, 0, :, 0] + c16[:, :, 0, :, 1]
                         + c16[:, :, 1, :, 0] + c16[:, :, 1, :, 1])
                    dst[:, lo:lo + n_c] = (
                        ((s + 2) >> 2).astype(np.uint8).reshape(B, -1))
            elif kind == "q8":
                H, W = shape
                z = arr.reshape(B, -1).astype(np.float32)
                with warnings.catch_warnings():
                    # all-NaN rows are valid here (fully truncated crops)
                    warnings.simplefilter("ignore", RuntimeWarning)
                    zmin = np.nanmin(z, axis=1)
                    zmax = np.nanmax(z, axis=1)
                bad = ~np.isfinite(zmin)
                zmin[bad] = 0.0
                zmax[bad] = 0.0
                scale = np.maximum(zmax - zmin, 1e-6) / 254.0
                q = (z - zmin[:, None]) * (1.0 / scale)[:, None]
                np.clip(q, 0.0, 254.0, out=q)
                q += 1.0
                np.rint(q, out=q)
                q[~np.isfinite(z)] = 0.0  # NaN depth -> code 0
                dst[:, :H * W] = q.astype(np.uint8)
                head = dst[:, H * W:].view(np.float32)
                head[:, 0] = zmin
                head[:, 1] = scale
            else:
                dst.view(dtype)[...] = arr.reshape(B, -1)
        return buf

    def unpack(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Device: a ``(B, row_bytes)`` uint8 tensor -> the dict of typed
        tensors on its device (rgb float32 in [0, 255], z float32 with NaN
        holes, grids bool, the rest in their host dtypes)."""
        out = {}
        B = buf.shape[0]
        for name, kind, dtype, shape, offset, nbytes in self.fields:
            col = buf[:, offset:offset + nbytes]
            if kind == "bits":
                shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                                      device=buf.device)
                bits = (col[:, :, None] >> shifts) & 1
                out[name] = bits.reshape((B,) + shape).bool()
            elif kind == "yuv420":
                H, W, _ = shape
                n_y, n_c = H * W, (H // 2) * (W // 2)
                y = col[:, :n_y].reshape(B, H, W).float()

                def chroma(lo):
                    c = col[:, lo:lo + n_c].reshape(B, H // 2, W // 2)
                    c = c.float() - 128.0
                    return c.repeat_interleave(2, 1).repeat_interleave(2, 2)

                cr, cb = chroma(n_y), chroma(n_y + n_c)
                r = y + 1.403 * cr
                g = y - 0.714 * cr - 0.344 * cb
                b = y + 1.773 * cb
                out[name] = torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)
            elif kind == "q8":
                H, W = shape
                q = col[:, :H * W].reshape(B, H, W)
                head = col[:, H * W:].contiguous().view(torch.float32)
                zmin = head[:, 0, None, None]
                scale = head[:, 1, None, None]
                z = zmin + (q.float() - 1.0) * scale
                out[name] = torch.where(q == 0, float("nan"), z)
            else:
                tdtype = _TORCH_DTYPES[np.dtype(dtype)]
                if tdtype != torch.uint8:
                    # a fresh contiguous copy: aligned for any item size
                    col = col.contiguous().view(tdtype)
                out[name] = col.reshape((B,) + shape)
        return out


def reconstruct_pcd(z: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Device: z ``(B, H, W)`` (float16 or float32) and the ``(B, 4)``
    affine coefficients -> the organized cloud ``(B, H, W, 3)`` float32.
    NaN depth holes carry over to x and y, so the mask contract
    (``~isnan(pcd).any(-1)``) holds."""
    z = z.float()
    B, H, W = z.shape
    j = torch.arange(W, dtype=torch.float32, device=z.device)
    i = torch.arange(H, dtype=torch.float32, device=z.device)
    x = z * (coef[:, 0, None, None] + coef[:, 1, None, None] * j[None, None])
    y = z * (coef[:, 2, None, None] + coef[:, 3, None, None] * i[None, :, None])
    return torch.stack([x, y, z], dim=-1)



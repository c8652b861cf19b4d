"""Minimal TensorBoard scalar/text event writer — no TF dependency.

The reference logs per-batch scalars and epoch-end caption text to
TensorBoard (main.py:202-211, Callbacks/Predict.py:27-46). This image has no
TensorFlow, so the TFRecord event framing (length + masked crc32c + payload)
and the Event/Summary protobufs are hand-encoded here (both formats are
stable, documented wire formats). Scalars and text summaries only — enough
for ``tensorboard --logdir`` to render the runs.

The port's own copy of ``masters_thesis_tpu/utils/tensorboard.py``
(``EventWriter`` and ``encode_png``, held against the originals by
``tests/test_torch_copies.py``). ``render_caption_image`` draws with
matplotlib, which the card's machine lacks: it waits, and raises.
"""

from __future__ import annotations

import os
import struct
import time

# ---- crc32c (Castagnoli), table-based ----
_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---- protobuf wire helpers ----
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _float_field(num: int, value: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", value)


def _double_field(num: int, value: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", value)


def _int64_field(num: int, value: int) -> bytes:
    return _field(num, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    return _bytes_field(1, tag.encode()) + _float_field(2, float(value))


def _text_value(tag: str, text: str) -> bytes:
    # Summary.Value{ tag=1, tensor=8: TensorProto{dtype=1(DT_STRING->7),
    #   string_val=8} } — TB renders DT_STRING tensors as text
    tensor = _int64_field(1, 7) + _bytes_field(8, text.encode())
    meta = _bytes_field(1, _bytes_field(1, b"text"))  # plugin_data{name}
    return (
        _bytes_field(1, tag.encode())
        + _bytes_field(9, meta)
        + _bytes_field(8, tensor)
    )


class EventWriter:
    """events.out.tfevents writer (scalars + text)."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        # pid keeps two writers started within the same second (train+eval
        # pair, back-to-back trials) from opening — and truncating — the
        # same file; TF's writers embed hostname+pid for the same reason
        name = (f"events.out.tfevents.{int(time.time())}.mtt.{os.getpid()}"
                f"{filename_suffix}")
        self._f = open(os.path.join(logdir, name), "wb")
        self._write_event(self._event(None))  # file header event (version)

    def _event(self, summary: bytes | None, step: int = 0) -> bytes:
        """``summary=None`` means the file_version header; an EMPTY summary
        (e.g. scalars({})) is a regular, empty event — never a second
        version record mid-file."""
        ev = _double_field(1, time.time())
        ev += _int64_field(2, step)
        if summary is None:
            ev += _bytes_field(3, b"brain.Event:2")  # file_version
        else:
            ev += _bytes_field(5, summary)
        return ev

    def _write_event(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write_event(self._event(_scalar_value(tag, value), step))

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        if not values:
            return
        summary = b"".join(
            _scalar_value(prefix + k, float(v)) for k, v in values.items()
        )
        self._write_event(self._event(summary, step))

    def text(self, tag: str, content: str, step: int) -> None:
        self._write_event(self._event(_text_value(tag, content), step))

    def image(self, tag: str, png_bytes: bytes, height: int, width: int,
              step: int, colorspace: int = 3) -> None:
        """Summary.Value{ tag=1, image=4: Summary.Image{height=1, width=2,
        colorspace=3, encoded_image_string=4} } — the reference's
        caption-on-image summaries (soloist TensorBoardCaption.py:49-99)."""
        img = (
            _int64_field(1, height)
            + _int64_field(2, width)
            + _int64_field(3, colorspace)
            + _bytes_field(4, png_bytes)
        )
        value = _bytes_field(1, tag.encode()) + _bytes_field(4, img)
        self._write_event(self._event(value, step))

    def close(self) -> None:
        self._f.close()


def encode_png(rgb: "np.ndarray") -> bytes:
    """Minimal PNG encoder for (H, W, 3) uint8 arrays (zlib + filters=0);
    keeps the writer dependency-free."""
    import zlib

    import numpy as np

    a = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = a.shape
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def render_caption_image(image, caption: str) -> tuple[bytes, int, int]:
    """The JAX package draws the caption banner with matplotlib, which the
    port does not use; caption-on-image previews wait."""
    raise NotImplementedError(
        "render_caption_image needs matplotlib, which the port does not "
        "use; caption-on-image previews wait for a renderer of their own "
        "(ROADMAP M14)")

"""Minimal TensorBoard scalar/text event writer — no TF dependency.

The reference logs per-batch scalars and epoch-end caption text to
TensorBoard (main.py:202-211, Callbacks/Predict.py:27-46). This image has no
TensorFlow, so the TFRecord event framing (length + masked crc32c + payload)
and the Event/Summary protobufs are hand-encoded here (both formats are
stable, documented wire formats). Scalars, text and images: an event's
``summary`` (field 5) holds each ``Summary.Value`` in its repeated
``value`` field (1), the layout TensorBoard's own parser reads.

The port's own copy of ``masters_thesis_tpu/utils/tensorboard.py``
(``EventWriter`` and ``encode_png``, held against the originals by
``tests/test_torch_copies.py``). The JAX writer puts each value's fields
straight into the summary, without the ``value`` wrapper, which
TensorBoard's parser refuses; the port's writes the same tags, steps and
values in the wrapped layout. ``render_caption_image`` is the port's
own: the JAX one draws with matplotlib, which the card's machine lacks, so
the port draws the caption in a bitmap font kept in this module.
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


def _summary(*values: bytes) -> bytes:
    """Summary{ value=1 (repeated Summary.Value) }."""
    return b"".join(_bytes_field(1, v) for v in values)


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
        self._write_event(self._event(_summary(_scalar_value(tag, value)),
                                      step))

    def scalars(self, values: dict, step: int, prefix: str = "") -> None:
        if not values:
            return
        summary = _summary(*(_scalar_value(prefix + k, float(v))
                             for k, v in values.items()))
        self._write_event(self._event(summary, step))

    def text(self, tag: str, content: str, step: int) -> None:
        self._write_event(self._event(_summary(_text_value(tag, content)),
                                      step))

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
        self._write_event(self._event(_summary(value), step))

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


# A fixed 6 x 12 bitmap font for printable ASCII ("!" .. "~"; the space is
# blank): each glyph is 12 rows of 6 bits, the top row first, the leftmost
# pixel the highest bit, as two hex digits a row. Rasterised from DejaVu Sans
# Mono at 10 px (its licence permits derived bitmaps), baseline at row 9.
GLYPH_W, GLYPH_H = 6, 12
_GLYPHS = (
    "000404040404000004000000", "000a0a0a0000000000000000",  # !"
    "000a0a1f0a143e1414000000", "00040e14140e05051e040000",  # #$
    "00102828120c160906000000", "001c1010182525221d000000",  # %&
    "000404040000000000000000", "000404080808080808040000",  # '(
    "001010080808080810100000", "0004150e1f04000000000000",  # )*
    "0000000808083e0808000000", "000000000000001010100000",  # +,
    "000000000000180000000000", "000000000000000808000000",  # -.
    "000404080810101020200000", "000e1111151111110e000000",  # /0
    "001c0404040404041f000000", "00380404040810203c000000",  # 12
    "001c02020c0202023c000000", "00040c1414243e0404000000",  # 34
    "003820203804040438000000", "000e18101e1111110e000000",  # 56
    "003e02040404080808000000", "000e11110e1111110e000000",  # 78
    "000e1111110f01030e000000", "000000080800000808000000",  # 9:
    "000000101000001010100000", "0000000106180c0300000000",  # ;<
    "000000003f003f0000000000", "000000100c03061800000000",  # =>
    "003804040810100010000000", "00000e112729292927100e00",  # ?@
    "000c0c0c12121e1221000000", "001e11111e1111111e000000",  # AB
    "000f0810101010080f000000", "001e1211111111121e000000",  # CD
    "001e10101e1010101e000000", "001e10101e10101010000000",  # EF
    "001e1020202622121e000000", "001111111f11111111000000",  # GH
    "003c1010101010103c000000", "001c04040404040438000000",  # IJ
    "001112141c14121211000000", "00101010101010101f000000",  # KL
    "003636363a2a222222000000", "001919191515131313000000",  # MN
    "000e1111111111110e000000", "001e1111111e101010000000",  # OP
    "000e1111111111110e020000", "001e1111111e131111000000",  # QR
    "000f10101c0301011e000000", "003e08080808080808000000",  # ST
    "00111111111111110e000000", "0021121212120c0c0c000000",  # UV
    "0021212d2d2e1a1212000000", "0012120c0c0c0a1221000000",  # WX
    "002222140808080808000000", "001f0302040408101f000000",  # YZ
    "000c08080808080808080c00", "002020101010080804040000",  # [\
    "001808080808080808081800", "001824240000000000000000",  # ]^
    "00000000000000000000003f", "101000000000000000000000",  # _`
    "0000001e010f11110f000000", "0010101e111111111e000000",  # ab
    "0000000e101010100e000000", "0001010f111111110f000000",  # cd
    "0000000e111f10100f000000", "001c103c1010101010000000",  # ef
    "0000000f111111110f010e00", "0010101c1212121212000000",  # gh
    "0004000c040404041f000000", "0004001c0404040404041800",  # ij
    "001010121418141212000000", "00301010101010100c000000",  # kl
    "0000003e2a2a2a2a2a000000", "0000001c1212121212000000",  # mn
    "0000000e111111110e000000", "0000001e111111111e101000",  # op
    "0000000f111111110f010100", "0000000f0808080808000000",  # qr
    "0000001e101806021c000000", "0010103c101010101c000000",  # st
    "00000012121212120e000000", "000000242424181818000000",  # uv
    "00000021212e1e1e12000000", "000000241818182424000000",  # wx
    "000000242424181808103000", "0000001e020408101e000000",  # yz
    "000c08080808100808080c00", "000404040404040404040400",  # {|
    "0030101010100c1010103000", "000000001c03000000000000",  # }~
)
_BANNER_PAD = 4          # pixels around the text
_TEXT_ONLY_WIDTH = 384   # the JAX figure's 4.0 in at 96 dpi


def _glyph(ch: str) -> "np.ndarray":
    """(GLYPH_H, GLYPH_W) bool pixels of ``ch``: blank for a space, a box
    for any character the font lacks."""
    import numpy as np

    code = ord(ch)
    if code == 32:
        return np.zeros((GLYPH_H, GLYPH_W), bool)
    if 33 <= code <= 126:
        rows = bytes.fromhex(_GLYPHS[code - 33])
        bits = np.unpackbits(np.frombuffer(rows, np.uint8)[:, None], axis=1)
        return bits[:, 2:].astype(bool)
    box = np.zeros((GLYPH_H, GLYPH_W), bool)
    box[1:10, 0] = box[1:10, 4] = box[1, 0:5] = box[9, 0:5] = True
    return box


def wrap_caption(caption: str, width: int) -> list[str]:
    """``caption`` in lines of at most ``width`` characters, broken at
    spaces, a word longer than a line cut into pieces; at least one
    line."""
    width = max(1, width)
    lines, line = [], ""
    for word in caption.split():
        while len(word) > width:
            if line:
                lines.append(line)
                line = ""
            lines.append(word[:width])
            word = word[width:]
        if not word:
            continue
        if line and len(line) + 1 + len(word) > width:
            lines.append(line)
            line = word
        else:
            line = f"{line} {word}" if line else word
    lines.append(line)
    return lines


def render_caption_image(image, caption: str) -> tuple[bytes, int, int]:
    """Render a caption banner above an (H, W, 3) image -> (png, h, w).

    The JAX package draws it with matplotlib; the port draws the caption
    in its own bitmap font (``_GLYPHS``), black on white, wrapped to the
    image's width, in a banner above the image, whose pixels stay as they
    are (an (H, W) image is grey, an alpha channel is dropped). Without an
    image the banner is the whole picture, ``_TEXT_ONLY_WIDTH`` wide (the
    betas models have no stimulus pixels at train time). ``h`` and ``w``
    are the PNG's size. The same arguments give the same bytes."""
    import numpy as np

    pixels = None
    if image is not None:
        pixels = np.asarray(image).astype(np.uint8)
        if pixels.ndim == 2:
            pixels = np.repeat(pixels[..., None], 3, axis=2)
        pixels = pixels[..., :3]
    width = _TEXT_ONLY_WIDTH if pixels is None else pixels.shape[1]
    lines = wrap_caption(caption, (width - 2 * _BANNER_PAD) // GLYPH_W)
    banner = np.full((2 * _BANNER_PAD + GLYPH_H * len(lines), width, 3), 255,
                     np.uint8)
    for i, line in enumerate(lines):
        y = _BANNER_PAD + i * GLYPH_H
        for j, ch in enumerate(line):
            x = _BANNER_PAD + j * GLYPH_W
            ink = _glyph(ch)[:, :max(0, min(GLYPH_W, width - x))]
            banner[y:y + GLYPH_H, x:x + ink.shape[1]][ink] = 0
    out = banner if pixels is None else np.concatenate([banner, pixels])
    return encode_png(out), int(out.shape[0]), int(out.shape[1])

"""The port's caption-image previews against the JAX package's, on the
CPU.

``CaptionImagePreview`` writes image summaries under the JAX callback's
tags and steps (driven by the same epochs through stand-in trainers, with
and without stimulus pictures); ``load_stimulus_images`` gives the
original's pictures from the same directory. The port draws with a bitmap
font of its own where the JAX package draws with matplotlib
(``utils/tensorboard.render_caption_image``): the stimulus pixels stand
unchanged under the caption's banner, the reported size is the PNG's, and
the same arguments give the same bytes."""

import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from masters_thesis_tpu.train import callbacks as jcb
from masters_thesis_tpu.utils import tensorboard as jtb
from masters_thesis_tpu_torch.data.tokenizer import Tokenizer
from masters_thesis_tpu_torch.train import callbacks as pcb
from masters_thesis_tpu_torch.utils import tensorboard as ptb

from torch_threads import one_thread  # noqa: F401

EPOCHS = 11


def _fields(buf):
    """(field number, value) pairs of one protobuf message."""
    out, i = [], 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        out.append((num, value))
    return out


def _varint(buf, i):
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def image_events(path, wrapped: bool = True):
    """[(step, tag, height, width, png)] of an event file's images. The
    port's writer puts each value (tag 1, image 4) in the repeated
    ``value`` field 1 of the event's summary field 5, as TensorBoard reads
    it; the JAX writer (``wrapped=False``) puts the value's fields straight
    into the summary."""
    data, i, out = open(path, "rb").read(), 0, []
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        event = dict(_fields(data[i + 12:i + 12 + n]))
        i += 16 + n
        summary = event.get(5, b"")
        values = ([v for num, v in _fields(summary) if num == 1] if wrapped
                  else [summary])
        for value in map(dict, map(_fields, values)):
            if 4 in value:
                img = dict(_fields(value[4]))
                out.append((event[2], value[1].decode(), img[1], img[2],
                            img[4]))
    return out


def decode_png(png):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG whose rows all carry
    filter 0, as ``encode_png`` writes them."""
    i, idat, (w, h) = 8, b"", struct.unpack(">II", png[16:24])
    while i < len(png):
        (n,) = struct.unpack(">I", png[i:i + 4])
        if png[i + 4:i + 8] == b"IDAT":
            idat += png[i + 8:i + 8 + n]
        i += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def _tokenizer():
    tok = Tokenizer(num_words=None)
    tok.fit_on_texts(["<start> a dog runs in the park <end>",
                      "<start> the cat sits on a mat <end>"])
    tok.install_pad()
    return tok


def _words(tok, epoch):
    ids = [tok.word_index[w] for w in ("a", "dog", "runs", "cat", "park")]
    return np.asarray([[ids[(epoch + r + t) % 5] for t in range(4)]
                       for r in range(6)], np.int32)


def _drive(module, logdir, images, jax_side):
    tok = _tokenizer()
    epoch_box = [0]

    def decoder(*args):
        words = _words(tok, epoch_box[0])
        return (words, None, None) if jax_side else (torch.from_numpy(words),
                                                     None)

    batch = {"idx": np.arange(6, dtype=np.int32)}
    if jax_side:
        batch["betas"] = np.zeros((6, 3), np.float32)
    cb = module.CaptionImagePreview(str(logdir), decoder, batch, tok,
                                    images=images, every=5)
    trainer = SimpleNamespace(
        state=SimpleNamespace(model=torch.nn.Linear(1, 1), params={},
                              batch_stats={}),
        _batch_arrays=lambda b: (torch.zeros(6, 3),))
    cb.on_train_begin(trainer)
    for epoch in range(EPOCHS):
        epoch_box[0] = epoch
        cb.on_epoch_end(trainer, epoch, {})
    cb.on_train_end(trainer)
    (path,) = logdir.glob("events.out.tfevents.*.captions")
    return image_events(path, wrapped=not jax_side)


def _pictures():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (40, 60, 3), dtype=np.uint8), None,
            rng.integers(0, 256, (24, 30), dtype=np.uint8), None]


@pytest.mark.parametrize("images", [None, "pictures"])
def test_preview_tags_and_steps_match_the_jax_callback(tmp_path, images):
    images = _pictures() if images else None
    got = _drive(pcb, tmp_path / "port", images, False)
    want = _drive(jcb, tmp_path / "jax", images, True)
    assert [(s, t) for s, t, *_ in got] == [(s, t) for s, t, *_ in want]
    assert [s for s, *_ in got] == [0] * 4 + [5] * 4 + [10] * 4
    for step, tag, h, w, png in got:
        assert struct.unpack(">II", png[16:24]) == (w, h)
    if images:
        # the picture of sample 0 stands under its banner, unchanged
        pixels = decode_png(got[0][4])
        np.testing.assert_array_equal(pixels[-40:], images[0])


def test_caption_events_read_with_tensorboards_parser(tmp_path):
    """Every record of the port's caption-image event file parses with
    TensorBoard's own ``Event``, to the images ``image_events`` reads."""
    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    got = _drive(pcb, tmp_path / "port", _pictures(), False)
    (path,) = (tmp_path / "port").glob("events.out.tfevents.*.captions")
    data, i, parsed = path.read_bytes(), 0, []
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        event = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
        i += 16 + n
        parsed += [(event.step, v.tag, v.image.height, v.image.width,
                    v.image.encoded_image_string)
                   for v in event.summary.value]
    assert parsed == got and len(parsed) == 12


def test_stimulus_pixels_stand_unchanged_under_the_banner():
    img = np.random.default_rng(1).integers(0, 256, (50, 70, 3),
                                            dtype=np.uint8)
    png, h, w = ptb.render_caption_image(img, "a dog runs " * 6)
    pixels = decode_png(png)
    assert (h, w) == pixels.shape[:2] and w == 70 and h > 50
    np.testing.assert_array_equal(pixels[h - 50:], img)
    banner = pixels[:h - 50]
    assert (banner == 0).any() and (banner == 255).any()
    assert set(np.unique(banner)) == {0, 255}
    # the wrapped caption fills several lines of the banner
    assert h - 50 >= 2 * ptb._BANNER_PAD + 3 * ptb.GLYPH_H


def test_grey_and_alpha_pictures_keep_their_pixels():
    rng = np.random.default_rng(2)
    grey = rng.integers(0, 256, (9, 20), dtype=np.uint8)
    rgba = rng.integers(0, 256, (9, 20, 4), dtype=np.uint8)
    for img, want in ((grey, np.repeat(grey[..., None], 3, 2)),
                      (rgba, rgba[..., :3])):
        png, h, w = ptb.render_caption_image(img, "a cat")
        np.testing.assert_array_equal(decode_png(png)[h - 9:], want)


def test_render_is_deterministic_and_sized_by_its_png():
    img = np.random.default_rng(3).integers(0, 256, (16, 64, 3),
                                            dtype=np.uint8)
    for image in (None, img):
        a = ptb.render_caption_image(image, "two zebras grazing {x} ~ é")
        assert a == ptb.render_caption_image(image, "two zebras grazing "
                                             "{x} ~ é")
        png, h, w = a
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert struct.unpack(">II", png[16:24]) == (w, h)
    # a text-only banner is as wide as the JAX figure (4 in at 96 dpi)
    assert ptb.render_caption_image(None, "a")[2] == 384
    # the JAX renderer also reports its PNG's own size
    png, h, w = jtb.render_caption_image(None, "a dog")
    assert struct.unpack(">II", png[16:24]) == (w, h)


def test_unknown_characters_draw_a_box_and_spaces_nothing():
    box, space = ptb._glyph("é"), ptb._glyph(" ")
    assert box.any() and not space.any()
    assert box.shape == ptb._glyph("A").shape == (ptb.GLYPH_H, ptb.GLYPH_W)
    # every printable character has ink, and no two share a glyph
    glyphs = {chr(c): ptb._glyph(chr(c)).tobytes() for c in range(33, 127)}
    assert all(np.frombuffer(g, bool).any() for g in glyphs.values())
    assert len(set(glyphs.values())) == 94


@pytest.mark.parametrize("caption,width,want", [
    ("a dog runs in the park", 10, ["a dog runs", "in the", "park"]),
    ("", 5, [""]),
    ("abcdefghijk", 4, ["abcd", "efgh", "ijk"]),
    ("a  b", 1, ["a", "b"]),
])
def test_wrap_caption(caption, width, want):
    assert ptb.wrap_caption(caption, width) == want


def test_load_stimulus_images_matches_original(tmp_path):
    """npy pictures load, a corrupt PNG falls through to the key's npy, a
    key without a file is None, and a directory without any is None."""
    from PIL import Image

    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (7, 4, 3), dtype=np.uint8)
    np.save(tmp_path / "KID1.npy", a)
    (tmp_path / "KID2.png").write_bytes(b"\x89PNG not a png")
    np.save(tmp_path / "KID2.npy", b)
    Image.fromarray(a).save(tmp_path / "KID4.png")
    (tmp_path / "empty").mkdir()
    for args in ((str(tmp_path), [1, 2, 3, 4]), (str(tmp_path), [4, 1], 1),
                 (str(tmp_path / "empty"), [1]), ("", [1]),
                 (str(tmp_path / "missing"), [1])):
        got = pcb.load_stimulus_images(*args)
        want = jcb.load_stimulus_images(*args)
        if want is None:
            assert got is None
            continue
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)

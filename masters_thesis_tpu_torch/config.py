"""Config system: the run configuration, read from and written to YAML.

Counterpart of ``masters_thesis_tpu/config.py``, with the same dataclasses,
field names and defaults (reference AttemptFour/config.yaml), so a
``config.yaml`` that either package wrote loads in the other to the same
``to_dict()``. Unknown keys are ignored, as the JAX package ignores unknown
reference keys, and ``from_dict`` takes values as they come.

The card's machine has no PyYAML, so ``load`` reads YAML with the port's
own reader of the subset that ``configs/*.yaml`` and PyYAML's
``safe_dump`` of a config use: ``#`` comments, nested block mappings,
plain, single- and double-quoted scalars resolved as PyYAML resolves them
(null, bool, decimal int, float with a dot and an optional exponent, else
a string), and lists, in flow (``[1, 2]``, ``[]``) or block (``- 1``) style,
of such scalars. Anything else (anchors, tags, block scalars, flow
mappings, several documents, a tab in the indentation) raises ``ValueError``
naming its line. ``save`` writes YAML that PyYAML reads back to the same
dict.

Every knob of the JAX package's schema is honoured, on the card as on
the CPU; ``prng_impl`` is recorded and changes nothing,
because torch's generators draw every mask, and ``param_dtype`` changes
nothing, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DatasetConfig:
    """Data-store paths (reference config.yaml:16-22)."""

    betas_path: str = ""
    captions_path: str = ""
    betas_path_b: str = ""       # second subject (ms2_nic)
    captions_path_b: str = ""
    vgg16_path: str = ""
    guse_path: str = ""
    nsd_dir: str = ""
    images_path: str = ""        # stimulus pictures for caption previews
    synthetic: str = ""          # "" | "structured" | "compositional"
    #                              (data/synthetic.py)


@dataclass
class InputConfig:
    """Input-width options (reference config.yaml:48-53)."""

    full: int = 327_684
    vc: int = 62_756
    pca: int = 5_000
    mscoco: int = 4_096


@dataclass
class TPUConfig:
    """The JAX package's ``tpu:`` knobs, by the same names. On the card:
    ``use_pallas: false`` takes the JAX package's plain paths, every gather
    through the library take and every greedy decode through the step
    loop, so that K1, K2 and K3 make no launch; ``scan_steps`` > 0 trains
    from the device store; ``store_dtype``, ``fused_seq``, ``ckpt_every``,
    the mesh, vocab-padding and profiling knobs mean what they mean there.
    ``compute_dtype: bfloat16`` trains in bf16 on fp32 masters on a CUDA
    device and in fp32 on the CPU, as the JAX package does only on its TPU
    (``train.steps._compute_dtype``);
    ``remat`` recomputes each decoder step in the backward
    (``models.nic.NIC``). ``prng_impl``, ``donate_state``,
    ``prefetch_depth`` and ``compile_cache_dir`` are XLA's and change
    nothing here; ``param_dtype`` is read by nothing, in the JAX package
    as here."""

    mesh_data: int = 1
    mesh_model: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    donate_state: bool = True
    prefetch_depth: int = 2
    use_pallas: bool = True          # the hand-written kernels (K1, K2,
    #                                  K3); false: the library take and
    #                                  the step-loop greedy decoder
    fused_seq: bool = False          # train the decoder through the fused
    #                                  sequence's custom backward
    #                                  (ops/fused_seq.py)
    remat: bool = False
    scan_steps: int = 0              # > 0: K optimisation steps per call
    #                                  from the device store
    profile_steps: int = 0
    profile_trace: bool = False
    compile_cache_dir: str = "~/.cache/masters_thesis_tpu/xla"
    prng_impl: str = "default"
    store_dtype: str = "float32"     # device store: float32 | bfloat16
    ckpt_every: int = 1              # checkpoint cadence in epochs
    vocab_pad_multiple: int = 0


@dataclass
class Config:
    """Full run configuration, schema-compatible with the reference."""

    # run identity (config.yaml:2-5)
    run: str = "run"
    info: str = ""
    log: str = "./Log/"

    dataset: DatasetConfig = field(default_factory=DatasetConfig)

    seed: int = 42

    # training (config.yaml:26-34)
    epochs: int = 100
    batch_size: int = 64
    max_length: int = 15
    top_k: int = 5_000
    optimizer: str = "Adam"
    alpha: float = 1.0e-4            # learning rate
    clipnorm: float = 0.1            # per-tensor clipnorm (Keras semantics)
    decay: float = 0.0
    warmup_steps: int = 0            # linear LR warmup
    cosine_decay_steps: int = 0      # > 0: cosine LR decay over N steps
    beta_1: float = 0.9
    beta_2: float = 0.98
    epsilon: float = 1.0e-8

    # dropout (config.yaml:36-41)
    dropout_input: float = 0.0
    dropout_features: float = 0.2
    dropout_text: float = 0.2
    dropout_lstm: float = 0.2
    dropout_attn: float = 0.2
    dropout_out: float = 0.2

    # L2 regularisers (config.yaml:43-46)
    input_reg: float = 0.01
    attn_reg: float = 0.001
    lstm_reg: float = 3.0e-5
    output_reg: float = 1.0e-5

    input: InputConfig = field(default_factory=InputConfig)

    # model sizes (config.yaml:55-60)
    units: int = 512
    attn_units: int = 32
    group_size: int = 32
    embedding_features: int = 512
    embedding_text: int = 512

    # model and data selection
    model: str = "lc_nic"
    groups_to_remove: list = field(default_factory=list)
    input_kind: str = "full"         # full | vc | pca | mscoco
    attn_loss: bool = False          # off in the reference (lc_NIC.py:384)
    sam_rho: float = 0.0             # > 0 enables SAM (lc_NIC.py:713-838)
    agc_clip: float = 0.0            # > 0 enables adaptive gradient clipping
    caption_metrics_every: int = 0   # > 0: decoded val BLEU/CIDEr every N
    #                                  epochs (train.callbacks.CaptionMetrics)
    warm_start: str = ""             # run dir to preload matching weights from
    learned_init_state: bool = False
    glove_path: str = ""
    glove_trainable: bool = True

    tpu: TPUConfig = field(default_factory=TPUConfig)

    # ---- derived ----
    @property
    def vocab_size(self) -> int:
        """top_k + 1, as the reference (main.py)."""
        return self.top_k + 1

    @property
    def padded_vocab_size(self) -> int:
        """vocab_size rounded up to tpu.vocab_pad_multiple; == vocab_size
        when padding is off."""
        m = self.tpu.vocab_pad_multiple
        v = self.vocab_size
        return -(-v // m) * m if m and m > 1 else v

    def input_dim(self) -> int:
        return getattr(self.input, self.input_kind)

    # ---- (de)serialisation ----
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "w") as f:
            f.write(dump_yaml(self.to_dict()))

    @classmethod
    def from_dict(cls, raw: dict[str, Any] | None) -> "Config":
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        sub = {"dataset": DatasetConfig, "input": InputConfig,
               "tpu": TPUConfig}
        kwargs: dict[str, Any] = {}
        for key, val in raw.items():
            if key not in known:
                continue  # tolerate unknown reference keys
            if key in sub:
                # an empty `tpu:` section parses as None: use the defaults
                val = val or {}
                if not isinstance(val, dict):
                    raise TypeError(f"config section {key!r} must be a "
                                    f"mapping, got {type(val).__name__}")
                fields = {f.name for f in dataclasses.fields(sub[key])}
                kwargs[key] = sub[key](**{k: v for k, v in val.items()
                                          if k in fields})
            else:
                kwargs[key] = val
        return cls(**kwargs)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "Config":
        with open(path) as f:
            return cls.from_dict(load_yaml(f.read(), str(path)))


def load_config(path: str | os.PathLike) -> Config:
    return Config.load(path)


# ---------------------------------------------------------------- YAML subset

# PyYAML's implicit resolvers (YAML 1.1) for the forms the subset takes; the
# octal, hexadecimal, binary and sexagesimal forms are refused, not guessed
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
         **dict.fromkeys("no No NO false False FALSE off Off OFF".split(),
                         False)}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|^\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                  "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
                  "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
                  ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
_OTHER_NUMBER = re.compile(r"^[-+]?(?:0b[01_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                           r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$")
_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Lines:
    """The document's lines, for errors that name one."""

    def __init__(self, text: str, source: str):
        self.lines = text.splitlines()
        self.source = source

    def error(self, lineno: int, what: str) -> ValueError:
        line = self.lines[lineno] if lineno < len(self.lines) else ""
        return ValueError(f"{self.source}:{lineno + 1}: {what} (outside the "
                          f"YAML subset the config reader takes): {line!r}")


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment: one at the start or after white
    space, outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(text: str, lines: _Lines, lineno: int) -> tuple[str, str]:
    """A quoted scalar at the start of ``text`` -> (its value, the rest)."""
    q = text[0]
    out = []
    i = 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc in _DQ_ESCAPES:
                out.append(_DQ_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_ESCAPES:
                digits = text[i + 2:i + 2 + _HEX_ESCAPES[esc]]
                if (len(digits) == _HEX_ESCAPES[esc]
                        and all(c in "0123456789abcdefABCDEF" for c in digits)):
                    out.append(chr(int(digits, 16)))
                    i += 2 + len(digits)
                    continue
            raise lines.error(lineno, f"escape \\{esc} in a double-quoted "
                              f"string")
        out.append(ch)
        i += 1
    raise lines.error(lineno, "a quoted string that does not end on its line")


def _plain(text: str, lines: _Lines, lineno: int):
    """A plain scalar, resolved as PyYAML resolves it."""
    if text[:1] in set("&*!|>%@`{}[]"):
        raise lines.error(lineno, f"the indicator {text[0]!r}")
    if ": " in text or text.endswith(":"):
        raise lines.error(lineno, "a mapping where a scalar belongs")
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _OTHER_NUMBER.match(text):
        raise lines.error(lineno, f"the number form {text!r}")
    return text


def _scalar(text: str, lines: _Lines, lineno: int):
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lines, lineno)
        if rest.strip():
            raise lines.error(lineno, "text after a quoted string")
        return value
    return _plain(text, lines, lineno)


def _flow_list(text: str, lines: _Lines, lineno: int) -> list:
    """``[a, 'b', 3]`` -> a list of scalars."""
    if not text.endswith("]"):
        raise lines.error(lineno, "a flow list that does not end on its "
                          "line")
    body = text[1:-1].strip()
    items: list = []
    while body:
        if body[0] in ("'", '"'):
            value, body = _quoted(body, lines, lineno)
            items.append(value)
            body = body.strip()
        else:
            cut = body.find(",")
            item = body if cut < 0 else body[:cut]
            if not item.strip():
                raise lines.error(lineno, "an empty flow-list item")
            if item.strip()[:1] in "[{":
                raise lines.error(lineno, "a nested flow collection")
            items.append(_plain(item.strip(), lines, lineno))
            body = "" if cut < 0 else body[cut:]
        if body.startswith(","):
            body = body[1:].strip()
            if not body:
                raise lines.error(lineno, "a trailing comma")
        elif body:
            raise lines.error(lineno, "items not separated by commas")
    return items


def _value(text: str, lines: _Lines, lineno: int):
    text = text.strip()
    if text.startswith("["):
        return _flow_list(text, lines, lineno)
    return _scalar(text, lines, lineno)


def _key(text: str, lines: _Lines, lineno: int) -> tuple[str, str]:
    """``key: rest`` -> (key, rest)."""
    if text[:1] in ("'", '"'):
        key, rest = _quoted(text, lines, lineno)
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            raise lines.error(lineno, "a quoted key without ': '")
        return key, rest[1:]
    cut = text.find(": ")
    if cut < 0:
        if not text.endswith(":"):
            raise lines.error(lineno, "a line that is not 'key: value'")
        cut = len(text) - 1
    key = text[:cut]
    if not key or key[0] in set("&*!|>%@`{}[]?-"):
        raise lines.error(lineno, f"the key {key!r}")
    return key, text[cut + 1:]


def load_yaml(text: str, source: str = "<yaml>") -> dict:
    """Parse the YAML subset described in the module docstring into
    nested dicts, lists and scalars, as ``yaml.safe_load`` would."""
    lines = _Lines(text, source)
    rows = []                                  # (lineno, indent, content)
    for lineno, raw in enumerate(lines.lines):
        if raw.strip() in ("---", "..."):
            if rows:
                raise lines.error(lineno, "a second document")
            continue
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise lines.error(lineno, "a tab in the indentation")
        if stripped.startswith("%"):
            raise lines.error(lineno, "a directive")
        rows.append((lineno, len(body) - len(stripped), stripped))
    if not rows:
        return None
    pos = 0

    def block(indent: int):
        """The block collection whose lines start at ``indent``."""
        nonlocal pos
        lineno, _, content = rows[pos]
        if content == "-" or content.startswith("- "):
            return sequence(indent)
        return mapping(indent)

    def sequence(indent: int) -> list:
        nonlocal pos
        out = []
        while pos < len(rows) and rows[pos][1] == indent:
            lineno, _, content = rows[pos]
            if not (content == "-" or content.startswith("- ")):
                break
            item = content[1:].strip()
            if not item:
                raise lines.error(lineno, "a nested block in a list")
            out.append(_scalar(item, lines, lineno))
            pos += 1
        return out

    def mapping(indent: int) -> dict:
        nonlocal pos
        out: dict = {}
        while pos < len(rows):
            lineno, ind, content = rows[pos]
            if ind < indent:
                break
            if ind > indent:
                raise lines.error(lineno, "an indentation that matches no "
                                  "mapping")
            if content == "-" or content.startswith("- "):
                raise lines.error(lineno, "a list item among mapping keys")
            key, rest = _key(content, lines, lineno)
            pos += 1
            if rest.strip():
                out[key] = _value(rest, lines, lineno)
                continue
            # an empty value: a nested block (deeper, or a block list at the
            # same indent, as PyYAML's dump writes it), else null
            if pos < len(rows):
                nxt_lineno, nxt_ind, nxt = rows[pos]
                is_item = nxt == "-" or nxt.startswith("- ")
                if nxt_ind > indent or (nxt_ind == indent and is_item):
                    out[key] = block(nxt_ind)
                    continue
            out[key] = None
        return out

    first_indent = rows[0][1]
    value = block(first_indent)
    if pos < len(rows):
        raise lines.error(rows[pos][0], "a line outside the document's "
                          "block")
    if not isinstance(value, dict):
        raise lines.error(rows[0][0], "a document that is not a mapping")
    return value


def _dump_scalar(value) -> str:
    """One scalar as PyYAML's ``safe_dump`` would resolve it back."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        # PyYAML reads 1e-08 as a string: its floats need a dot
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        return json.dumps(value, ensure_ascii=False)
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as a "
                    f"config scalar")


def dump_yaml(data: dict, indent: int = 0) -> str:
    """Nested dicts (keys: field names) of scalars and lists of scalars ->
    YAML text, in block style with two-space indentation and flow lists."""
    out = []
    pad = " " * indent
    for key, value in data.items():
        if isinstance(value, dict):
            out.append(f"{pad}{key}:\n{dump_yaml(value, indent + 2)}")
        elif isinstance(value, (list, tuple)):
            items = ", ".join(_dump_scalar(v) for v in value)
            out.append(f"{pad}{key}: [{items}]\n")
        else:
            out.append(f"{pad}{key}: {_dump_scalar(value)}\n")
    return "".join(out)

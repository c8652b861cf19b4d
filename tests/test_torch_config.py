"""The port's config reader and writer against the JAX package's
``Config`` (PyYAML): every file of ``configs/`` loads to the same
``to_dict()``; a config either package saved loads in the other to the same
dict; the reader parses as ``yaml.safe_load`` does, and input outside its
YAML subset raises, naming the line."""

from pathlib import Path

import pytest
import yaml

from masters_thesis_tpu.config import Config as JConfig
from masters_thesis_tpu_torch.config import (
    Config,
    dump_yaml,
    load_config,
    load_yaml,
)

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs")
                 .glob("*.yaml"))


def test_every_shipped_config_is_covered():
    assert len(CONFIGS) == 11


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_file_loads_as_the_jax_config(path):
    assert Config.load(path).to_dict() == JConfig.load(path).to_dict()
    assert load_config(path) == Config.load(path)
    assert load_yaml(path.read_text()) == yaml.safe_load(path.read_text())


def _edited(cls):
    cfg = cls.load(CONFIGS[0])       # attempt_four: a groups_to_remove list
    cfg.info = "a: b # not a comment 'q' \"dq\" \\ ü\n\ttab"
    cfg.run = "yes"                  # a string PyYAML would read as a bool
    cfg.log = "0x1F"                 # ... or as a number
    cfg.epsilon = 1e-8               # PyYAML reads "1e-08" as a string
    cfg.alpha = 2.5e20
    cfg.sam_rho = float("inf")
    cfg.dataset.synthetic = "structured"
    cfg.dataset.nsd_dir = ""
    cfg.tpu.compile_cache_dir = "~/x"
    cfg.tpu.prng_impl = "rbg"
    cfg.warm_start = "null"
    return cfg


def test_port_saved_config_loads_in_jax(tmp_path):
    cfg = _edited(Config)
    cfg.save(tmp_path / "c.yaml")
    assert JConfig.load(tmp_path / "c.yaml").to_dict() == cfg.to_dict()
    assert Config.load(tmp_path / "c.yaml") == cfg
    assert yaml.safe_load((tmp_path / "c.yaml").read_text()) == cfg.to_dict()


def test_jax_saved_config_loads_in_the_port(tmp_path):
    jcfg = _edited(JConfig)
    jcfg.save(tmp_path / "c.yaml")
    assert Config.load(tmp_path / "c.yaml").to_dict() == jcfg.to_dict()


@pytest.mark.parametrize("value", [0.1, 1e-8, 3e-05, 1e16, -2.0, 1.5e300,
                                   123456789.0, 0.0, True, False, None, 7,
                                   -3, "", "1e-8", "true", "~", "- x",
                                   "[1]", "a #b", "'", '"'])
def test_scalars_round_trip_through_pyyaml(value):
    text = dump_yaml({"k": value, "l": [value, value]})
    assert yaml.safe_load(text) == {"k": value, "l": [value, value]}
    assert load_yaml(text) == {"k": value, "l": [value, value]}


def test_reader_parses_the_subset_as_pyyaml():
    text = ("---\n# head\nrun: smoke   # trailing\nn: 1_000\nx: .5\ny: +1.\n"
            "s: 'it''s'\nd: \"a\\tb\\u00e9\"\nb: [1, 'two', 3.0e+2]\n"
            "e: []\nz: ~\nnest:\n  inner:\n    deep: on\n  other: Off\n"
            "seq:\n- 1\n- b\nempty:\n")
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,what", [
    ("a: &x 1\n", "indicator '&'"),
    ("a: *x\n", "indicator '\\*'"),
    ("a: !!str 1\n", "indicator '!'"),
    ("a: |\n  text\n", "indicator '\\|'"),
    ("a: >\n  text\n", "indicator '>'"),
    ("a: {b: 1}\n", "indicator '{'"),
    ("a: 1\n---\nb: 2\n", "second document"),
    ("a: 0x1F\n", "number form"),
    ("a: 017\n", "number form"),
    ("a: 1:30\n", "number form"),
    ("a: [1, [2]]\n", "nested flow"),
    ("a:\n\t b: 1\n", "tab"),
    ("- 1\n- 2\n", "not a mapping"),
    ("a: 'open\n", "does not end"),
    ("a: \"\\q\"\n", "escape"),
    ("a:\n  b: 1\n c: 2\n", None),
    ("a: b: c\n", "mapping where a scalar"),
    ("a: 1\nno colon here\n", "not 'key: value'"),
    ("%YAML 1.1\na: 1\n", "directive"),
    ("a:\n- [1]\n", None),
])
def test_outside_the_subset_raises_naming_the_line(text, what):
    with pytest.raises(ValueError, match=r"cfg\.yaml:\d+: ") as err:
        load_yaml(text, "cfg.yaml")
    if what is not None:
        assert err.match(what)

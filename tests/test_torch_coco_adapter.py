"""The port's copy of ``evalsuite/coco_adapter.py`` against the original,
on the inputs of ``tests/test_coco_adapter.py``: every function gives the
original's result and writes the original's files."""

import json

import pytest

from masters_thesis_tpu.evalsuite import coco_adapter as jca
from masters_thesis_tpu_torch.evalsuite import coco_adapter as pca

from torch_threads import one_thread  # noqa: F401

STIM = ("Unnamed: 0,nsdId,cocoId,cocoSplit\n"
        "0,0,531124,train2017\n"
        "1,1,104612,val2017\n"
        "2,72999,87531,train2017\n")
ANNOTATIONS = {"annotations": [
    {"image_id": 101, "caption": "A dog runs fast."},
    {"image_id": 101, "caption": "The dog is running."},
    {"image_id": 202, "caption": "A red car parked."},
]}


def _map(m, d):
    (d / "map.csv").write_text("nsd_key,coco_id\n7,101\n9,202\n")
    return m.load_nsd_coco_map(str(d / "map.csv"))


def _results(m, d):
    out = m.write_coco_results(str(d / "results.json"), [7, 9],
                               ["a dog runs", "a red car"], _map(m, d))
    plain = m.write_coco_results(str(d / "plain.json"), [3], ["a cat"])
    return out, plain, (d / "results.json").read_text(), \
        (d / "plain.json").read_text()


def _annotations(m, d):
    (d / "ann.json").write_text(json.dumps(ANNOTATIONS))
    return m.load_coco_annotations(str(d / "ann.json"))


def _stim(m, d):
    (d / "stim.csv").write_text(STIM)
    info = m.load_stim_info(str(d / "stim.csv"))
    n = m.export_nsd_coco_csv(str(d / "stim.csv"), str(d / "out.csv"))
    return (info, m.nsd_coco_map_from_stim_info(info), n,
            (d / "out.csv").read_text(),
            m.load_nsd_coco_map(str(d / "out.csv")))


def _score(m, d):
    return m.score_against_coco([7, 9], ["a dog runs", "A red car"],
                                _map(m, d), _annotations(m, d))


CASES = {"load_nsd_coco_map": _map, "write_coco_results": _results,
         "load_coco_annotations": _annotations,
         "load_stim_info and export_nsd_coco_csv": _stim,
         "score_against_coco": _score}


@pytest.mark.parametrize("case", sorted(CASES))
def test_coco_adapter_matches_original(case, tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = CASES[case](pca, tmp_path / "p")
    want = CASES[case](jca, tmp_path / "j")
    assert got == want
    if case == "score_against_coco":
        assert got["Bleu_1"] > 0.5


def test_stim_info_keys_are_one_based(tmp_path):
    (tmp_path / "stim.csv").write_text(STIM)
    info = pca.load_stim_info(str(tmp_path / "stim.csv"))
    assert info[1] == {"coco_id": 531124, "coco_split": "train2017"}
    assert info[73000]["coco_id"] == 87531

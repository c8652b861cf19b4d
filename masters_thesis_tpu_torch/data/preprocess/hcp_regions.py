"""HCP-MMP1.0 (Glasser et al. 2016) cortical parcel names.

The reference labels its region tables/figures from a lab-filesystem CSV
(``TrainData/unique_regions_list.csv``, Eval/list_regions.py:33) that is not
shipped. The parcellation itself is public: 180 areas per hemisphere in the
canonical HCP-MMP1.0 label order (label 1 = V1 ... label 180 = p24), the same
order carried by the ``lh/rh.HCP_MMP1`` annotation files the group builder
consumes (glasser.py: group index i -> label i+1 per hemisphere, LH block
first).

``region_names`` produces display names aligned with ``groups_from_atlas``
output; pass ``names_csv`` to override with a custom table (the reference
CSV, if available).

The port's own copy of ``masters_thesis_tpu/data/preprocess/hcp_regions.py``, with the same
names and meaning (``tests/test_torch_ingest.py`` holds the two together).
"""

from __future__ import annotations

# Canonical HCP-MMP1.0 parcel names, index i -> label i+1.
HCP_MMP1_REGIONS = [
    "V1", "MST", "V6", "V2", "V3", "V4", "V8", "4", "3b", "FEF",
    "PEF", "55b", "V3A", "RSC", "POS2", "V7", "IPS1", "FFC", "V3B", "LO1",
    "LO2", "PIT", "MT", "A1", "PSL", "SFL", "PCV", "STV", "7Pm", "7m",
    "POS1", "23d", "v23ab", "d23ab", "31pv", "5m", "5mv", "23c", "5L",
    "24dd", "24dv", "7AL", "SCEF", "6ma", "7Am", "7PL", "7PC", "LIPv",
    "VIP", "MIP", "1", "2", "3a", "6d", "6mp", "6v", "p24pr", "33pr",
    "a24pr", "p32pr", "a24", "d32", "8BM", "p32", "10r", "47m", "8Av",
    "8Ad", "9m", "8BL", "9p", "10d", "8C", "44", "45", "47l", "a47r",
    "6r", "IFJa", "IFJp", "IFSp", "IFSa", "p9-46v", "46", "a9-46v",
    "9-46d", "9a", "10v", "a10p", "10pp", "11l", "13l", "OFC", "47s",
    "LIPd", "6a", "i6-8", "s6-8", "43", "OP4", "OP1", "OP2-3", "52",
    "RI", "PFcm", "PoI2", "TA2", "FOP4", "MI", "Pir", "AVI", "AAIC",
    "FOP1", "FOP3", "FOP2", "PFt", "AIP", "EC", "PreS", "H", "ProS",
    "PeEc", "STGa", "PBelt", "A5", "PHA1", "PHA3", "STSda", "STSdp",
    "STSvp", "TGd", "TE1a", "TE1p", "TE2a", "TF", "TE2p", "PHT", "PH",
    "TPOJ1", "TPOJ2", "TPOJ3", "DVT", "PGp", "IP2", "IP1", "IP0",
    "PFop", "PF", "PFm", "PGi", "PGs", "V6A", "VMV1", "VMV3", "PHA2",
    "V4t", "FST", "V3CD", "LO3", "VMV2", "31pd", "31a", "VVC", "25",
    "s32", "pOFC", "PoI1", "Ig", "FOP5", "p10p", "p47r", "TGv", "MBelt",
    "LBelt", "A4", "STSva", "TE1m", "PI", "a32pr", "p24",
]


_HEADER_WORDS = frozenset(
    "region regions name names parcel parcels label labels area areas "
    "description region_name area_description".split())


def load_names_csv(path: str) -> list[str]:
    """One region name per line (optionally 'index,name' rows).

    Header detection: the FIRST row is dropped when its last cell matches a
    common header word (region/name/parcel/label/area variants) — an
    unskipped header would shift every region name by one position."""
    names: list[str] = []
    first_data_row = True
    with open(path, encoding="utf-8-sig") as f:  # -sig: Excel exports BOM
        for line in f:
            line = line.strip()
            if not line:
                continue
            cell = line.split(",")[-1].strip()
            # header check binds to the first NON-EMPTY row, not raw line 0:
            # a leading blank line used to push the header into the data and
            # shift all 180 names by one
            if first_data_row:
                first_data_row = False
                if cell.lower().replace(" ", "_") in _HEADER_WORDS:
                    continue
            names.append(cell)
    return names


def region_names(
    groups_to_remove=None,
    names_csv: str | None = None,
    n_per_hemi: int = 180,
) -> list[str]:
    """Display names for the LH+RH group list (groups_from_atlas order),
    minus any removed indices — aligned with the attention columns of a
    run that used ``cfg.groups_to_remove``."""
    base = load_names_csv(names_csv) if names_csv else HCP_MMP1_REGIONS
    base = list(base)[:n_per_hemi]
    names = [f"LH_{n}" for n in base] + [f"RH_{n}" for n in base]
    if groups_to_remove:
        rm = set(groups_to_remove)
        names = [n for i, n in enumerate(names) if i not in rm]
    return names

"""Dataset name registry for the T2S CSV track (counterpart of
t2ms_tpu/data/registry.py, a copy: the port imports nothing of the JAX
package).

Mirrors the name -> CSV-stem map at reference datafactory/dataloader.py:26-78
(TSFragment-600K families x {24,48,96}, MMD six domains, SUSHI) plus the
root-directory rules in loader_provider (dataloader.py:79-113).
"""

from __future__ import annotations

import os

__all__ = ["DATA_DICT", "csv_path_for", "MIXABLE_FAMILIES"]

MIXABLE_FAMILIES = ["ETTh1", "ETTm1", "traffic", "airquality", "exchangerate",
                    "weather", "electricity", "nationalillness"]

_FAMS = ["ETTh1", "ETTm1", "airquality", "electricity", "exchangerate",
         "traffic"]
_MMD = ["Agriculture", "Climate", "Health_US", "Traffic", "Economy",
        "SocialGood"]

DATA_DICT = {}
for fam in _FAMS:
    DATA_DICT[fam] = f"embedding_cleaned_{fam}"
    for L in (24, 48, 96):
        DATA_DICT[f"{fam}_{L}"] = f"embedding_cleaned_{fam}_{L}"
for dom in _MMD:
    DATA_DICT[f"MMD-{dom}"] = f"embedding_cleaned_{dom}"
    for L in (24, 48, 96):
        DATA_DICT[f"MMD-{dom}_{L}"] = f"embedding_cleaned_{dom}_{L}"
DATA_DICT["SUSHI"] = "embedding_cleaned_SUSHI"


def csv_path_for(dataset_name: str, data_root: str = "./Data",
                 mix_train: bool = False) -> str:
    """Directory holding the CSVs for a dataset name
    (dataloader.py:82-110 root rules)."""
    family = dataset_name.split("_")[0]
    if dataset_name == "SUSHI":
        return os.path.join(data_root, "SUSHI")
    if dataset_name.split("-")[0] == "MMD":
        return os.path.join(data_root, "MMD")
    if family in MIXABLE_FAMILIES:
        if mix_train and dataset_name != family:
            # the mix path admits only bare family names (reference
            # dataloader.py:84-99 raises); accepting 'ETTh1_24' here
            # would compose double-suffixed nonexistent CSV names and
            # fail far away with a confusing FileNotFoundError
            raise ValueError(
                f"mix_train expects a bare family name (e.g. {family!r}),"
                f" got {dataset_name!r}")
        sub = "TSFragment-600K" if mix_train else "our"
        return os.path.join(data_root, sub)
    raise ValueError(f"unknown dataset {dataset_name}")

"""GPT-3 CUPL class descriptors.

Capability parity with engine/descriptors/{default,gpt3_descriptors}.py:
per-class descriptor sentences from the CUPL JSON files (vendored data under
uml_tpu/assets/descriptors/cupl/), with the reference's class-name munging
(stanford_cars year reordering, sun397 parenthetical tags) and optional
sentence-building / class-name positioning modes.
"""

from __future__ import annotations

import json
import os
import re

from uml_tpu_torch import ASSET_DIR

_ASSET_DIR = os.path.join(ASSET_DIR, "descriptors")

DESCRIPTOR_DICT = {
    "gpt3_cupl": {
        "position_class": None,
        "modify": False,
        "before_text": "",
        "between_text": "",
        "after_text": "",
        "combine": False,
        "dirname": "cupl",
    },
}


def descriptor_path(descriptor_type: str, dataset: str) -> str:
    dirname = DESCRIPTOR_DICT[descriptor_type]["dirname"]
    return os.path.join(_ASSET_DIR, dirname, f"descriptors_{dataset}.json")


def wordify(text: str) -> str:
    return text.replace("_", " ")


def make_sentence(desc: str) -> str:
    """Turn a bare descriptor into a 'which ...' clause (gpt3_descriptors.py:17-28)."""
    if desc.startswith(("a ", "an ")):
        return f"which is {desc}"
    if desc.startswith(("has", "often", "typically", "may", "can")):
        return f"which {desc}"
    if desc.startswith("used"):
        return f"which is {desc}"
    return f"which has {desc}"


def process_name(classname: str, dsname: str) -> str:
    """Dataset-specific class-key munging (gpt3_descriptors.py:35-48)."""
    if dsname == "stanford_cars":
        names = classname.split(" ")
        year = names.pop(-1)
        names.insert(0, year)
        return " ".join(names)
    if dsname == "sun397":
        match = re.match(r"(.+?)\s*\((.+?)\)", classname)
        if match:
            base = match.group(1).strip().replace(" ", "_")
            tag = match.group(2).strip()
            return f"{tag} {base}"
        return classname.replace(" ", "_")
    return classname


def load_gpt_descriptions(hparams: dict):
    """class -> [descriptor sentences]; parity with gpt3_descriptors.py:51-95.

    hparams: fname, dsname, position_class (None|'append'|'prepend'),
    modify, between_text, before_text, after_text, combine.
    """
    fname = hparams["fname"]
    if not fname.endswith(".json"):
        fname += ".json"
    with open(fname) as f:
        descriptions = json.load(f)

    modify = hparams["modify"]
    inclusion = hparams["position_class"]
    out, unmodified = {}, {}

    for cls, desc_list in descriptions.items():
        desc_list = desc_list if desc_list else [""]
        cls_p = process_name(cls, hparams["dsname"])
        cls_name = wordify(cls)

        def build(item):
            body = make_sentence(item) if modify else item
            if inclusion == "append":
                return f"{body}{hparams['between_text']}{cls_name}"
            if inclusion == "prepend":
                return (f"{hparams['before_text']}{cls_name}"
                        f"{hparams['between_text']}{body}{hparams['after_text']}")
            return body

        unmodified[cls_p] = {build(item): item for item in desc_list}
        if hparams.get("combine"):
            out[cls_p] = f"{cls_name}: {', '.join(desc_list)}"
        else:
            out[cls_p] = [build(item) for item in desc_list]
    return out, unmodified

"""Caption embedding enrichment.

Reference: Dataset_Construction_Pipeline/Embedding_Generation.py — build a
category-aware Prefix from the subject folder name (:22-44), embed Prefix
and Summary with text-embedding-3-large dim 128, and write them back into
caption.json; threaded over clips (:52-77). (The reference's
Prefix_Embedding_Generation.py stub — with its undefined `embeddings`
variable at :28 — is subsumed by this module.)
"""

from __future__ import annotations

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Sequence

from t2ms_tpu_torch.pipeline.llm import EmbedClient

__all__ = ["BENCHPRESS_CATEGORIES", "subject_classes", "build_prefix",
           "enrich_clip", "enrich_captions"]

BENCHPRESS_CATEGORIES = ["correct", "tilting_to_the_right",
                         "tilting_to_the_left", "elbows_flaring",
                         "wrist_bending_backward", "scapular_protraction"]


def subject_classes(subject: str,
                    categories: Sequence[str] = BENCHPRESS_CATEGORIES
                    ) -> str:
    """Human-readable error-class list parsed from the folder name
    (reference :25-33)."""
    found = [c.replace("_", " ") for c in categories if c in subject]
    if not found:
        return "unknown"
    if len(found) == 1:
        return found[0]
    return ", ".join(found[:-1]) + " and " + found[-1]


def build_prefix(n_frames: int, classes: str) -> str:
    """(reference :43)"""
    return (f"The following presents the feature description for the "
            f"{n_frames} frames of bench press. It is categorized as "
            f"{classes}, with the feature sequence and described as "
            f"follows: \n")


def enrich_clip(client: EmbedClient, clip_dir: str, clip_data: dict) -> bool:
    subject = os.path.basename(os.path.dirname(clip_dir))
    classes = subject_classes(subject)
    cap_path = os.path.join(clip_dir, "caption.json")
    with open(cap_path, encoding="utf-8") as f:
        caption = json.load(f)
    text = caption.get("Summary", "")
    if text == "":
        print(f"Empty summary: {cap_path}")
        return False
    first_feat = next(iter(clip_data.values()))
    prefix = build_prefix(len(first_feat), classes)
    caption["Prefix"] = prefix
    caption["Prefix_embedding"] = client.embed(prefix)
    caption["Summary_embedding"] = client.embed(text)
    with open(cap_path, "w", encoding="utf-8") as f:
        json.dump(caption, f, ensure_ascii=False, indent=4)
    return True


def enrich_captions(client: EmbedClient, data_path: str,
                    caption_root: str, max_workers: int = 10) -> int:
    """Embed every clip's captions concurrently (reference main :52-77).
    Returns the number of clips enriched."""
    with open(data_path, encoding="utf-8") as f:
        data = json.load(f)
    clip_dirs = [c for s in glob.glob(os.path.join(caption_root, "*"))
                 for c in glob.glob(os.path.join(s, "*"))]
    n = 0
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {}
        for d in clip_dirs:
            subject = os.path.basename(os.path.dirname(d))
            clip = os.path.basename(d)
            feats = data.get(subject, {}).get(clip)
            if feats is None:
                # stray dir not in data.json: skip like the reference's
                # tqdm-over-as_completed (which never raised per clip)
                print(f"enrich: {subject}/{clip} not in data.json, skipped")
                continue
            futures[pool.submit(enrich_clip, client, d, feats)] = d
        for fut in as_completed(futures):
            try:
                if fut.result():
                    n += 1
            except Exception as e:  # keep enriching the remaining clips
                print(f"enrich failed for {futures[fut]}: {e}")
    return n

"""T2S corpus construction tools.

Reference: Dataset_Construction_Pipeline/ —
  * Unified_Dataset(Ours)_Generation.py: sliding-window sampling of a CSV
    column + GPT trend captions per window, resumable via a progress file;
  * Get_Embedding_and_Convert_JSON_to_CSV.py: per-sample JSON validation
    (series length, 128-d embedding) and JSON -> embedding_cleaned CSV;
  * Check_JSON_Datasets.py: missing-file detection over the sample grid;
  * Evaluate_Datasets.py: best-of-N caption selection by mutual cosine
    similarity;
  * JSON_rebuild.py: the script invoking the sport FeatureMergers.

LLM access via pipeline.llm clients; everything else is pure host code.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from t2ms_tpu_torch.pipeline.llm import (ChatClient, EmbedClient,
                                         with_retries)

__all__ = ["sliding_windows", "trend_caption", "generate_corpus",
           "validate_sample_json", "check_directory", "find_missing_ids",
           "corpus_to_csv", "cosine_similarity", "select_best_captions",
           "rebuild_motion_json"]

TREND_SYSTEM = (
    "You're an expert in time series summarization, providing insightful "
    "and succinct descriptions with precise language. Avoid unnecessary "
    "text or explanations.")


def sliding_windows(series: Sequence[float], sample_length: int
                    ) -> List[List[float]]:
    """Stride-1 windows (reference Unified...:30-40: Max_Iteration =
    len - sample_length)."""
    s = list(series)
    return [s[i:i + sample_length]
            for i in range(len(s) - sample_length)]


def trend_caption(client: ChatClient, window: Sequence[float]) -> dict:
    """One window -> {'Trend Analysis': ...} (reference :74-100)."""
    formatted = "\n".join(f"{i + 1}.0, {v:.3f}"
                          for i, v in enumerate(window))
    prompt = (
        "1.Summarize the observed trend in the given time series data.\n"
        "2.ONLY output the summary using the following JSON format.\n"
        "3.The output MUST be less than 256 tokens.\n"
        "4.The output description MUST be consistent with the actual trend "
        "characteristics of the time series.\n"
        f"Given the time series data\n```{formatted}```\n"
        'Use the following JSON format:\n```{"Trend Analysis": "..."}```')
    raw = client.complete(TREND_SYSTEM, prompt)
    cleaned = re.sub(r"^```(json)?|```$", "", raw,
                     flags=re.MULTILINE).strip()
    return json.loads(cleaned)


def plot_window_figure(window: Sequence[float], text: str,
                       save_path: str) -> None:
    """Window plot with the caption banner (reference
    Unified...plot_data_to_picture :63-70)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    ax.plot(list(window))
    fig.text(0.5, 0.05, text[:120], ha="center", va="center", fontsize=9,
             bbox=dict(facecolor="lightblue", alpha=0.5))
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    plt.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def generate_corpus(client: ChatClient, embed_client: Optional[EmbedClient],
                    series: Sequence[float], sample_length: int,
                    out_dir: str, max_retries: int = 3,
                    limit: Optional[int] = None,
                    make_figures: bool = False) -> int:
    """Caption (and optionally embed) every sliding window into
    data_sample_{i}_1.json files, resuming from a progress file
    (reference :125-165)."""
    os.makedirs(out_dir, exist_ok=True)
    progress_path = os.path.join(out_dir, "progress.txt")
    start = 0
    if os.path.exists(progress_path):
        with open(progress_path) as f:
            start = int(f.read().strip() or 0)
    windows = sliding_windows(series, sample_length)
    if limit is not None:
        windows = windows[:start + limit]
    done = 0
    for i in range(start, len(windows)):
        def run(i=i):
            cap = trend_caption(client, windows[i])
            if not cap.get("Trend Analysis"):
                # a schema mismatch must fail the clip's retries, not
                # silently write an empty conditioning Text
                raise ValueError(
                    f"trend caption missing 'Trend Analysis': {cap}")
            payload = {
                "sampled_time_series": windows[i],
                "Text": cap["Trend Analysis"],
            }
            if embed_client is not None:
                payload["embedding"] = embed_client.embed(payload["Text"])
            with open(os.path.join(out_dir,
                                   f"data_sample_{i}_1.json"), "w") as f:
                json.dump(payload, f)
            if make_figures:
                plot_window_figure(windows[i], payload["Text"],
                                   os.path.join(out_dir, "picture",
                                                f"data_sample_{i}.png"))
            with open(progress_path, "w") as f:
                f.write(str(i + 1))
            return True

        if with_retries(run, max_retries,
                        error_log=os.path.join(out_dir, "error_log.txt"),
                        label=f"window {i}"):
            done += 1
    return done


def validate_sample_json(file_path: str, sample_length: int
                         ) -> Tuple[bool, str]:
    """Schema/shape check (reference Get_Embedding...:62-80)."""
    try:
        with open(file_path, encoding="utf-8") as f:
            data = json.load(f)
        sts = data.get("sampled_time_series", [])
        if not isinstance(sts, list) or len(sts) != sample_length:
            return False, (f"The 'sampled_time_series' field must be a "
                           f"list of length {sample_length}.")
        emb = data.get("embedding", [])
        if not isinstance(emb, list) or len(emb) != 128:
            return False, "The 'embedding' field must be a list of length 128."
        return True, "Valid JSON format."
    except json.JSONDecodeError as e:
        return False, f"JSON decode error: {e}"
    except Exception as e:   # valid JSON but wrong type, IO errors, ...
        # the reference reports and keeps validating the rest
        # (Get_Embedding...:81-82)
        return False, f"An error occurred: {e}"


def check_directory(directory: str, sample_length: int) -> List[str]:
    invalid = []
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".json"):
            ok, msg = validate_sample_json(os.path.join(directory, fn),
                                           sample_length)
            if not ok:
                invalid.append(f"File '{fn}' has issues: {msg}")
    return invalid


def find_missing_ids(directory: str, prefix: str = "data_sample_",
                     suffix: str = ".json", per_sample: int = 1
                     ) -> List[Tuple[int, int]]:
    """Detect gaps in the {first}_{second} sample grid
    (reference Check_JSON_Datasets.py:9-46)."""
    ids = []
    for fn in os.listdir(directory):
        if fn.startswith(prefix) and fn.endswith(suffix):
            first, second = fn[len(prefix):-len(suffix)].split("_")
            ids.append((int(first), int(second)))
    missing = []
    firsts = sorted({a for a, _ in ids})
    for a in firsts:
        seconds = {b for x, b in ids if x == a}
        for b in range(1, per_sample + 1):
            if b not in seconds:
                missing.append((a, b))
    return missing


def corpus_to_csv(json_dir: str, csv_path: str, sample_length: int
                  ) -> int:
    """Validated JSON samples -> embedding_cleaned CSV with Text / OT /
    TextEmbedding columns (reference Get_Embedding...:99-203). Written
    with the ``csv`` module (the port does not depend on pandas), byte for
    byte what pandas' ``to_csv`` writes in the JAX package."""
    import csv
    rows = []
    for fn in sorted(os.listdir(json_dir)):
        if not fn.endswith(".json") or fn.startswith("progress"):
            continue
        p = os.path.join(json_dir, fn)
        ok, msg = validate_sample_json(p, sample_length)
        if not ok:
            print(f"skip {fn}: {msg}")
            continue
        with open(p) as f:
            d = json.load(f)
        rows.append([
            d["Text"],
            str([float(v) for v in d["sampled_time_series"]]),
            "[" + " ".join(f"{v:.6f}" for v in d["embedding"]) + "]",
        ])
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        if not rows:
            f.write("\n")                 # pandas' empty frame
            return 0
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["Text", "OT", "TextEmbedding"])
        w.writerows(rows)
    return len(rows)


def cosine_similarity(a, b) -> float:
    """Flat cosine similarity with zero-safe handling
    (reference Evaluate_Datasets.py:6-17)."""
    a = np.asarray(a, float).ravel()
    b = np.asarray(b, float).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom == 0:
        return 0.0
    return float(np.dot(a, b) / denom)


def select_best_captions(embeddings_per_sample: Dict[int, np.ndarray]
                         ) -> Dict[int, int]:
    """Best-of-N caption per sample = the one with max summed cosine
    similarity to its siblings (reference Evaluate_Datasets.py:21-58).
    Returns sample_id -> winning candidate index."""
    winners = {}
    for sid, embs in embeddings_per_sample.items():
        embs = np.asarray(embs, float)
        sims = np.array([[cosine_similarity(embs[i], embs[j])
                          for j in range(len(embs))]
                         for i in range(len(embs))])
        winners[sid] = int(np.argmax(sims.sum(axis=1)))
    return winners


def rebuild_motion_json(sport: str, class_dirs: Sequence[str],
                        output_root: str, multi_error_path: str,
                        feature: Dict[str, str]):
    """Dispatch to the sport merger
    (reference JSON_rebuild.py:21-43)."""
    from t2ms_tpu_torch.pipeline.mergers import (BenchpressFeatureMerger,
                                                 DeadliftFeatureMerger)
    cls = {"benchpress": BenchpressFeatureMerger,
           "deadlift": DeadliftFeatureMerger}[sport]
    return cls(class_dirs, output_root, multi_error_path, feature)

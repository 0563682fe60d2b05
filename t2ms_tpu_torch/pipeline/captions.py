"""Caption generation: pairwise feature-relation analyses -> summary.

Reference: Dataset_Construction_Pipeline/Caption_Generation.py — threaded
pairwise prompts over feature pairs (:67-115), a JSON-summarizing final
prompt (:29-65), retry loop with error log and skip-if-exists resumability
(:166-194), and a normalized feature plot per clip (:117-140).

LLM access goes through pipeline.llm clients (OpenAI or fake).
"""

from __future__ import annotations

import json
import os
import re
import textwrap
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List

import numpy as np

from t2ms_tpu_torch.pipeline.llm import ChatClient, with_retries

__all__ = ["pairwise_summary", "clip_caption", "generate_captions",
           "plot_caption_figure", "SYSTEM_PROMPT"]

SYSTEM_PROMPT = (
    "You're an expert in multi-feature time series summarization. Generate "
    "precise, concise, and context-aware descriptions that reflect the "
    "dynamics and relationships among multiple variables. Focus on clarity "
    "and informativeness. Avoid unnecessary text or generic explanations.")


def _pair_prompt(f1, f2, d1, d2, expl):
    return (
        f"You are given two time series features with their values and "
        f"definitions:\n\n{f1}\nDefinition: {expl.get(f1, '')}\n"
        f"Values: {list(d1)}\nMax Value: {max(d1)}\nMin Value: {min(d1)}\n\n"
        f"{f2}\nDefinition: {expl.get(f2, '')}\nValues: {list(d2)}\n"
        f"Max Value: {max(d2)}\nMin Value: {min(d2)}\n\n"
        "Task:\n"
        f"1. Compare and analyze the temporal relationship between {f1} "
        f"and {f2}.\n"
        "2. Highlight how their trends correlate, diverge, or interact "
        "over time, based on their definitions.\n"
        "3. Consider how the maximum and minimum values of both features "
        "influence their temporal dynamics.\n"
        "4. Use a precise and concise single sentence (max 128 tokens).\n"
        "5. Focus on clarity, dynamics, and inter-feature meaning.")


def pairwise_summary(client: ChatClient, features: Dict[str, list],
                     feature_explanation: Dict[str, str],
                     skip_first: int = 2, max_workers: int = 11
                     ) -> List[str]:
    """Describe every feature pair concurrently (reference :67-115; the
    first ``skip_first`` features — the barbell coordinates — are
    excluded)."""
    names = list(features.keys())[skip_first:]
    descriptions = []
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {}
        for i, f1 in enumerate(names):
            for f2 in names[i + 1:]:
                prompt = _pair_prompt(f1, f2, features[f1], features[f2],
                                      feature_explanation)
                futures[pool.submit(client.complete, SYSTEM_PROMPT,
                                    prompt)] = (f1, f2)
        for fut in as_completed(futures):
            f1, f2 = futures[fut]
            try:
                descriptions.append(fut.result())
            except Exception as exc:  # noqa: BLE001
                print(f"Pair {f1}-{f2} generated an exception: {exc}")
    return descriptions


def clip_caption(client: ChatClient, features: Dict[str, list],
                 feature_explanation: Dict[str, str]) -> dict:
    """Summarize pairwise analyses into {'Summary': ...} (reference
    :29-65)."""
    pairwise = pairwise_summary(client, features, feature_explanation)
    combined = "\n".join(pairwise)
    final_prompt = (
        "You are given multiple pairwise analyses of time series features, "
        "where each analysis describes the relationship between two "
        f"features using their definitions:\n\n{combined}\n\n"
        "Task:\n"
        "1. Summarize these pairwise observations into one coherent "
        "description.\n"
        "2. Highlight the overall temporal dynamics and inter-feature "
        "relationships across the clip.\n"
        "4. Identify and retain only the notable extreme values.\n"
        "5. The output MUST be less than 512 tokens.\n"
        "6. DO NOT add extra explanations, markdown, or commentary.\n"
        "7. Output only in the JSON format:\n"
        '```{"Summary": "..."}```')
    raw = client.complete(SYSTEM_PROMPT, final_prompt)
    cleaned = re.sub(r"^```(json)?|```$", "", raw,
                     flags=re.MULTILINE).strip()
    return json.loads(cleaned)


def plot_caption_figure(features: Dict[str, list], caption: dict,
                        save_path: str) -> None:
    """Min-max normalized per-feature plot with wrapped caption title
    (reference :117-140)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure(figsize=(12, 8))
    for name, series in features.items():
        arr = np.asarray(series, float)
        rng = arr.max() - arr.min()
        norm = (arr - arr.min()) / rng if rng else np.zeros_like(arr)
        plt.plot(norm, label=f"{name}, min :{arr.min():.4f}, "
                             f"max :{arr.max():.4f}")
    plt.title(textwrap.fill(caption["Summary"], width=75), fontsize=10)
    plt.xlabel("Frame")
    plt.ylabel("Value")
    plt.legend(fontsize=8)
    plt.grid(True)
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close()


def generate_captions(client: ChatClient, data_path: str, output_path: str,
                      feature_explanation: Dict[str, str],
                      max_retries: int = 3, make_figures: bool = True
                      ) -> int:
    """Caption every clip in data.json, resumably (skip existing dirs) with
    retries + error log (reference __main__ :163-194). Returns the number
    of clips captioned in this run."""
    with open(data_path) as f:
        data = json.load(f)
    done = 0
    for subject, clips in data.items():
        for clip, features in clips.items():
            save_dir = os.path.join(output_path, subject, str(clip))
            # resume on the ARTIFACT, not the directory: a clip whose
            # retries all failed leaves an empty dir which must be
            # retried next run, not skipped forever
            if os.path.exists(os.path.join(save_dir, "caption.json")):
                continue  # resumable: already captioned
            os.makedirs(save_dir, exist_ok=True)

            def run(features=features, save_dir=save_dir):
                caption = clip_caption(client, features,
                                       feature_explanation)
                with open(os.path.join(save_dir, "caption.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(caption, f, indent=4)
                if make_figures:
                    plot_caption_figure(features, caption,
                                        os.path.join(save_dir, "fig.jpg"))
                return True

            if with_retries(run, max_retries,
                            error_log=os.path.join(output_path,
                                                   "error_log.txt"),
                            label=f"{subject} on {clip}"):
                done += 1
    return done

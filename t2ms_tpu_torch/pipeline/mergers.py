"""Skeleton-output -> data.json feature mergers.

Reference: Dataset_Construction_Pipeline/benchpress.py (angle/coordinate
txt trees, wrist-to-shoulder-line perpendicular distances, multi-error
relabeling from CSV) and deadlift.py (3D angle CSVs, body_length x100,
multi-error rename/skip from JSON).

Both mergers take recording directory trees and emit the subject->clip->
feature dict the motion datasets consume.
"""

from __future__ import annotations

import ast
import csv
import glob
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["BenchpressFeatureMerger", "DeadliftFeatureMerger",
           "perpendicular_distance", "wrist_to_shoulder_distances"]


def perpendicular_distance(point, line_start, line_end):
    """Distance from point to the (extended) line through start-end
    (reference benchpress.py:144-152)."""
    line_vec = np.asarray(line_end, float) - np.asarray(line_start, float)
    point_vec = np.asarray(point, float) - np.asarray(line_start, float)
    line_len = np.linalg.norm(line_vec)
    if line_len == 0:
        return None
    proj_len = np.dot(point_vec, line_vec) / line_len
    proj = np.asarray(line_start, float) + (proj_len / line_len) * line_vec
    return float(np.linalg.norm(np.asarray(point, float) - proj))


def wrist_to_shoulder_distances(coords_list: Sequence) -> List[List[float]]:
    """Per-frame [right_dist, left_dist] from 8-point top-view poses
    (reference benchpress.py:154-165: pts 0/1 shoulders, 6/7 wrists)."""
    out = []
    for pts in coords_list:
        if len(pts) == 8:
            rs, ls = np.asarray(pts[0]), np.asarray(pts[1])
            out.append([perpendicular_distance(np.asarray(pts[6]), rs, ls),
                        perpendicular_distance(np.asarray(pts[7]), rs, ls)])
    return out


class BenchpressFeatureMerger:
    """Merge per-view angle txt + coordinate txt trees into data.json.

    Directory layout (reference benchpress.py:20-46):
      class_dir/*/<subject>/{angle_dataset/<view>/<angle_name>/*.txt,
                            coordinate_dataset/<view>/*.txt}
    multi_error CSV columns: subject folder name, 錯誤1, 錯誤2.
    """

    def __init__(self, class_dirs: Sequence[str], output_root: str,
                 multi_error_path: str, feature: Dict[str, str]):
        self.reverse_feature = {v: k for k, v in feature.items()}
        me_subject = self._load_multi_error(multi_error_path)
        os.makedirs(output_root, exist_ok=True)
        merged = {}
        for class_dir in class_dirs:
            for subject in sorted(glob.glob(os.path.join(class_dir, "*"))):
                clips = self._merge_subject(subject)
                base = os.path.basename(subject)
                label = me_subject.get(base, os.path.basename(class_dir))
                merged[f"{base}_{label}"] = clips
        merged = self._sort_features(merged)
        with open(os.path.join(output_root, "data.json"), "w",
                  encoding="utf-8") as f:
            json.dump(merged, f, indent=4)
        self.data = merged

    @staticmethod
    def _load_multi_error(csv_path: str) -> Dict[str, str]:
        if not csv_path or not os.path.exists(csv_path):
            return {}
        out = {}
        with open(csv_path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                keys = list(row.keys())
                subject = row[keys[0]]
                out[subject] = f"{row[keys[1]]}_{row[keys[2]]}"
        return out

    def _merge_subject(self, subject_dir: str) -> Dict[str, dict]:
        clips: Dict[str, dict] = {}
        angle_root = os.path.join(subject_dir, "angle_dataset")
        for view in glob.glob(os.path.join(angle_root, "*")):
            for angle_path in glob.glob(os.path.join(view, "*")):
                angle_name = os.path.basename(angle_path)
                for clip_path in glob.glob(os.path.join(angle_path,
                                                        "*.txt")):
                    clip = os.path.splitext(os.path.basename(clip_path))[0]
                    series = self._read_angle_txt(clip_path)
                    clips.setdefault(clip, {})[
                        self.reverse_feature[angle_name]] = series
        coord_root = os.path.join(subject_dir, "coordinate_dataset")
        for view_dir in glob.glob(os.path.join(coord_root, "*")):
            view = os.path.basename(view_dir)
            for clip_path in glob.glob(os.path.join(view_dir, "*.txt")):
                clip = os.path.splitext(os.path.basename(clip_path))[0]
                clips.setdefault(clip, {})
                self._read_coordinates(clip_path, clips[clip], view)
        return clips

    @staticmethod
    def _read_angle_txt(clip_path: str) -> List[float]:
        """Lines are 'frame,value' (reference benchpress.py:60-70)."""
        with open(clip_path) as f:
            lines = f.read().strip().split("\n")
        return [float(line.split(",")[1]) for line in lines]

    def _read_coordinates(self, clip_path: str, feats: dict, view: str):
        with open(clip_path) as f:
            lines = f.read().strip().split("\n")
        if view == "lateral_view":
            data = np.array([[float(x) for x in line.split(",")[1:3]]
                             for line in lines])
            feats[self.reverse_feature["bar_x"]] = data[:, 0].tolist()
            feats[self.reverse_feature["bar_y"]] = data[:, 1].tolist()
            feats[self.reverse_feature["barx/bar_y"]] = (
                data[:, 0] / data[:, 1]).tolist()
        elif view == "rear_view":
            ys = []
            for line in lines:
                _, coords_part = line.split(":", 1)
                persons = ast.literal_eval(coords_part.strip())
                ys.extend([[p[1] for p in person[:2]]
                           for person in persons])
            arr = np.asarray(ys, float)
            feats[self.reverse_feature["left_shoulder_y"]] = \
                arr[:, 0].tolist()
            feats[self.reverse_feature["right_shoulder_y"]] = \
                arr[:, 1].tolist()
        elif view == "top_view":
            poses = []
            for line in lines:
                _, coords_part = line.split(":", 1)
                persons = ast.literal_eval(coords_part.strip())
                poses.extend([[list(p) for p in person]
                              for person in persons])
            dists = np.asarray(wrist_to_shoulder_distances(poses), float)
            feats[self.reverse_feature["left_dist"]] = dists[:, 0].tolist()
            feats[self.reverse_feature["right_dist"]] = dists[:, 1].tolist()
        else:
            raise ValueError(f"Unsupported view: {view}")

    def _sort_features(self, d):
        if isinstance(d, dict):
            def keyf(item):
                k = item[0]
                return (int(k.split("_")[-1])
                        if "feature_" in k else k)
            return {k: self._sort_features(v)
                    for k, v in sorted(d.items(), key=keyf)}
        return d


class DeadliftFeatureMerger:
    """Merge 3D angle CSVs into data.json (reference deadlift.py).

    Layout: class_dir/*/<subject>/<set>/{Angle/3D/*.csv, Chessboard, ...};
    sets lacking Chessboard (no 3D calibration) are skipped. Multi-error
    JSON drives clip renames (first error) and skips (other errors).
    body_length is scaled x100 (deadlift.py:92).
    """

    COL_NAMES = ["frame_index", "left_knee", "left_hip", "right_knee",
                 "right_hip", "body_length", "left_torso-arm",
                 "right_torso-arm"]

    def __init__(self, class_dirs: Sequence[str], output_root: str,
                 multierror_path: str, feature: Dict[str, str]):
        self.reverse_feature = {v: k for k, v in feature.items()}
        me = {}
        if multierror_path and os.path.exists(multierror_path):
            with open(multierror_path, encoding="utf-8") as f:
                me = json.load(f)
        rename_list, pass_list = self._make_lists(me)
        data = self._collect(class_dirs, rename_list, pass_list)
        os.makedirs(output_root, exist_ok=True)
        with open(os.path.join(output_root, "data.json"), "w",
                  encoding="utf-8") as f:
            json.dump(data, f, indent=4)
        self.data = data

    @staticmethod
    def _make_lists(me_subject):
        pass_list = defaultdict(list)
        rename_list = {}
        for subject, multis in me_subject.items():
            for multi in multis:
                for i, error in enumerate(multi):
                    key = f"{subject}_{error['set']}_{error['error']}"
                    if i == 0:
                        others = "_".join(e["error"]
                                          for j, e in enumerate(multi)
                                          if j != i)
                        rename_list[key] = [f"{key}_{others}",
                                            error["clips"]]
                    else:
                        pass_list[key] = error["clips"]
        return rename_list, pass_list

    def _collect(self, class_dirs, rename_list, pass_list):
        data = {}
        for class_dir in class_dirs:
            for subject in sorted(glob.glob(os.path.join(class_dir, "*"))):
                for set_dir in sorted(glob.glob(os.path.join(subject, "*"))):
                    key = (f"{os.path.basename(subject)}_"
                           f"{os.path.basename(set_dir)}_"
                           f"{os.path.basename(class_dir)}")
                    if not os.path.isdir(os.path.join(set_dir,
                                                      "Chessboard")):
                        continue
                    csvs = glob.glob(os.path.join(set_dir, "Angle", "3D",
                                                  "*.csv"))
                    if key in pass_list:
                        csvs = [c for c in csvs
                                if self._clip_number(c)
                                not in pass_list[key]]
                    if not csvs:
                        continue
                    clips = self._read_csvs(csvs)
                    out_key = (rename_list[key][0]
                               if key in rename_list else key)
                    data[out_key] = clips
        return data

    @staticmethod
    def _clip_number(filename):
        m = re.search(r"\d+", os.path.basename(filename))
        return int(m.group(0)) if m else None

    def _read_csvs(self, csv_paths):
        """Each headerless CSV's columns after the frame index, as float
        lists (pandas' ``read_csv(header=None, index_col=0)`` in the JAX
        package; the ``csv`` module here, as the port does not depend on
        pandas): blank lines skipped, missing cells NaN."""
        import csv
        out = {}
        names = self.COL_NAMES[1:]
        for p in csv_paths:
            feats = {n: [] for n in names}
            with open(p, newline="") as f:
                for row in csv.reader(f):
                    if not row:
                        continue
                    cells = row[1:] + [""] * (len(names) + 1 - len(row))
                    for n, v in zip(names, cells):
                        feats[n].append(float(v) if v.strip()
                                        else float("nan"))
            feats["body_length"] = [100 * v for v in feats["body_length"]]
            out[self._clip_number(p)] = feats
        return out

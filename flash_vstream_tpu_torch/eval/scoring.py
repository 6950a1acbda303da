"""Benchmark scoring: MCQ letter extraction, ScoreMeter, per-dataset
breakdown matrices, EgoSchema Kaggle CSV export.

Mirrors Flash-VStream-Qwen/eval_any_dataset.py:128-363 (extract_answer,
calc_eval_result) and eval_activitynet_qa.py:204-254 (ScoreMeter) so result
files and CSV layouts are drop-in compatible.

A copy of flash_vstream_tpu/eval/scoring.py, which imports no
JAX, so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import csv
import json
import os
import random
import re
from collections import defaultdict
from typing import Dict, List, Optional


def extract_answer(llm_message: str, rng: Optional[random.Random] = None) -> int:
    """First A-E letter in the message -> option index; random fallback
    (eval_any_dataset.py:128-137)."""
    found = re.findall(r"[A-E]", llm_message)
    if not found:
        letter = (rng or random).choice(["A", "B", "C", "D", "E"])
    else:
        letter = found[0]
    return {"A": 0, "B": 1, "C": 2, "D": 3, "E": 4}[letter]


class ScoreMeter:
    """Accuracy/score accumulator (eval_any_dataset.py:176-206)."""

    def __init__(self):
        self.score_sum = 0.0
        self.count = 0
        self.yes_count = 0
        self.no_count = 0
        self.score_dict = {"yes": defaultdict(int), "no": defaultdict(int)}

    def add_score(self, score, pred):
        self.score_sum += score
        self.count += 1
        pred_lower = str(pred).lower()
        if "yes" in pred_lower:
            self.yes_count += 1
            self.score_dict["yes"][score] += 1
        elif "no" in pred_lower:
            self.no_count += 1
            self.score_dict["no"][score] += 1

    def get_average_score(self) -> str:
        res = (self.score_sum / self.count) if self.count else 0
        return f"{res * 100:.6f}"

    def get_accuracy(self, response_type: str) -> str:
        if response_type == "yes":
            res = (self.yes_count / self.count) if self.count else 0
        elif response_type == "no":
            res = (self.no_count / self.count) if self.count else 0
        else:
            res = 0
        return f"{res * 100:.6f}"


def load_predictions(output_path: str, num_chunks: int) -> List[dict]:
    preds = []
    if num_chunks > 1:
        for i in range(num_chunks):
            f = os.path.join(output_path, f"{num_chunks}_{i}.json")
            if os.path.exists(f):
                preds += [json.loads(line) for line in open(f) if line.strip()]
    else:
        f = os.path.join(output_path, "pred.json")
        preds = [json.loads(line) for line in open(f) if line.strip()]
    return preds


VIDEOMME_LEVELS = ("duration", "domain", "sub_category", "task_type")

LVBENCH_TYPES = (
    "key information retrieval", "event understanding", "summarization",
    "entity recognition", "reasoning", "temporal grounding")


def calc_mcq_result(output_path: str, num_chunks: int, data_path: str,
                    dataset_name: str = "", seed: int = 0) -> Dict[str, str]:
    """MCQ scoring + breakdowns; writes result.json and result.csv like
    calc_eval_result (eval_any_dataset.py:139-363). Returns the csv dict."""
    rng = random.Random(seed)
    preds = load_predictions(output_path, num_chunks)

    prediction_set = {}
    for sample in preds:
        res = extract_answer(sample["pred"], rng)
        ok = res == sample["answer"]
        prediction_set[str(sample["id"])] = {
            "acc": "yes" if ok else "no",
            "score": 1.0 if ok else 0.0,
            **sample,
        }
    json_path = os.path.join(output_path, "result.json")
    with open(json_path, "w") as f:
        json.dump(prediction_set, f, indent=4)

    meters = {"total": ScoreMeter()}
    for key, result in prediction_set.items():
        meters["total"].add_score(result["score"], result["acc"])
        if result.get("a_type") is not None:
            typ = str(result["a_type"])
            meters.setdefault(typ, ScoreMeter()).add_score(
                result["score"], result["acc"])
            if "next" in output_path or "next" in dataset_name:
                t0 = typ[0]
                meters.setdefault(t0, ScoreMeter()).add_score(
                    result["score"], result["acc"])

    csv_dic = {"acc": meters["total"].get_accuracy("yes"),
               "score": meters["total"].get_average_score()}
    lines = [
        f"Yes count: {meters['total'].yes_count}",
        f"No count: {meters['total'].no_count}",
        f"Accuracy: {meters['total'].get_accuracy('yes')}",
        f"Average score: {meters['total'].get_average_score()}",
        "", "Answer Type Score distribution:", "Type, Accuracy, Avg_score",
    ]
    for key, m in meters.items():
        lines.append(f"{key}, {m.get_accuracy('yes')}, {m.get_average_score()}")
        csv_dic[key] = m.get_accuracy("yes")

    name = dataset_name or output_path
    if "egoschema" in name:
        _egoschema_csv(json_path, prediction_set, data_path, rng)
    elif "videomme" in name:
        lines += _breakdown(prediction_set, data_path, VIDEOMME_LEVELS)
    elif "lvbench" in name:
        lines += _lvbench_breakdown(prediction_set, data_path)

    out = "\n".join(lines) + "\n"
    with open(json_path.replace(".json", ".csv"), "w") as f:
        f.write(out)
    print(out)
    return csv_dic


def _breakdown(prediction_set, data_path, levels):
    info = {str(qa["id"]): qa for qa in json.load(open(data_path))}
    score_dic = {lv: defaultdict(ScoreMeter) for lv in levels}
    total = ScoreMeter()
    for key, result in prediction_set.items():
        qa = info.get(key.split("_")[0], info.get(key))
        if qa is None:
            continue
        for lv in levels:
            score_dic[lv][qa[lv]].add_score(0, result["acc"])
        total.add_score(0, result["acc"])
    lines = ["", "Type, Accuracy"]
    for lv in levels:
        for k, m in score_dic[lv].items():
            lines.append(f"{k}, {float(m.get_accuracy('yes')):.02f}")
    lines.append(f"Overall, {float(total.get_accuracy('yes')):.02f}")
    return lines


def _lvbench_breakdown(prediction_set, data_path):
    info = {str(qa["id"]): qa for qa in json.load(open(data_path))}
    score_dic = {t: ScoreMeter() for t in LVBENCH_TYPES}
    total = ScoreMeter()
    for key, result in prediction_set.items():
        qa = info.get(key)
        if qa is None:
            continue
        for typ in qa.get("question_type", []):
            if typ in score_dic:
                score_dic[typ].add_score(0, result["acc"])
        total.add_score(0, result["acc"])
    lines = ["", "Type, Accuracy"]
    for k, m in score_dic.items():
        lines.append(f"{k}, {float(m.get_accuracy('yes')):.02f}")
    lines.append(f"Overall, {float(total.get_accuracy('yes')):.02f}")
    return lines


def _egoschema_csv(json_path, prediction_set, data_path, rng):
    """Kaggle submission CSV (eval_any_dataset.py:260-273)."""
    upload_path = json_path.replace(".json", "_upload.csv")
    all_qa_path = os.path.join(os.path.dirname(data_path), "all_qa.json")
    if not os.path.exists(all_qa_path):
        all_qa_path = data_path
    info = {str(qa["id"]): qa["video_id"] for qa in json.load(open(all_qa_path))}
    with open(upload_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["q_uid", "answer"])
        for key, result in prediction_set.items():
            q_uid = info.get(key.split("_")[0], key)
            w.writerow([q_uid, extract_answer(result["pred"], rng)])

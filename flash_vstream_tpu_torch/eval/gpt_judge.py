"""GPT-judged open-ended QA scoring.

Rebuild of Flash-VStream-Qwen/eval_activitynet_qa.py (same as the LLaVA
variant): for each (question, answer, prediction) triple, ask an
openai-protocol chat model for {'pred': yes/no, 'score': 0-5}, with a
multiprocessing pool, a rerun-until-stable loop (L149-183), and ScoreMeter
aggregation (L204-254).

Network access is environment-gated: the client uses OPENAI_API_KEY /
OPENAI_BASE_URL (or AZURE_* equivalents) through stdlib urllib — no sdk
dependency. Without a key, combine_and_score() still merges chunks and
reports what it can.

A copy of flash_vstream_tpu/eval/gpt_judge.py, which imports no
JAX, so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import ast
import json
import os
import time
import urllib.request
from multiprocessing.pool import ThreadPool
from typing import Dict, List, Optional

from .scoring import ScoreMeter

JUDGE_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the correctness "
    "of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct answer "
    "and determine if they match meaningfully.")

JUDGE_TEMPLATE = (
    "Please evaluate the following video-based question-answer pair:\n\n"
    "Question: {question}\n"
    "Correct Answer: {answer}\n"
    "Predicted Answer: {pred}\n\n"
    "Provide your evaluation only as a yes/no and score where the score is "
    "an integer value between 0 and 5, with 5 indicating the highest "
    "meaningful match. Please generate the response in the form of a Python "
    "dictionary string with keys 'pred' and 'score', where value of 'pred' "
    "is a string of 'yes' or 'no' and value of 'score' is in INTEGER, not "
    "STRING. DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
    "provide the Python dictionary string. For example, your response should "
    "look like this: {{'pred': 'yes', 'score': 4.8}}.")


# --- VideoChatGPT-bench judge dimensions -----------------------------------
# The reference evaluates videochatgpt with the five VideoChatGPT
# quantitative benchmarks (correctness / detailed orientation / context on
# the generic split, temporal on the temporal split, consistency on the
# consistency split; eval_any_dataset.py:371-387). The benchmark scripts are
# not bundled with the reference; these prompts reproduce their judging
# semantics in one client.

_VCG_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the {what} of "
    "generative outputs for video-based question-answer pairs. Your task is "
    "to compare the predicted answer with the correct answer and determine "
    "{goal}.")

_VCG_TAIL = (
    "Provide your evaluation only as a {name} score where the score is an "
    "integer value between 0 and 5, with 5 indicating the highest level of "
    "{name}. Generate the response in the form of a Python dictionary "
    "string with keys 'score', where its value is the {name} score in "
    "INTEGER, not STRING. DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR "
    # quadruple braces: _VCG_TAIL is format()ed twice (name here, then the
    # QA record fields at judge time)
    "EXPLANATION. For example: {{{{'score': 4}}}}.")

VCG_DIMENSIONS = {
    # key: (split, system prompt, user template)
    "1_correctness": ("generic", _VCG_SYSTEM.format(
        what="factual accuracy",
        goal="if they are factually consistent"),
        "Please evaluate the following video-based question-answer pair for "
        "factual correctness (no misinterpretations or misinformation):\n\n"
        "Question: {question}\nCorrect Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n" + _VCG_TAIL.format(
            name="factual accuracy")),
    "2_detailed_orientation": ("generic", _VCG_SYSTEM.format(
        what="detail orientation",
        goal="its level of detail, considering both completeness and "
             "specificity"),
        "Please evaluate the following video-based question-answer pair for "
        "detail (covers all major points, with specifics rather than "
        "generalities):\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n" + _VCG_TAIL.format(
            name="detail orientation")),
    "3_context": ("generic", _VCG_SYSTEM.format(
        what="contextual understanding",
        goal="if the prediction aligns with the overall context of the "
             "video content"),
        "Please evaluate the following video-based question-answer pair for "
        "contextual understanding (alignment with the video's overall "
        "context):\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n" + _VCG_TAIL.format(
            name="contextual understanding")),
    "4_temporal": ("temporal", _VCG_SYSTEM.format(
        what="temporal understanding",
        goal="if they correctly reflect the temporal sequence of events in "
             "the video"),
        "Please evaluate the following video-based question-answer pair for "
        "temporal understanding (correct order of events):\n\n"
        "Question: {question}\nCorrect Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n" + _VCG_TAIL.format(
            name="temporal understanding")),
    "5_consistency": ("consistency", _VCG_SYSTEM.format(
        what="consistency",
        goal="if the two predicted answers to paraphrases of the same "
             "question agree with each other and the correct answer"),
        "Please evaluate the consistency of the following two video-based "
        "question-answer pairs (similar questions must get consistent "
        "answers):\n\nQuestion 1: {question1}\nQuestion 2: {question2}\n"
        "Correct Answer: {answer}\nPredicted Answer to Question 1: {pred1}\n"
        "Predicted Answer to Question 2: {pred2}\n\n" + _VCG_TAIL.format(
            name="consistency")),
}


def _chat_completion(messages: List[dict], model: str) -> str:
    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        raise RuntimeError("OPENAI_API_KEY not set; GPT judging unavailable")
    base = os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1")
    req = urllib.request.Request(
        f"{base}/chat/completions",
        data=json.dumps({"model": model, "messages": messages}).encode(),
        headers={"Authorization": f"Bearer {api_key}",
                 "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        out = json.loads(resp.read())
    return out["choices"][0]["message"]["content"]


def judge_one(item: dict, model: str = "gpt-3.5-turbo-0125",
              system: str = JUDGE_SYSTEM,
              template: str = JUDGE_TEMPLATE) -> Optional[dict]:
    """Score one QA record; returns the judge's dict ({'pred','score'} for
    the default template, {'score'} for VideoChatGPT dimensions). The
    template is format()ed with the whole record, so consistency templates
    can reference question1/question2/pred1/pred2."""
    try:
        content = _chat_completion([
            {"role": "system", "content": system},
            {"role": "user", "content": template.format(**item)},
        ], model)
        return ast.literal_eval(content)
    except Exception as e:
        print(f"judge error on id={item.get('id')}: {e}")
        return None


def judge_all(items: List[dict], out_path: str,
              model: str = "gpt-3.5-turbo-0125", workers: int = 8,
              max_stall_rounds: int = 5, system: str = JUDGE_SYSTEM,
              template: str = JUDGE_TEMPLATE) -> Dict[str, dict]:
    """Rerun-until-stable judging loop (eval_activitynet_qa.py:149-183):
    retry incomplete items each round; stop after max_stall_rounds rounds
    with no progress. Results are checkpointed to out_path."""
    results: Dict[str, dict] = {}
    if os.path.exists(out_path):
        results = json.load(open(out_path))
    stall, last_incomplete = 0, None
    while True:
        todo = [it for it in items if str(it["id"]) not in results]
        if not todo:
            break
        with ThreadPool(workers) as pool:
            scored = pool.map(
                lambda it: (it, judge_one(it, model, system, template)), todo)
        for it, res in scored:
            if res is not None:
                results[str(it["id"])] = {**it, "judge": res}
        with open(out_path, "w") as f:
            json.dump(results, f)
        incomplete = len(items) - len(results)
        print(f"judge round done: {incomplete} incomplete")
        if incomplete == last_incomplete:
            stall += 1
            if stall >= max_stall_rounds:
                break
        else:
            stall = 0
        last_incomplete = incomplete
        time.sleep(1)
    return results


def aggregate(results: Dict[str, dict]) -> Dict[str, str]:
    """Accuracy + average score (eval_activitynet_qa.py:204-254)."""
    meter = ScoreMeter()
    by_type: Dict[str, ScoreMeter] = {}
    for r in results.values():
        j = r.get("judge", {})
        meter.add_score(float(j.get("score", 0)), j.get("pred", "no"))
        t = r.get("a_type")
        if t is not None:
            by_type.setdefault(str(t), ScoreMeter()).add_score(
                float(j.get("score", 0)), j.get("pred", "no"))
    out = {"accuracy": meter.get_accuracy("yes"),
           "avg_score": meter.get_average_score()}
    for t, m in sorted(by_type.items()):
        out[f"type_{t}_acc"] = m.get_accuracy("yes")
    return out


def aggregate_scores(results: Dict[str, dict]) -> str:
    """Average 0-5 score (the VideoChatGPT benchmarks report the raw 0-5
    mean, not ScoreMeter's percentified average)."""
    scores = [float(r.get("judge", {}).get("score", 0))
              for r in results.values()]
    avg = sum(scores) / len(scores) if scores else 0.0
    return f"{avg:.6f}"


def judge_videochatgpt(preds_by_split: Dict[str, List[dict]], out_dir: str,
                       model: str = "gpt-3.5-turbo-0125") -> Dict[str, str]:
    """Run all five VideoChatGPT benchmark dimensions over the three splits'
    predictions (reference eval_any_dataset.py:371-387: benchmarks 1-3 judge
    the generic split, 4 the temporal split, 5 the consistency split).
    Returns {dimension: avg score}."""
    summary: Dict[str, str] = {}
    for dim, (split, system, template) in VCG_DIMENSIONS.items():
        preds = preds_by_split.get(split)
        if not preds:
            print(f"[judge_videochatgpt] no predictions for split "
                  f"'{split}'; skipping {dim}")
            continue
        results = judge_all(
            preds, os.path.join(out_dir, f"judge_{dim}.json"),
            model=model, system=system, template=template)
        summary[dim] = aggregate_scores(results)
    return summary

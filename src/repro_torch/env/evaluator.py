"""Benchmark evaluator: the paper's Table-2 metric suite.

  Correct. Rate — the task's primary outcome is right (answer/artifact);
  Success Rate — full task success: plan completed AND all required side
                 effects (map layers, pages, artifacts) present;
  Obj. Det F1  — micro-F1 of detections vs world ground truth;
  LCC R        — Pearson correlation of predicted vs true land-cover
                 fractions (pooled over tasks);
  VQA Rouge-L  — Rouge-L F between the agent's answer and ground truth;
  Tokens/Task  — mean total tokens from the ledger (prompt+completion).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.agent import Agent, TaskResult
from repro_torch.env.tasks import Task


def rouge_l(pred: str, ref: str) -> float:
    a, b = pred.split(), ref.split()
    if not a or not b:
        return 0.0
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
    for i, wa in enumerate(a):
        for j, wb in enumerate(b):
            dp[i + 1, j + 1] = (dp[i, j] + 1 if wa == wb
                                else max(dp[i, j + 1], dp[i + 1, j]))
    lcs = dp[-1, -1]
    p, r = lcs / len(a), lcs / len(b)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def _task_correct(res: TaskResult) -> bool:
    t, ws = res.task, res.workspace
    c = t.checker
    if t.intent == "load_filter_plot":
        plotted = any(l["type"] == "images" for l in ws.map_layers)
        return plotted and bool(ws.handles)
    if t.intent == "detection_analysis":
        return bool(ws.detections)
    if t.intent == "landcover_analysis":
        return ws.last_answer == c.get("gt_dominant")
    if t.intent in ("information_seeking", "visual_qa",
                    "speech_transcription"):
        return bool(ws.last_answer)
    if t.intent == "ui_web_navigation":
        return ws.ui_state.get("page") == c.get("expect_page")
    if t.intent == "code_analysis":
        return any(a.get("op") == "tabulate" for a in ws.artifacts)
    return False


def _task_success(res: TaskResult) -> bool:
    t, ws = res.task, res.workspace
    if not res.completed_plan:
        return False
    if not _task_correct(res):
        return False
    if t.checker.get("expect_map") and not ws.map_layers:
        return False
    needed = {c.tool for stage in t.plan for c in stage}
    return needed.issubset(set(res.executed_tools))


@dataclass
class EvalReport:
    name: str
    correct_rate: float
    success_rate: float
    det_f1: float
    lcc_r: float
    vqa_rouge_l: float
    tokens_per_task: float
    steps_per_task: float
    tools_per_step: float
    fallback_rate: float
    gate_tokens: float
    n_tasks: int

    def row(self) -> Dict[str, float]:
        return {
            "Correct.Rate": round(100 * self.correct_rate, 2),
            "SuccessRate": round(100 * self.success_rate, 2),
            "ObjDetF1": round(100 * self.det_f1, 2),
            "LCC_R": round(100 * self.lcc_r, 2),
            "VQA_RougeL": round(100 * self.vqa_rouge_l, 2),
            "Tokens/Task": round(self.tokens_per_task / 1000, 2),
            "Steps/Task": round(self.steps_per_task, 2),
            "Tools/Step": round(self.tools_per_step, 2),
            "Fallback%": round(100 * self.fallback_rate, 2),
        }


def evaluate(agent: Agent, tasks: Sequence[Task], name: str = "run"
             ) -> EvalReport:
    """Sequential harness: run tasks one at a time, then score. The
    concurrent path (serving.pipeline.evaluate_pipeline) produces the
    same TaskResults via interleaved sessions and shares
    ``evaluate_results``."""
    return evaluate_results(
        [agent.run_task(t, task_seed=i) for i, t in enumerate(tasks)],
        name)


def evaluate_results(results: Sequence[TaskResult], name: str = "run"
                     ) -> EvalReport:
    correct = [float(_task_correct(r)) for r in results]
    success = [float(_task_success(r)) for r in results]

    # detection quality over images the detector actually ran on (the
    # benchmark's F1 scores the detector, not plan completion — plan
    # failures already show up in success rate)
    tp = fp = fn = 0
    for r in results:
        if r.task.metric_family != "detection":
            continue
        cls = r.task.checker["class"]
        for h in r.task.checker["handles"]:
            det = r.workspace.detections.get(h, {}).get(cls)
            if det is None:
                continue
            gt = r.workspace.world.images[h].objects.get(cls, 0)
            tp += det["tp"]
            fp += det["fp"]
            fn += gt - det["tp"]
    det_f1 = 2 * tp / max(2 * tp + fp + fn, 1)

    pred_fracs, gt_fracs = [], []
    for r in results:
        if r.task.metric_family != "landcover":
            continue
        gt = r.task.checker["gt_fractions"]
        if not r.workspace.landcover:
            continue
        agg = {c: float(np.mean([lc[c] for lc in
                                 r.workspace.landcover.values()]))
               for c in gt}
        for c in gt:
            pred_fracs.append(agg[c])
            gt_fracs.append(gt[c])
    if len(pred_fracs) >= 2:
        lcc_r = float(np.corrcoef(pred_fracs, gt_fracs)[0, 1])
    else:
        lcc_r = 0.0

    rouges = []
    for r in results:
        if r.task.metric_family != "vqa":
            continue
        ans = r.workspace.last_answer or ""
        rouges.append(rouge_l(ans, r.task.checker["gt_text"]))
    vqa = float(np.mean(rouges)) if rouges else 0.0

    tokens = [r.ledger.total_tokens for r in results]
    steps = [r.ledger.n_plan_steps for r in results]
    tools = [len(r.executed_tools) / max(r.ledger.n_plan_steps, 1)
             for r in results]
    gate_toks = [sum(e.prompt_tokens + e.completion_tokens
                     for e in r.ledger.entries if e.kind == "gate")
                 for r in results]

    return EvalReport(
        name=name,
        correct_rate=float(np.mean(correct)),
        success_rate=float(np.mean(success)),
        det_f1=det_f1,
        lcc_r=lcc_r,
        vqa_rouge_l=vqa,
        tokens_per_task=float(np.mean(tokens)),
        steps_per_task=float(np.mean(steps)),
        tools_per_step=float(np.mean(tools)),
        fallback_rate=float(np.mean([r.fallback_used for r in results])),
        gate_tokens=float(np.mean(gate_toks)),
        n_tasks=len(results),
    )

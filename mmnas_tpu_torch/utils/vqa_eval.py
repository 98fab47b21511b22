"""Official VQA accuracy metric (functional rebuild of mmnas/utils/vqa.py +
vqaEval.py — the public VQA v2 evaluation API).

Consensus scoring (vqaEval.py:95-116): a predicted answer's accuracy on a
question is averaged over 10 leave-one-out subsets of the human answers:
    acc = mean_j min(1, #{human answers == pred, excluding j} / 3)
with the same normalization pipeline (utils/answer_norm.py); ground-truth
answers are themselves punctuation-processed only when the 10 humans
disagree (vqaEval.py:94-96). Reports overall / perQuestionType /
perAnswerType rounded to n=2 decimals.

The port's own copy of mmnas_tpu/utils/vqa_eval.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional  # noqa: F401

from mmnas_tpu_torch.utils.answer_norm import (
    process_digit_article, process_punctuation,
)


def _norm_res(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


class VqaAnnotations:
    """Question-id indexed annotations+questions (mmnas/utils/vqa.py:24-80)."""

    def __init__(self, annotation_file: str, question_file: str):
        with open(annotation_file) as f:
            self.dataset = json.load(f)
        with open(question_file) as f:
            questions = json.load(f)
        self.qa: Dict[int, dict] = {}
        self.qqa: Dict[int, dict] = {}
        for ann in self.dataset["annotations"]:
            self.qa[ann["question_id"]] = ann
        for q in questions["questions"]:
            self.qqa[q["question_id"]] = q

    def question_ids(self) -> List[int]:
        return list(self.qa.keys())


def evaluate(annotations: VqaAnnotations,
             results: Iterable[dict],
             ques_ids: Optional[List[int]] = None,
             n: int = 2) -> Dict:
    """results: [{question_id, answer}] (EvalAI format). Returns
    {'overall', 'perQuestionType', 'perAnswerType'} (vqaEval.py:68-152)."""
    res = {r["question_id"]: r["answer"] for r in results}
    if ques_ids is None:
        ques_ids = [q for q in annotations.question_ids() if q in res]

    acc_qa: List[float] = []
    acc_ques_type: Dict[str, List[float]] = {}
    acc_ans_type: Dict[str, List[float]] = {}
    per_question: Dict[int, float] = {}

    for qid in ques_ids:
        gt = annotations.qa[qid]
        res_ans = _norm_res(res[qid])
        # official API whitespace-normalizes gt answers before comparison
        # (VQA PythonEvaluationTools vqaEval.py; the reference copy dropped
        # this — restored here so a real-data answer containing '\n' scores
        # identically to the official evaluator)
        answers = [a["answer"].replace("\n", " ").replace("\t", " ").strip()
                   for a in gt["answers"]]
        if len(set(answers)) > 1:
            answers = [process_punctuation(a) for a in answers]
        accs = []
        for j in range(len(answers)):
            others = answers[:j] + answers[j + 1:]
            matching = sum(1 for a in others if a == res_ans)
            accs.append(min(1.0, matching / 3.0))
        avg = sum(accs) / len(accs)
        acc_qa.append(avg)
        acc_ques_type.setdefault(gt["question_type"], []).append(avg)
        acc_ans_type.setdefault(gt["answer_type"], []).append(avg)
        per_question[qid] = round(100 * avg, n)

    if not acc_qa:
        return {"overall": 0.0, "perQuestionType": {}, "perAnswerType": {},
                "perQuestion": {}}
    return {
        "overall": round(100 * sum(acc_qa) / len(acc_qa), n),
        "perQuestionType": {
            t: round(100 * sum(v) / len(v), n)
            for t, v in acc_ques_type.items()},
        "perAnswerType": {
            t: round(100 * sum(v) / len(v), n)
            for t, v in acc_ans_type.items()},
        "perQuestion": per_question,
    }


# ---------------------------------------------------------------------------
# class-style facade matching the official VQA API surface
# (mmnas/utils/vqa.py VQA + vqaEval.py VQAEval), for drop-in use by code
# written against the reference
# ---------------------------------------------------------------------------

class VQA(VqaAnnotations):
    """API-compatible alias: VQA(annotation_file, question_file) with
    getQuesIds() and loadRes(result_file)."""

    def getQuesIds(self) -> List[int]:
        return self.question_ids()

    def loadRes(self, res_file: str):
        """Returns the parsed result list; completeness-checked against the
        annotations (vqa.py:163-166)."""
        with open(res_file) as f:
            results = json.load(f)
        for r in results:
            if r["question_id"] not in self.qa:
                raise ValueError(
                    f"result question_id {r['question_id']} not in annotations")
        return results


class VQAEval:
    """vqaEval.py-shaped wrapper over `evaluate`: construct with the VQA
    annotations and the loaded results, call .evaluate(), read .accuracy."""

    def __init__(self, vqa: VqaAnnotations, results, n: int = 2):
        self.vqa = vqa
        self.results = results
        self.n = n
        self.accuracy: Dict = {}
        self.evalQA: Dict[int, float] = {}

    def evaluate(self, quesIds: Optional[List[int]] = None) -> None:
        stats = globals()["evaluate"](self.vqa, self.results, quesIds, self.n)
        self.evalQA = stats.pop("perQuestion")
        self.accuracy = stats


def evaluate_result_file(dataset, preds) -> Optional[Dict]:
    """Engine hook: score argmax predictions of a VqaDataset against its
    annotation files (train_vqa.py:459-489 flow)."""
    anno_path = getattr(dataset, "anno_path", None)
    ques_path = getattr(dataset, "ques_path", None)
    if not anno_path or not ques_path:
        return None
    annotations = VqaAnnotations(anno_path, ques_path)
    ix_to_ans = dataset.ix_to_ans
    results = [{"question_id": int(qid), "answer": ix_to_ans[int(p)]}
               for qid, p in zip(dataset.qid_list, preds)]
    return evaluate(annotations, results)

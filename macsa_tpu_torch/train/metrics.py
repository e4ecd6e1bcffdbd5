"""Evaluation metrics: per-aspect macro precision/recall/F1.

Numpy implementation of sklearn `precision_recall_fscore_support(...,
average='macro', zero_division=0)` as used by the reference
(reference: run_multimodal_fcmf.py:35-38,544-552): per aspect, macro-average
P/R/F1 over the 4 polarity classes *present in y_true or y_pred*; the final
score averages the per-aspect macro-F1 over the 6 aspects.

A copy of `macsa_tpu/train/metrics.py` for the PyTorch port: the port
writes the same two report files, in the byte format that package pins.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from macsa_tpu_torch.config import ASPECTS, POLARITIES


def macro_prf(y_true: np.ndarray, y_pred: np.ndarray,
              labels: Sequence[int] = None) -> Tuple[float, float, float]:
    """Macro precision/recall/F1 with zero_division=0.

    sklearn semantics: with `labels=None` the label set is the sorted union of
    labels appearing in y_true or y_pred."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = np.union1d(np.unique(y_true), np.unique(y_pred))
    ps, rs, fs = [], [], []
    for c in labels:
        tp = float(np.sum((y_pred == c) & (y_true == c)))
        fp = float(np.sum((y_pred == c) & (y_true != c)))
        fn = float(np.sum((y_pred != c) & (y_true == c)))
        p = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        r = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        ps.append(p); rs.append(r); fs.append(f)
    return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(fs))


def aspect_report(y_true: np.ndarray, y_pred: np.ndarray,
                  aspects: Sequence[str] = ASPECTS) -> Dict[str, Dict[str, float]]:
    """y_true/y_pred: [N, num_aspects] -> per-aspect macro P/R/F1 + average.

    Mirrors the reference's dev/test report (run_multimodal_fcmf.py:544-552,
    660-675)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    report: Dict[str, Dict[str, float]] = {}
    for i, asp in enumerate(aspects):
        p, r, f = macro_prf(y_true[:, i], y_pred[:, i])
        report[asp] = {"precision": p, "recall": r, "f1": f}
    avg = {k: float(np.mean([report[a][k] for a in aspects]))
           for k in ("precision", "recall", "f1")}
    report["average"] = avg
    return report


def format_results_report(report: Dict[str, Dict[str, float]],
                          aspects: Sequence[str] = ASPECTS) -> str:
    """The `test_results_*.txt` byte format: one `{asp}: P=.. R=.. F1=..`
    line per aspect + the `Average:` line (reference:
    run_multimodal_fcmf.py:660-675).  Byte-pinned by
    tests/test_metrics.py::test_report_files_byte_format so the L8
    artifact format cannot drift."""
    lines = []
    for asp in aspects:
        r = report[asp]
        lines.append(f"{asp}: P={r['precision']:.4f} R={r['recall']:.4f} "
                     f"F1={r['f1']:.4f}\n")
    a = report["average"]
    lines.append(f"Average: P={a['precision']:.4f} R={a['recall']:.4f} "
                 f"F1={a['f1']:.4f}\n")
    return "".join(lines)


def format_predictions_dump(texts: Sequence[str], trues: np.ndarray,
                            preds: np.ndarray,
                            aspects: Sequence[str] = ASPECTS) -> str:
    """The human-auditable `test_predictions_formatted.txt` byte format:
    per sentence, predict-vs-label for every aspect (reference:
    run_multimodal_fcmf.py:677-694)."""
    lines = []
    for i, text in enumerate(texts):
        lines.append(f"Sentence: {text}\n")
        for j, asp in enumerate(aspects):
            lines.append(f"  {asp}: predict={POLARITIES[preds[i, j]]} "
                         f"label={POLARITIES[trues[i, j]]}\n")
    return "".join(lines)


def write_test_reports(output_dir: str, report: Dict[str, Dict[str, float]],
                       texts: Sequence[str], trues: np.ndarray,
                       preds: np.ndarray,
                       results_filename: str = "test_results_fcmf.txt",
                       aspects: Sequence[str] = ASPECTS) -> None:
    """Write the two reference artifact files (shared by the FCMF and
    baseline drivers)."""
    with open(os.path.join(output_dir, results_filename), "w") as f:
        f.write(format_results_report(report, aspects))
    with open(os.path.join(output_dir, "test_predictions_formatted.txt"),
              "w") as f:
        f.write(format_predictions_dump(texts, trues, preds, aspects))

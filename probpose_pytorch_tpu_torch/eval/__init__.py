"""Evaluation of the port (copies and ports of probpose_pytorch_tpu/eval/):
the COCO keypoint protocol, calibration, results files, the streaming
top-down pipeline and the eval CLI (run.py)."""

from probpose_pytorch_tpu_torch.eval.calibration import (  # noqa: F401
    calibration_report,
    expected_calibration_error,
    fit_temperature,
)
from probpose_pytorch_tpu_torch.eval.coco_eval import (  # noqa: F401
    COCOKeypointEvaluator,
    oks_matrix,
)
from probpose_pytorch_tpu_torch.eval.pipeline import evaluate_topdown  # noqa: F401
from probpose_pytorch_tpu_torch.eval.results import (  # noqa: F401
    load_results,
    save_results,
    score_results,
)

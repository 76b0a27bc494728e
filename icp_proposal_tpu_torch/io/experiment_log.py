"""Experiment-level results log.

Copy of ``icp_proposal_tpu/io/experiment_log.py``, schema-compatible with
the reference's ``api/sampling/loggers/JSONExperimentLogger.scala:29-86``:
per run the model and target paths, the chain logs' paths, the initial and
best coefficients of the Euclidean, Hausdorff and ICP variants, their metric
maps (avg/hausdorff/dice), the hyperparameters, a datetime and a comment.
Appends are explicit and single-threaded.
"""
from __future__ import annotations

import json
from datetime import datetime
from typing import Dict, List, Sequence


class ExperimentLogger:
    def __init__(self, file_path: str, model_path: str = ""):
        self.file_path = file_path
        self.model_path = model_path
        self.experiments: List[dict] = []

    def append(
        self,
        index: int,
        target_path: str = "",
        sampling_euclidean_logger_path: str = "",
        sampling_hausdorff_logger_path: str = "",
        coeff_init: Sequence[float] = (),
        coeff_sampling_euclidean: Sequence[float] = (),
        coeff_sampling_hausdorff: Sequence[float] = (),
        coeff_icp: Sequence[float] = (),
        sampling_euclidean: Dict[str, float] = None,
        sampling_hausdorff: Dict[str, float] = None,
        icp: Dict[str, float] = None,
        num_of_evaluation_points: int = 0,
        num_of_sample_points: int = 0,
        normal_noise: float = 0.0,
        comment: str = "",
    ) -> None:
        self.experiments.append(
            {
                "index": index,
                "modelPath": self.model_path,
                "targetPath": target_path,
                "samplingEuclideanLoggerPath": sampling_euclidean_logger_path,
                "samplingHausdorffLoggerPath": sampling_hausdorff_logger_path,
                "coeffInit": [float(x) for x in coeff_init],
                "coeffSamplingEuclidean": [float(x) for x in coeff_sampling_euclidean],
                "coeffSamplingHausdorff": [float(x) for x in coeff_sampling_hausdorff],
                "coeffIcp": [float(x) for x in coeff_icp],
                "samplingEuclidean": dict(sampling_euclidean or {}),
                "samplingHausdorff": dict(sampling_hausdorff or {}),
                "icp": dict(icp or {}),
                "numOfEvaluationPoints": int(num_of_evaluation_points),
                "numOfSamplePoints": int(num_of_sample_points),
                "normalNoise": float(normal_noise),
                "datetime": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                "comment": comment,
            }
        )

    def write_log(self) -> None:
        with open(self.file_path, "w") as f:
            json.dump(self.experiments, f, indent=2)

    def load_log(self) -> List[dict]:
        with open(self.file_path) as f:
            return json.load(f)

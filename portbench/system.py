"""The system under test: the port's MH step for a cell, built from the
cell's inputs through the port's public builders.

The model arrays reach the port through ``models.gpmm.make_gpmm``, as a
model file's arrays would; the setup comes from ``apps.femur.SETUPS`` or
``apps.bfm.make_bfm_fitting_setup``, on the shortlist context of
``sampling.context.build_target_context``; the step is
``sampling.mh.make_mh_step``.
"""
from __future__ import annotations

import numpy as np
import torch


class System:
    def __init__(self, inputs: dict, config: dict, cell: dict, device):
        from icp_proposal_tpu_torch.mesh import boundary_vertex_mask, make_mesh
        from icp_proposal_tpu_torch.models.gpmm import make_gpmm
        from icp_proposal_tpu_torch.sampling import mh

        self.device = device
        model = make_gpmm(inputs["ref_points"], inputs["cells"], inputs["mean"],
                          inputs["basis"], inputs["variance"], device=device)
        target = make_mesh(inputs["target_points"], inputs["target_cells"])
        tmask = boundary_vertex_mask(inputs["target_cells"], len(inputs["target_points"]))
        mmask = boundary_vertex_mask(inputs["cells"], len(inputs["ref_points"]))
        setup = cell["setup"]
        if setup == "bfm-partial":
            from icp_proposal_tpu_torch.apps.bfm import BfmData, make_bfm_fitting_setup

            data = BfmData(model=model, target=target, target_partial=target,
                           model_boundary_mask=mmask, target_boundary_mask=tmask,
                           partial_boundary_mask=tmask)
            _, mixture, evaluator = make_bfm_fitting_setup(data, partial=True)
        else:
            from icp_proposal_tpu_torch.apps.femur import SETUPS, FemurData

            data = FemurData(model=model, target=target, target_boundary_mask=tmask,
                             model_boundary_mask=mmask)
            _, mixture, evaluator = SETUPS[setup](data, coarse=cell.get("coarse", "exact"))
        names = [c["name"] for c in cell["mixture"]]
        weights = np.asarray([c["weight"] for c in cell["mixture"]])
        if mixture.names != names or not np.allclose(mixture.weights, weights / weights.sum(),
                                                     rtol=0, atol=1e-9):
            raise ValueError(f"setup {setup!r} builds {list(zip(mixture.names, mixture.weights))}"
                             f", the cell describes {list(zip(names, weights))}")
        self.model, self.mixture, self.evaluator = model, mixture, evaluator
        self.step = mh.make_mh_step(model, mixture, evaluator,
                                    store_params=bool(cell["store_params"]))
        self._mh = mh

    def init_carry(self, state: dict):
        """The carry at ``state`` (host or device tensors of FitState's
        fields)."""
        from icp_proposal_tpu_torch.sampling.state import FitState

        st = FitState(**{k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                         for k, v in state.items()})
        return self._mh.init_carry(self.model, self.evaluator, st, self.mixture)

    def noise(self, z, idx, log_u):
        return self._mh.StepNoise(z=z, idx=idx, log_u=log_u)

"""The port's entry points put their tensors on the card unless the caller
asks for the CPU, and never move to the CPU on their own."""
import functools
import inspect

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.apps import bfm, femur
from icp_proposal_tpu_torch.device import resolve_device
from icp_proposal_tpu_torch.mesh import make_mesh
from icp_proposal_tpu_torch.models import build_femur, gpmm
from icp_proposal_tpu_torch.ops import surface_index
from icp_proposal_tpu_torch.sampling import context, loggers

_PTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
_CELLS = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
_MODEL = dict(ref_points=_PTS, cells=_CELLS, mean_disp=np.zeros_like(_PTS),
              basis=np.ones((4, 3, 1)), variance=np.ones(1))
_LOG = [{"index": 0, "name": "RandomShape-0.1", "logvalue": {"product": -1.0},
         "status": True, "rigid": [0.0] * 9, "coeff": [0.0], "datetime": ""}]

ENTRY_POINTS = {
    "apps.femur.load_standin_femur_data": (femur.load_standin_femur_data, ()),
    "apps.bfm.load_synthetic_face_data": (bfm.load_synthetic_face_data, (1, 1)),
    "models.build_femur.build_femur_gpmm": (build_femur.build_femur_gpmm,
                                            (_PTS, _CELLS, 1)),
    "models.gpmm.make_gpmm": (gpmm.make_gpmm, tuple(_MODEL.values())),
    "sampling.context.build_target_context": (context.build_target_context,
                                              (make_mesh(_PTS, _CELLS),)),
    "sampling.context.build_target_context[coarse=dot]": (
        functools.partial(context.build_target_context, coarse="dot"),
        (make_mesh(_PTS, _CELLS),)),
    "apps.femur.run_icp_proposal_registration": (femur.run_icp_proposal_registration,
                                                 (2,)),
    "sampling.loggers.state_from_log": (loggers.state_from_log, (_LOG, "last")),
    "ops.surface_index.build_surface_index": (surface_index.build_surface_index,
                                              (_PTS, _CELLS, 2)),
    "convert.gpmm_from_arrays": (convert.gpmm_from_arrays,
                                 (*_MODEL.values(), 0.0, np.ones((4, 3, 1)),
                                  np.ones((1, 1)))),
    "convert.context_from_arrays": (convert.context_from_arrays,
                                    (_PTS, _CELLS, _PTS[_CELLS], np.zeros(4, bool))),
    "convert.state_from_arrays": (convert.state_from_arrays,
                                  (np.ones(2), np.zeros((2, 3)), np.zeros((2, 3)),
                                   np.zeros((2, 3)), np.zeros((2, 1)))),
    "convert.bfm_data_from_arrays": (convert.bfm_data_from_arrays,
                                     (dict(**_MODEL, noise_variance=0.0,
                                           sbasis=np.ones((4, 3, 1)),
                                           coeff_chol=np.ones((1, 1))),
                                      _PTS, _CELLS, _PTS, _CELLS, np.zeros(4, bool),
                                      np.zeros(4, bool), np.zeros(4, bool))),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    """``device`` defaults to "cuda"; without a card that default raises
    (before any host build) instead of running on the CPU."""
    fn, args = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)


def test_carry_from_arrays_defaults_to_the_card():
    assert inspect.signature(convert.carry_from_arrays).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")

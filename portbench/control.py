"""The control: the reference put in the program's place, computed one
precision below the configuration's: float32 with TF32 matrix products
(the configuration states float32 with TF32 off).  It steps every chain
of the cell from the same inputs and noise and yields the same records as
the port's step, so ``run.run_cell`` drives and judges it unchanged; its
numbers must fail the cell's limits."""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch

from portbench.reference.sampler import Reference, State


@contextlib.contextmanager
def tf32():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])


class ControlSystem:
    def __init__(self, inputs: dict, config: dict, cell: dict, device):
        self.ref = Reference(inputs, {**cell, "index_k": config["index_k"]}, device,
                             dtype=torch.float32)
        self.adapt = cell.get("adapt")
        self.ncomp = len(cell["mixture"])

    def init_carry(self, state: dict):
        st = State(**{k: torch.as_tensor(v, dtype=torch.float32) for k, v in state.items()})
        n = st.coeffs.shape[0]
        log_s = torch.zeros((n, self.ncomp), device=st.coeffs.device)
        return SimpleNamespace(state=st, log_s=log_s, k=0)

    @staticmethod
    def noise(z, idx, log_u):
        return z, idx, log_u

    def step(self, carry, noise):
        z, idx, log_u = noise
        scales = torch.exp(carry.log_s) if self.adapt else None
        with tf32():
            cand, lp, la, acc = self.ref.step(carry.state, z, idx, log_u, scales)
        new = cand.where(acc, carry.state)
        log_s = carry.log_s
        if self.adapt:
            log_s = self.ref.update_log_scales(log_s, carry.k, idx, la)
        rec = SimpleNamespace(accepted=acc, log_product=lp, log_alpha=la,
                              coeffs=new.coeffs,
                              pose=torch.cat([new.trans, new.rot, new.center], -1))
        return SimpleNamespace(state=new, log_s=log_s, k=carry.k + 1), rec

"""The benchmark of ``icp_proposal_tpu_torch``, the PyTorch + CUDA port, on
one NVIDIA H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  It imports neither JAX nor the JAX package,
and its reference (``portbench/reference``) imports nothing of the port."""

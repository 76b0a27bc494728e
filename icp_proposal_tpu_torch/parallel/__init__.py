from icp_proposal_tpu_torch.parallel.runner import (  # noqa: F401
    make_chain_mesh,
    run_sharded_chains,
)

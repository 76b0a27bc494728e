from icp_proposal_tpu_torch.analysis.posterior_variability import (  # noqa: F401
    variability_map_normal,
    variability_map_total,
)

from .campaign import (CampaignConfig, CampaignResult, derive_seed,
                       run_campaign, sweep, sweep_schemes, wilson_interval)
from .models import (CompositeFault, FaultModel, RetentionDrift,
                     StuckAtFaults, TransientBitFlips, TransientGateFaults,
                     flip_random_bits_, inject_bit_flips, pack_flip_mask)

__all__ = ["FaultModel", "TransientBitFlips", "TransientGateFaults",
           "StuckAtFaults", "RetentionDrift", "CompositeFault",
           "flip_random_bits_", "inject_bit_flips", "pack_flip_mask",
           "CampaignConfig", "CampaignResult", "derive_seed", "run_campaign",
           "sweep", "sweep_schemes", "wilson_interval"]

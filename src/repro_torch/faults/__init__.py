from .campaign import wilson_interval
from .models import (FaultModel, TransientBitFlips, TransientGateFaults,
                     flip_random_bits_)

__all__ = ["FaultModel", "TransientBitFlips", "TransientGateFaults",
           "flip_random_bits_", "wilson_interval"]

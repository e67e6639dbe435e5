from .models import FaultModel, TransientBitFlips, flip_random_bits_

__all__ = ["FaultModel", "TransientBitFlips", "flip_random_bits_"]

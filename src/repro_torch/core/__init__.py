from . import arena, bitops, reliability, tmr

__all__ = ["arena", "bitops", "reliability", "tmr"]

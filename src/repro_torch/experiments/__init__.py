"""The paper's figure experiments on the port (counterparts of
`benchmarks/campaign_mc.py`, `fig4_nn.py` and `fig5_weights.py`).  Each
module has ``run(device=None, smoke=False) -> rows`` and a ``__main__``;
they run on CUDA unless the caller passes ``device="cpu"``."""

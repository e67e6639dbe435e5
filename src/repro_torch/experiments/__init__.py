"""The paper's experiments on the port (counterparts of
`benchmarks/campaign_mc.py`, `fig4_nn.py`, `fig5_weights.py` and
`tmr_tradeoff.py`).  Each module has ``run(device=None, ...) -> rows`` and
a ``__main__`` printing ``name,us,derived`` rows; they run on CUDA unless
the caller passes ``device="cpu"``."""

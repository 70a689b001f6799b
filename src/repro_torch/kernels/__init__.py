"""Hand-written CUDA kernels (``csrc/*.cu``), their wrappers and their plain
PyTorch versions: the graph kernels (``edge_block``), flash attention
(``flash_attention``) and the Mamba2 SSD chunk step (``ssd_scan``); the
public entry points are in ``ops``, the oracles in ``ref``."""

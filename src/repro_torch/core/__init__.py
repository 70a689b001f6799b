"""Agent-side mechanisms: blocks, pipeline shuffle, sync caching/skipping,
balancing lemmas, the vertex-program template, and the deprecated
``GXEngine`` shim (``core/engine.py``).  The public middleware API
(protocol seams + drive loop) lives in the sibling package
``repro_torch.plug``."""

"""``repro_torch`` — the GX-Plug middleware on PyTorch and CUDA.

A second package beside the JAX package ``repro``, mirroring its layout
(``configs``, ``core``, ``dist``, ``graph``, ``kernels``, ``launch``,
``models``, ``oocore``, ``plug``, ``serve``, ``train``) so each module's
counterpart sits at the same path.  It imports ``torch`` and ``numpy`` only; the JAX
package is the reference it is tested against (``tests/test_torch_*.py``).

The entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU.  The kernels — the fused CSR-tile and edge-block graph
programs, flash attention and the Mamba2 SSD chunk step — are hand-written
CUDA C++ for ``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` at first
use (``kernels/build.py``).
"""

"""GYM on PyTorch: the port of the ``repro`` JAX package to PyTorch and CUDA.

The layout mirrors ``repro`` (``core/``, ``relational/``, ``kernels/``,
``data/``) so each module has a counterpart of the same name there.  The
package imports ``torch`` and ``numpy`` only; it keeps its own copies of
the framework-free planners.

Entry point: ``repro_torch.core.gym.gym(query, data, p=..., device=...)``,
which runs on the CUDA card unless the caller passes ``device="cpu"``.
The shard-local hot loops run on hand-written Hopper kernels
(``csrc/gym_kernels.cu``, built at first use by ``kernels/build.py``) or,
for CPU tensors, on their plain PyTorch versions.
"""

"""PyTorch/CUDA port of the serving engine for one NVIDIA H100.

The package mirrors ``tpu_engine``'s layout module for module, so each
counterpart is found under the same path, but it is written in PyTorch's
idiom: plain functions on tensors, an explicit ``device`` argument on every
entry point, and explicit ``torch.Generator`` objects for randomness.

It imports ``torch``, numpy and the standard library only. It never
imports ``jax`` or anything of ``tpu_engine``; what it needs of the JAX
package's jax-free modules it keeps as its own copy.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (the tests do). Nothing falls back to the CPU quietly:
``utils.device.resolve_device`` raises when no card is present.

Every TPU kernel of the JAX package (each ``pallas_call`` of
``tpu_engine/ops/paged_attention.py`` and ``tpu_engine/ops/flash.py``) is
ported by hand to CUDA C++ for ``sm_90a`` in ``csrc/``; ``ops.kernels``
builds them with ``nvcc`` at first use and binds them with ``ctypes``.
"""

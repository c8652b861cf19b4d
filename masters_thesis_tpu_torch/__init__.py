"""masters_thesis_tpu_torch — the PyTorch and CUDA port of masters_thesis_tpu
for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package mirrors its file
layout and names, imports ``torch`` and never ``jax``, and reuses the JAX
package's framework-free modules (``ops.group_layout``, ``data.tokenizer``,
``data.synthetic``, ``evalsuite.tokens``, ``serve`` at module level,
``server``) instead of copying them. Every Pallas kernel on a ported
path becomes a hand-written Hopper kernel under ``csrc/``, with a plain
PyTorch version beside it.

Ported so far: the LcNIC greedy serving path (``serve.Captioner`` ->
``models.nic`` -> ``ops.fused_decode``) in fp32, eval mode. The JAX
package's ``server.make_caption_server`` serves the port's ``Captioner`` as
it is.
"""

from masters_thesis_tpu.version import __version__

__all__ = ["__version__"]

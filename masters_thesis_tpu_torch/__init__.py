"""masters_thesis_tpu_torch — the PyTorch and CUDA port of masters_thesis_tpu
for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package mirrors its file
layout and names, imports ``torch`` and never ``jax``, and reuses the JAX
package's framework-free modules (``ops.group_layout``, ``data.tokenizer``,
``data.synthetic``, ``data.pairs``, ``data.splits``, ``data.pipeline``,
``evalsuite.tokens``, ``serve`` at module level, ``server``) instead of
copying them. Every Pallas kernel on a ported
path becomes a hand-written Hopper kernel under ``csrc/``, with a plain
PyTorch version beside it.

Ported so far, in fp32: the LcNIC greedy serving path (``serve.Captioner``
-> ``models.nic`` -> ``ops.fused_decode``, K2), which the JAX package's
``server.make_caption_server`` serves as it is; and LcNIC training
(``data.store`` -> ``ops.gather``, K1 -> ``models`` in training mode ->
``train.losses``, ``train.optim``, ``train.steps`` -> ``train.loop.Trainer``
over the shared ``BatchPipeline``).
"""

from masters_thesis_tpu.version import __version__

__all__ = ["__version__"]

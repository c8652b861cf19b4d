"""masters_thesis_tpu_torch — the PyTorch and CUDA port of masters_thesis_tpu
for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package mirrors its file
layout and names, imports ``torch`` and never ``jax``, and imports nothing of
the JAX package: the framework-free modules it needs (``ops.group_layout``,
``data.tokenizer``, ``data.pairs``, ``data.splits``, ``data.pipeline``,
``data.synthetic``, ``evalsuite.tokens``, ``serve.padded_chunk_ids`` and
``server``) are its own copies, held against their originals by the tests.
Every Pallas kernel on a ported path becomes a hand-written Hopper kernel
under ``csrc/``, with a plain PyTorch version beside it.

Ported so far, in fp32: LcNIC greedy serving (``serve.Captioner`` ->
``models.nic`` -> ``ops.fused_decode``, K2) and CnnRnn (GRU) greedy serving
on InceptionV3 patch rows (the same path, K3), behind the port's
``server.make_caption_server``; and LcNIC training (``data.store`` ->
``ops.gather``, K1 -> ``models`` in training mode -> ``train.losses``,
``train.optim``, ``train.steps`` -> ``train.loop.Trainer`` over
``data.pipeline.BatchPipeline``), which under ``tpu.fused_seq`` trains the
decoder through the fused teacher-forced sequence's custom backward
(``ops.fused_seq``, whose eval-mode forward is K4). Entry points run on
the card (``cuda``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]

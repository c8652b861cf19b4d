"""masters_thesis_tpu_torch — the PyTorch and CUDA port of masters_thesis_tpu
for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package mirrors its file
layout and names, imports ``torch`` and never ``jax``, and imports nothing of
the JAX package: the framework-free modules it needs (``ops.group_layout``,
``data.tokenizer``, ``data.pairs``, ``data.splits``, ``data.pipeline``,
``data.synthetic``, ``data.captions``, ``data.pack``, ``data.nsd_images``,
``data.preprocess`` but its PCA, ``evalsuite``, ``utils.logging``,
``utils.tensorboard``, ``utils.farmhash``, ``utils.keras_import``,
``tune``, ``serve.padded_chunk_ids`` and ``server``) are its own
copies, held against their originals by the tests.
Every Pallas kernel on a ported path becomes a hand-written Hopper kernel
under ``csrc/``, with a plain PyTorch version beside it.

Ported so far, in fp32: LcNIC greedy serving (``serve.Captioner`` ->
``models.nic`` -> ``ops.fused_decode``, K2) and CnnRnn (GRU) greedy serving
on InceptionV3 patch rows (the same path, K3) or on pixels, InceptionV3
or EfficientNet-B3 inside the encoder (``models.encoders.PixelPatchDense``),
behind the port's ``server.make_caption_server``; LcNIC training
(``data.store`` -> ``ops.gather``, K1 -> ``models`` in training mode ->
``train.losses``, ``train.optim``, ``train.steps`` ->
``train.loop.Trainer`` over
``data.pipeline.BatchPipeline``), which under ``tpu.fused_seq`` trains the
decoder through the fused teacher-forced sequence's custom backward
(``ops.fused_seq``, whose eval-mode forward is K4); and the training
product around them: ``config`` (the full schema and its own YAML
reader), ``experiment`` (``run_training`` with the callbacks of
``train.callbacks`` and the async checkpoints of ``train.checkpoint``,
``run_eval``, ``run_metrics`` over the copied ``evalsuite``),
``Captioner.from_run_dir`` and the CLI (``python -m
masters_thesis_tpu_torch train|eval|metrics|caption``), for every model
family of the JAX package (``train.state.model_for``: the NIC variants,
the other encoders, ShowTell, GuseNIC, Ms2NIC), with beam search
(``decode.beam``) and sampling (``decode.sampling``); and the input side:
real NSD data in ``experiment.build_data``, ``experiment.run_preprocess``
(session files -> pack -> statistics -> vc mask, normalize and a PCA
fitted and applied on the card), the transform chain behind
``caption/serve --pre``, and the CNN backbones (``models.backbones``,
``resnet``, ``inception``, ``efficientnet``) behind ``features``; and the
sweep's side: the USE-DAN sentence encoder (``models.use_encoder``, with
its own copy of ``utils.farmhash``) behind ``guse`` and ``score`` and
``run_metrics``' ``GUSE_*`` scores, the hyper-parameter sweep (``tune``:
search, ASHA, trial processes and the shared-filesystem queue, copied)
behind ``tune``, and the Keras weight import (``utils.keras_import``,
copied); and ``parallel/``: training over a ('data', 'model') mesh of
ranks, one process and one device a rank (``parallel.mesh``,
``parallel.sharding``: the flagship's encoder, embedding and head compute
with their shards, collectives in ``parallel.collectives``), ``train
--processes``, data-parallel serving replicas (``caption/serve --shard``),
``dryrun`` and ``tpu.vocab_pad_multiple``. Entry points run on the card
(``cuda``) unless the caller passes ``device="cpu"`` (the CLI: ``--device
cpu``).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]

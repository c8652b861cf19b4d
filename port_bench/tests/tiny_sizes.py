"""The tiny sizes of the configurations added after ``tiny.py``, whose
file, like every file of the accepted benchmark, does not change:
``register`` adds them to ``tiny.CONFIGS`` and ``tiny.STORES``, so that
every tiny copy cuts them down too. ``conftest.py`` registers them before
any test makes a copy, and gives the same call to the script that
``test_port_bench_nojax.py`` runs in a fresh interpreter."""

from __future__ import annotations

from port_bench.tests import tiny

# InceptionV3 at its published widths on 107 x 107 images (a 2 x 2
# mixed10 map: 4 patches of 2,048 channels), the decoder cut as cnn_rnn's
CONFIGS = {
    "cnn_rnn_inception_v3": dict(image_size=[107, 107], n_patches=4,
                                 embed_dim=8, units=16, vocab_size=60,
                                 max_length=6),
}
STORES = {"cnn_rnn_inception_v3": dict(keys=40, train_keys=30,
                                       test_keys=10)}
# the line that registers them, for a script that imports ``tiny``
REGISTER = "from port_bench.tests import tiny_sizes; tiny_sizes.register()\n"


def register() -> None:
    tiny.CONFIGS.update(CONFIGS)
    tiny.STORES.update(STORES)

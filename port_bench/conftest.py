"""Registers the tiny size of ``cnn_rnn_efficientnet_b3`` before any test
makes a tiny copy, and in the script that ``test_port_bench_nojax.py::
test_a_run_loads_no_jax`` runs in a fresh interpreter, right after it
imports ``tiny``: ``tiny.py``, ``tests/tiny_sizes.py`` and
``tests/conftest.py`` belong to the accepted benchmark and do not change,
and without this a tiny copy would run the configuration at its full
size on the CPU. EfficientNet-B3 keeps its published widths; only the
image is cut, to 64 x 64 (a 2 x 2 top map: 4 patches), and the decoder as
``cnn_rnn``'s."""

from port_bench.tests import tiny

CONFIGS = {
    "cnn_rnn_efficientnet_b3": dict(image_size=[64, 64], n_patches=4,
                                    embed_dim=8, units=16, vocab_size=60,
                                    max_length=6),
}
STORES = {"cnn_rnn_efficientnet_b3": dict(keys=40, train_keys=30,
                                          test_keys=10)}
IMPORT_TINY = "from port_bench.tests import tiny\n"
# the line that registers them, for a script that imports ``tiny``
REGISTER = ("from port_bench import conftest as _sizes; "
            "_sizes.register()\n")


def register() -> None:
    tiny.CONFIGS.update(CONFIGS)
    tiny.STORES.update(STORES)


register()


def pytest_collection_modifyitems(items):
    for module in {item.module for item in items}:
        script = getattr(module, "RUN_TINY", None)
        if script is not None and REGISTER not in script:
            assert IMPORT_TINY in script, module.__name__
            module.RUN_TINY = script.replace(IMPORT_TINY,
                                             IMPORT_TINY + REGISTER)

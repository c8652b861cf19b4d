"""Registers the tiny sizes of the configurations added after ``tiny.py``
(``tiny_sizes.py``) before any test makes a tiny copy, and in the script
that ``test_port_bench_nojax.py::test_a_run_loads_no_jax`` runs in a fresh
interpreter, right after it imports ``tiny``: without them a tiny copy
would run those configurations at their full sizes on the CPU."""

from port_bench.tests import tiny_sizes

tiny_sizes.register()

IMPORT_TINY = "from port_bench.tests import tiny\n"


def pytest_collection_modifyitems(items):
    for module in {item.module for item in items}:
        script = getattr(module, "RUN_TINY", None)
        if script is not None and tiny_sizes.REGISTER not in script:
            assert IMPORT_TINY in script, module.__name__
            module.RUN_TINY = script.replace(
                IMPORT_TINY, IMPORT_TINY + tiny_sizes.REGISTER)

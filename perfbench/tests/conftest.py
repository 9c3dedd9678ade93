"""The benchmark's tests. Those marked ``card`` need a CUDA device and the
cell's full sizes; each decides inside the test whether there is a card and
skips without one:

    python3 -m pytest perfbench/tests -m card
"""
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


def pytest_runtest_setup(item):
    torch.set_num_threads(2)

"""Small CPU runs of the harness for the tests: every cell at a tiny scale,
with fewer answers and lixels checked (the code path is the card's)."""
import contextlib
import os

import torch

from tnkde_bench.harness import cell as C

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ROOT_PATHS = [HERE, os.path.join(ROOT, "src"), ROOT]  # for subprocesses
SCALE = 0.02
SEED = 2**31 + 101  # larger than 32 signed bits hold: seeds of any size must work


@contextlib.contextmanager
def small_checks(answers=2, lixels=48):
    orig = C.load_cell

    def load(name, root=C.BENCH):
        wl, cfg = orig(name, root)
        return {**wl, "check": {**wl["check"], "answers": answers, "lixels": lixels}}, cfg

    C.load_cell = load
    try:
        yield
    finally:
        C.load_cell = orig


def run_small(cell, *, seed=SEED, seconds=1.0, trace=False, overrides=None, lixels=48, **kw):
    """``lixels`` above the cell's lixel count checks every lixel."""
    torch.set_num_threads(2)
    with small_checks(lixels=lixels):
        return C.run_cell(cell, seed, seconds, trace, device="cpu",
                          overrides={"scale": SCALE, **(overrides or {})}, **kw)

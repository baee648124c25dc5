"""The port's ``examples/generate.py`` on the CPU against the reference's
gate (tests/test_transformer_generate.py): trained on ``train_lm.py``'s
2nd-order Markov chain, the LM generates through the one-token decode graph
(sampling) and through ``GenerateScan`` (greedy), and more than 0.4 of the
generated transitions must be legal under the true table (about 3/32
untrained). 300 training steps, where the reference's test takes 350, keep
the file near 10 s; the script's default is 600."""
import numpy as np
import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.examples import generate as gen

STEPS = 300
GATE = 0.4


@pytest.fixture(scope="module")
def trained():
    mxt.random.seed(0)
    np.random.seed(0)
    return gen.train(mxt.cpu(), steps=STEPS)


def _prime():
    return np.random.RandomState(3).randint(0, gen.VOCAB, (16, 2))


def test_generate_learns_the_chain(trained):
    table, arg_params = trained
    step = gen.generator(arg_params, mxt.cpu(), batch=16, max_len=gen.SEQ)
    toks = gen.generate(step, _prime(), gen.SEQ - 2, greedy=False)
    assert toks.shape == (16, gen.SEQ)
    frac = gen.legal_fraction(toks, table)
    assert frac > GATE, f"legal fraction {frac} barely above chance"
    info = step.executor.forward_info()
    assert info["eager_runs"] == gen.SEQ and info["drops"] == 0


def test_generate_scan_learns_the_chain(trained):
    table, arg_params = trained
    prime = _prime()
    toks = gen.generate_scan(arg_params, prime, gen.SEQ - 2, mxt.cpu())
    np.testing.assert_array_equal(toks[:, :2], prime)
    frac = gen.legal_fraction(toks, table)
    assert frac > GATE, f"legal fraction {frac} barely above chance"
    step = gen.generator(arg_params, mxt.cpu(), batch=16, max_len=gen.SEQ)
    np.testing.assert_array_equal(
        toks, gen.generate(step, prime, gen.SEQ - 2, greedy=True))

import random

import pytest

from repro.core import grammars
from repro.core.sampling import GrammarSampler
from repro.tokenizer import train_bpe


@pytest.fixture(scope="session")
def json_grammar():
    return grammars.load("json")


@pytest.fixture(scope="session")
def small_tokenizer(json_grammar):
    """A small BPE tokenizer trained on grammar-sampled text (cached for
    the whole session; training is the slow part)."""
    corpus = GrammarSampler(json_grammar, seed=7).corpus(150)
    corpus += GrammarSampler(grammars.load("c"), seed=3).corpus(60)
    return train_bpe(corpus, vocab_size=420)


@pytest.fixture()
def rng():
    return random.Random(1234)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")

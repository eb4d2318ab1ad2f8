"""The port's SFPrompt round on token data against the JAX package's for
the reduced zamba2 (Mamba-2 layers and one shared attention block copied
into each segment; 18 layers, 3 cycles of 6), with the helpers and
settings of tests/test_torch_lm_round.py: wire bytes, kept sets and
kept_frac `==`, params and losses within 1e-5 on the fp32 wire and on the
int8 wire (JAX's noise, init seed `INT8_SEED`), `evaluate` CE within 1e-5
and accuracy `==`. The shared block's position placeholder in each stack
is a leaf no loss reads: its gradient is zero, as `jax.grad` gives it."""
import torch

torch.set_num_threads(2)

import os  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_lm_round as lm  # noqa: E402

ARCH = "zamba2-2.7b"


@pytest.fixture(scope="module")
def rounds():
    return lm.round_cache()


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_zamba2_lm_round_matches_jax(rounds, wire):
    lm.check_round(rounds(ARCH, wire))


def test_zamba2_lm_kept_sets_match_jax(rounds):
    lm.check_kept(rounds(ARCH, "fp32"))


def test_zamba2_lm_evaluate_matches_jax(rounds):
    lm.check_evaluate(rounds(ARCH, "fp32"))

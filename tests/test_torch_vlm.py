"""Qwen2-VL in the port against the JAX package, on bridged weights: the
reduced qwen2-vl-72b (`reduced(n_layers=3, d_model=64, d_ff=128,
vocab_size=128)`: 2 / 2 heads of 32, M-RoPE sections (4, 6, 6), QKV bias,
theta 1e6), split head 1 / body 1 / tail 1 with a prompt of 4, batches
with 8 `patch_embeds` and their M-RoPE positions on a (2, 2, 2) grid
(stored client-axis-first as (B, 3, 8)), as tests/test_models.py's.

- `mrope_cos_sin` against JAX's at the published sections (16, 24, 24),
  rot 128, theta 1e6, and at the reduced ones (1e-5);
- the embedding frontend's positions `==` JAX's: [prompt | patches |
  text], the grid offset by the prompt length, prompt and text at their
  sequence index on all three streams (the JAX package's layout, not
  Qwen2-VL's "largest grid position + 1"), masking and cache slots at the
  sequence index;
- the split forward in train mode and a prefill then four decode steps,
  with and without the grid positions, on the fp32 and int8 wires: logits
  and caches within 1e-5, wire bytes and positions `==`;
- SFPrompt rounds with the patch keys and on token-only data, on both
  wires, and `evaluate` (as tests/test_torch_whisper.py checks them);
- both serving engines refuse the model with JAX's messages.

The int8 draws (init seed 0, numpy seeds 0 and 1) flip no quantizer
value (ROADMAP Queue 3 item 2); none had to be changed for it."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import embed  # noqa: E402
from test_torch_whisper import (  # noqa: E402
    PROMPT, TOL, check_engines_refuse, check_evaluate, check_forward,
    check_kept, check_round, check_serve, extras, jtree, models,
    round_cache, ttree)

ARCH = "qwen2-vl-72b"


@pytest.mark.parametrize("sections,rot", [((16, 24, 24), 128),
                                          ((4, 6, 6), 32)])
def test_mrope_cos_sin_matches_jax(sections, rot):
    """Three position streams that differ (a video's time, height and
    width), positions up to 300, theta 1e6."""
    rng = np.random.default_rng(6)
    pos = rng.integers(0, 300, (3, 2, 21)).astype(np.int32)
    jc, js = JL.mrope_cos_sin(jnp.asarray(pos), sections, rot, 1e6)
    tc, ts = L.mrope_cos_sin(torch.from_numpy(pos), sections, rot, 1e6)
    assert tc.shape == jc.shape == (2, 21, rot // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    with pytest.raises(ValueError, match="sections"):
        L.mrope_cos_sin(torch.from_numpy(pos), (1, 2, 3), rot, 1e6)


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("grid", [True, False])
def test_vlm_positions_match_jax(mode, grid):
    """The port's `embed` against JAX's `SplitModel._embed`: the rows,
    the (3, B, T) M-RoPE positions, the sequence positions and n_prefix."""
    jm, tm = models(ARCH, "fp32")
    params = jm.init(jax.random.PRNGKey(0))
    emb = jax_to_torch(params["head"]["embed"], "cpu")
    prompt = np.array(params["prompt"])
    rng = np.random.default_rng(7)
    if mode == "decode":
        batch = {"tokens": rng.integers(0, 128, (2, 1)).astype(np.int32),
                 "pos": np.array([19, 23], np.int32)}
    else:
        batch = dict(tokens=rng.integers(0, 128, (2, 5)).astype(np.int32),
                     **extras(tm.cfg, rng, 2, grid=grid))
    jx, jpos, jbase, jn = jm._embed(params["head"], jtree(batch), mode,
                                    jnp.asarray(prompt), jnp.float32)
    tx, tpos, tbase, tn = embed(tm.cfg, emb, ttree(batch), mode,
                                torch.from_numpy(prompt), torch.float32)
    assert tn == jn == (0 if mode == "decode" else PROMPT + 8)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tbase.numpy(), np.asarray(jbase))
    assert tpos.shape[0] == 3
    if mode == "train" and grid:
        # prompt rows, then the grid offset by the prompt, then the text
        np.testing.assert_array_equal(tpos[:, 0, :PROMPT].numpy(),
                                      np.broadcast_to(np.arange(4), (3, 4)))
        assert int(tpos[:, 0, PROMPT:PROMPT + 8].max()) == PROMPT + 1
        np.testing.assert_array_equal(
            tpos[:, 0, PROMPT + 8:].numpy(),
            np.broadcast_to(np.arange(PROMPT + 8, PROMPT + 13), (3, 5)))


@pytest.mark.parametrize("route", ["split", "local"])
@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_vlm_train_forward_matches_jax(wire, route):
    out = check_forward(ARCH, wire, route)
    assert out["n_prefix"] == PROMPT + 8
    assert out["logits"].shape == (3, PROMPT + 8 + 9, 128)


@pytest.mark.parametrize("wire,window,grid", [
    ("fp32", 32, True), ("int8", 16, True), ("fp32", 16, False)])
def test_vlm_prefill_then_decode_matches_jax(wire, window, grid):
    """Prefill of [prompt | 8 patches | 7 tokens] (19 rows; window 16
    makes the ring wrap), then decode at positions 19-22: decode's
    positions are the sequence index on all three streams."""
    b = check_serve(ARCH, wire, window, grid=grid)
    per, scale = (4, 0) if wire == "fp32" else (1, 4)
    assert b["prefill"]["head_body"] == 2 * 19 * (64 * per + scale)
    assert b["decode"]["head_body"] == 2 * (64 * per + scale)


@pytest.fixture(scope="module")
def rounds():
    return round_cache()


@pytest.mark.parametrize("modal", [True, False])
@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_vlm_round_matches_jax(rounds, wire, modal):
    """With `patch_embeds` and `mrope_positions` in the cohort, and on
    token-only data (JAX's round runs both)."""
    check_round(rounds(ARCH, wire, modal))


@pytest.mark.parametrize("modal", [True, False])
def test_vlm_kept_sets_match_jax(rounds, modal):
    check_kept(rounds(ARCH, "fp32", modal))


@pytest.mark.parametrize("modal", [True, False])
def test_vlm_evaluate_matches_jax(rounds, modal):
    check_evaluate(rounds(ARCH, "fp32", modal))


def test_vlm_engines_refuse_as_jax():
    check_engines_refuse(ARCH, "arch_type 'vlm' has no token decode loop")

"""The port's CLIP towers, tokenizer, toy towers and CLIP loss (`models/clip.py`,
`models/bpe.py`, `models/toy_clip.py`, `losses/clip_loss.py`) against the JAX
package's (`models/clip_jax.py`, `models/bpe.py`, `models/toy_clip.py`,
`losses/clip_loss.py`).

Weights come from the port's seeded random init and are carried into the JAX
layout with `convert.torch_to_jax`. The full towers are compiled by JAX once
in this file (`jax_full_towers`): one jit that runs `multi_level_clip_loss`
on four 224x224 inputs (two taps of two images), the text tower on two
prompts, and `clip_score` on the second tap's features, all at float32.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moegan_tpu.losses.clip_loss import clip_score as jax_clip_score
from moegan_tpu.losses.clip_loss import multi_level_clip_loss as jax_multi_level
from moegan_tpu.models import bpe as jax_bpe
from moegan_tpu.models import clip_jax
from moegan_tpu.models import toy_clip as jax_toy
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.losses.clip_loss import clip_score, multi_level_clip_loss
from moegan_tpu_torch.models import bpe, clip, toy_clip
from tests.torch_helpers import randn, t, unflatten

PROMPTS = ["a red circle on a dark background", "Ünïcode & punctuation: 3 squares!"]


def _jax_params(module) -> dict:
    return unflatten(torch_to_jax(module.state_dict()))


def _images(seed, n, res):
    return np.tanh(randn(seed, n, res, res, 3) * 1.5)


@pytest.mark.parametrize("res", [8, 16, 32, 64])
def test_preprocess_for_clip_matches_jax(res):
    x = _images(res, 2, res)
    want = np.asarray(clip_jax.preprocess_for_clip(jnp.asarray(x)))
    got = clip.preprocess_for_clip(t(x)).numpy()
    assert got.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_residual_attention_block_matches_jax(causal):
    torch.manual_seed(0)
    block = clip.ResidualAttentionBlock(64, 4, causal=causal, compute_dtype="float32")
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.copy_(torch.randn(p.shape) * 0.1 + (name in ("ln_1.weight", "ln_2.weight")))
    x = randn(1, 2, 9, 64)
    want = clip_jax.ResidualAttentionBlock(64, 4, causal=causal, compute_dtype=jnp.float32).apply(
        {"params": _jax_params(block)}, jnp.asarray(x))
    with torch.no_grad():
        got = block(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


# --- the full towers --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def towers():
    """The port's fp32 towers from seed 0 and the JAX package's results on them."""
    model = clip.init_clip_params(0, compute_dtype="float32").eval()
    params = _jax_params(model)
    taps = {32: _images(20, 2, 32), 64: _images(21, 2, 64)}
    text_emb = randn(22, 2, 512)
    tokens = clip.tokenize(PROMPTS)

    @jax.jit
    def jax_full_towers(params, taps, tokens, text_emb):
        # The JAX package's losses call its towers at their default bf16; the
        # spy runs them at float32 and keeps the features.
        captured = {}

        def spy(p, x):
            captured["f"] = clip_jax.CLIPImageTower(compute_dtype=jnp.float32).apply(
                {"params": p["image"]}, x)
            return captured["f"]

        with mock.patch.object(clip_jax, "image_features_preprocessed", spy):
            losses = jax_multi_level(params, taps, text_emb)
        # clip_score of the 64x64 tap from the features already computed
        with mock.patch.object(clip_jax, "image_features_preprocessed",
                               lambda p, x: captured["f"][2:]):
            score = jax_clip_score(params, taps[64], text_emb)
        text = clip_jax.CLIPTextTower(compute_dtype=jnp.float32).apply(
            {"params": params["text"]}, tokens)
        return losses, captured["f"], text, score

    losses, img, txt, score = jax_full_towers(params, taps, tokens, text_emb)
    return dict(model=model, taps=taps, text_emb=text_emb, tokens=tokens,
                losses={r: float(v) for r, v in losses.items()}, img=np.asarray(img),
                txt=np.asarray(txt), score=float(score))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_full_towers_match_jax(towers):
    model = towers["model"]
    x = torch.cat([clip.preprocess_for_clip(t(towers["taps"][r])) for r in (32, 64)])
    with torch.no_grad():
        img = model.image_features_preprocessed(x).numpy()
        txt = model.text_features(towers["tokens"]).numpy()
        # float32 on both sides, other summation orders through 12 blocks
        assert _rel(img, towers["img"]) <= 1e-4 and _rel(txt, towers["txt"]) <= 1e-4
        # bf16 compute (the card's default) against the JAX float32 towers
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.bfloat16
        try:
            img16 = model.image_features_preprocessed(x).numpy()
            txt16 = model.text_features(towers["tokens"]).numpy()
        finally:
            for m in model.modules():
                if hasattr(m, "compute_dtype"):
                    m.compute_dtype = torch.float32
    print(f"bf16 cosines: image {_cos(img16, towers['img'])}, text {_cos(txt16, towers['txt'])}")
    assert _cos(img16, towers["img"]).min() >= 0.999
    assert _cos(txt16, towers["txt"]).min() >= 0.999


def test_full_tower_losses_match_jax(towers):
    taps = {r: t(x) for r, x in towers["taps"].items()}
    with torch.no_grad():
        got = multi_level_clip_loss(towers["model"], taps, t(towers["text_emb"]))
        score = clip_score(towers["model"], taps[64], t(towers["text_emb"]))
    assert set(got) == set(towers["losses"])
    for r, v in got.items():
        assert abs(float(v) - towers["losses"][r]) <= 1e-5, (r, float(v), towers["losses"][r])
    assert abs(float(score) - towers["score"]) <= 1e-5 * max(1.0, abs(towers["score"]))


# --- the tokenizer ---------------------------------------------------------------------------


@pytest.fixture
def no_merges(monkeypatch, tmp_path):
    """No merges file: the byte-level fallback in both packages (caches cleared;
    the JAX tokenizer's `transformers` route, which the port leaves out, pointed
    at an empty directory)."""
    for name in ("CLIP_BPE_PATH", "CLIP_WEIGHTS_PATH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("CLIP_TOKENIZER_PATH", str(tmp_path / "no_vocab"))
    for mod in (bpe, jax_bpe):
        mod.default_tokenizer.cache_clear()
    yield monkeypatch
    for mod in (bpe, jax_bpe):
        mod.default_tokenizer.cache_clear()


def _merges_file(path):
    """A merges file of CLIP's size (48,894 merges: a full 49,408-entry vocab) made of
    pairs of byte symbols, end-of-word pairs first."""
    chars = list(bpe.bytes_to_unicode().values())
    pairs = [(a, b + "</w>") for a in chars for b in chars][:20000]
    pairs += [(a, b) for a in chars for b in chars][:bpe.NUM_MERGES - len(pairs)]
    path.write_text("#version: test\n" + "\n".join(f"{a} {b}" for a, b in pairs) + "\n",
                    encoding="utf-8")
    return str(path)


def test_tokenize_matches_jax(no_merges, tmp_path):
    texts = PROMPTS + ["", "x" * 100]
    fallback = clip.tokenize(texts)
    np.testing.assert_array_equal(fallback, clip_jax.tokenize(texts))
    assert fallback.dtype == np.int32 and fallback[1].max() == 49407
    no_merges.setenv("CLIP_BPE_PATH", _merges_file(tmp_path / "merges.txt"))
    for mod in (bpe, jax_bpe):
        mod.default_tokenizer.cache_clear()
    assert bpe.default_tokenizer().vocab_size == clip.VOCAB_SIZE
    got = clip.tokenize(texts)
    np.testing.assert_array_equal(got, clip_jax.tokenize(texts))
    assert not np.array_equal(got, fallback)  # the BPE route was taken
    assert bpe.default_tokenizer().decode(got[0][1:got[0].argmax()]) == PROMPTS[0]


# --- the toy towers ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy():
    model = toy_clip.init_toy_params(16, seed=1)
    return model, _jax_params(model)


def test_toy_towers_and_losses_match_jax(toy):
    model, params = toy
    assert model.native_resolution == jax_toy.native_resolution(params) == 16
    taps = {8: _images(30, 3, 8), 16: _images(31, 3, 16), 32: _images(32, 3, 32)}
    text_emb = randn(33, 3, 512)
    pack = toy_clip.as_tower_pack(model)
    want = jax_multi_level({"toy": params}, taps, text_emb)
    want_score = jax_clip_score({"toy": params}, taps[32], text_emb)
    with torch.no_grad():
        got = multi_level_clip_loss(pack, {r: t(x) for r, x in taps.items()},
                                              t(text_emb))
        score = clip_score(pack, t(taps[32]), t(text_emb))
        enc = model.encode_text(PROMPTS).numpy()
        feats = model.image_features(t(taps[32])).numpy()
    for r in taps:
        assert abs(float(got[r]) - float(want[r])) <= 1e-5
    assert abs(float(score) - float(want_score)) <= 1e-5 * abs(float(want_score))
    np.testing.assert_allclose(enc, np.asarray(jax_toy.encode_text(params, PROMPTS)),
                               rtol=0, atol=1e-6)
    want_feats = np.asarray(jax_toy.image_features(params, jnp.asarray(taps[32])))
    assert _rel(feats, want_feats) <= 1e-5


def test_toy_params_round_trip_through_jax_files(toy, tmp_path):
    model, params = toy
    jax_toy.save_toy_params(str(tmp_path / "jax.npz"), params)
    loaded = toy_clip.load_toy_params(str(tmp_path / "jax.npz"))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    toy_clip.save_toy_params(str(tmp_path / "ours.npz"), model)
    back = jax_toy.load_toy_params(str(tmp_path / "ours.npz"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)

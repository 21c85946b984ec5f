"""The port's encoder and embedding service against the JAX package's, on
the same weights (the reference's ``init_params`` from a seed, carried
across by ``encoder_params_from_numpy``) and the same inputs.

Tolerances: hidden states and pooled embeddings within atol 1e-5 in
float32 (the two packages sum the same products in another order; the
hidden states are LayerNorm outputs of order 1); HF import and the hash
embedder exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from generativeaiexamples_tpu.embed import encoder as jembed
from generativeaiexamples_tpu.models import encoder as jenc
from generativeaiexamples_tpu.models import configs as jconfigs
from generativeaiexamples_tpu.models.tokenizer import \
    ByteTokenizer as JByteTokenizer
from generativeaiexamples_tpu_torch.embed import encoder as embed
from generativeaiexamples_tpu_torch.models import encoder as enc
from generativeaiexamples_tpu_torch.models.configs import (E5_LARGE_V2,
                                                           ENCODER_TINY,
                                                           EncoderConfig)
from generativeaiexamples_tpu_torch.models.safetensors import (iter_file,
                                                               save_file)
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.utils.errors import (ConfigError,
                                                         ModelLoadError)

ATOL = 1e-5
# e5-large-v2's full width, cut to 2 layers.
E5_CUT = EncoderConfig(num_layers=2)
# A tiny geometry with e5's 512 positions: both sequence buckets exist.
TINY_512 = EncoderConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                         num_layers=2, num_heads=4,
                         max_position_embeddings=512)


def _jcfg(cfg):
    return jconfigs.EncoderConfig(**cfg.__dict__)


def _shared_params(cfg, seed=0):
    """(JAX params, port params) holding the same float32 numbers."""
    jparams = jenc.init_params(_jcfg(cfg), jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, enc.encoder_params_from_numpy(tree, cfg)


def _ragged_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    mask = np.ones((B, S), np.int32)
    for b in range(1, B):
        mask[b, rng.integers(1, S):] = 0
    return tokens, mask


def test_registry_matches_the_reference():
    assert ENCODER_TINY.__dict__ == jconfigs.ENCODER_TINY.__dict__
    assert E5_LARGE_V2.__dict__ == jconfigs.E5_LARGE_V2.__dict__
    from generativeaiexamples_tpu_torch.models.configs import \
        ENCODER_REGISTRY
    assert {k: v.__dict__ for k, v in ENCODER_REGISTRY.items()} == {
        k: v.__dict__ for k, v in jconfigs.ENCODER_REGISTRY.items()}


@pytest.mark.parametrize("cfg,B,S", [(ENCODER_TINY, 3, 17),
                                     (E5_CUT, 3, 24)],
                         ids=["encoder-tiny", "e5-width-2-layers"])
def test_apply_and_pool_match_the_reference(cfg, B, S):
    """Hidden states at every position (masked ones included) and the
    pooled, normalized embeddings of a ragged batch."""
    jparams, params = _shared_params(cfg, seed=3)
    tokens, mask = _ragged_batch(cfg, B, S, seed=5)
    jh = jenc.apply(jparams, _jcfg(cfg), jnp.asarray(tokens),
                    jnp.asarray(mask))
    jpool = np.asarray(jenc.mean_pool(jh, jnp.asarray(mask)))
    h = enc.apply(params, cfg, torch.from_numpy(tokens),
                  torch.from_numpy(mask))
    pool = enc.mean_pool(h, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pool, jpool, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(pool, axis=-1), 1.0,
                               atol=1e-6)
    raw = enc.mean_pool(h, torch.from_numpy(mask), normalize=False)
    np.testing.assert_allclose(
        raw.numpy(), np.asarray(jenc.mean_pool(jh, jnp.asarray(mask),
                                               normalize=False)),
        atol=ATOL, rtol=0)


def _bert_tensors(cfg, seed=0):
    """An HF BertModel-named tensor set of ``cfg``'s geometry (float32,
    linear weights stored (out, in) as HF stores them)."""
    rng = np.random.default_rng(seed)
    D, F = cfg.hidden_size, cfg.intermediate_size

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    out = {"embeddings.word_embeddings.weight": t(cfg.vocab_size, D),
           "embeddings.position_embeddings.weight":
               t(cfg.max_position_embeddings, D),
           "embeddings.token_type_embeddings.weight":
               t(cfg.type_vocab_size, D),
           "embeddings.LayerNorm.weight": t(D),
           "embeddings.LayerNorm.bias": t(D),
           "pooler.dense.weight": t(D, D)}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            out[p + name + ".weight"] = t(D, D)
            out[p + name + ".bias"] = t(D)
        out[p + "intermediate.dense.weight"] = t(F, D)
        out[p + "intermediate.dense.bias"] = t(F)
        out[p + "output.dense.weight"] = t(D, F)
        out[p + "output.dense.bias"] = t(D)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            out[p + ln + ".weight"] = t(D)
            out[p + ln + ".bias"] = t(D)
    return out


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_hf_import_matches_the_reference(tmp_path, prefix):
    """A BERT-named set written with the port's safetensors writer loads
    to the tree the reference's ``params_from_named_tensors`` builds, with
    and without the ``bert.`` prefix; a missing tensor is refused."""
    tensors = {prefix + k: v for k, v in _bert_tensors(ENCODER_TINY).items()}
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path)
    ours = enc.params_from_named_tensors(iter_file(path), ENCODER_TINY)
    theirs = jenc.params_from_named_tensors(
        ((k, v.numpy()) for k, v in tensors.items()),
        _jcfg(ENCODER_TINY))
    for group in ("embed", "layers"):
        assert set(ours[group]) == set(theirs[group])
        for name, leaf in theirs[group].items():
            np.testing.assert_array_equal(ours[group][name].numpy(),
                                          np.asarray(leaf), err_msg=name)
    missing = dict(tensors)
    missing.pop(prefix + "encoder.layer.1.output.dense.bias")
    with pytest.raises(ModelLoadError):
        enc.params_from_named_tensors(iter(missing.items()), ENCODER_TINY)


def _services(cfg):
    jparams, params = _shared_params(cfg, seed=0)
    return (jembed.EmbeddingService(jparams, _jcfg(cfg), JByteTokenizer()),
            embed.EmbeddingService(params, cfg, ByteTokenizer()))


TEXTS = ["The paged KV pool holds each request's keys and values.",
         "Retrieval ranks chunks by inner product.",
         "x", "Une phrase en français, avec des accents: é à ü."]


def test_embedding_service_matches_the_reference():
    """Passage mode, query mode and batched query mode give the
    reference's vectors for the same texts; 40 texts span two batch
    chunks (32 + 8)."""
    ref, ours = _services(ENCODER_TINY)
    np.testing.assert_allclose(ours.embed_documents(TEXTS),
                               ref.embed_documents(TEXTS), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours.embed_query(TEXTS[0]),
                               ref.embed_query(TEXTS[0]), atol=ATOL, rtol=0)
    many = [f"{t} #{i}" for i in range(10) for t in TEXTS]
    np.testing.assert_allclose(ours.embed_queries(many),
                               ref.embed_queries(many), atol=ATOL, rtol=0)
    assert ours.dim == ref.dim == ENCODER_TINY.hidden_size
    assert (ours.seq_buckets, ours.batch_buckets) == (ref.seq_buckets,
                                                      ref.batch_buckets)


def test_padding_invariance_across_buckets():
    """A text embedded alone (bucket 1 x 128) equals the same text inside
    a batch that takes the 8 x 512 buckets (a 300-token neighbour)."""
    ref, ours = _services(TINY_512)
    assert ours.seq_buckets == (128, 512)
    alone = ours.embed_documents(["hello world"])[0]
    batch = ["hello world", "y" * 300, "zz"]
    assert ours.pack(batch).shape == (2, 8, 512)
    together = ours.embed_documents(batch)
    np.testing.assert_allclose(alone, together[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(together, ref.embed_documents(batch),
                               atol=ATOL, rtol=0)


def test_hash_embedder_is_bit_equal():
    ours, ref = embed.HashEmbedder(dim=128), jembed.HashEmbedder(dim=128)
    np.testing.assert_array_equal(ours.embed_documents(TEXTS),
                                  ref.embed_documents(TEXTS))
    np.testing.assert_array_equal(ours.embed_queries(TEXTS),
                                  ref.embed_queries(TEXTS))
    a = ours.embed_query("retrieval augmented generation")
    b = ours.embed_query("retrieval augmented generation!")
    c = ours.embed_query("completely different topic")
    assert a @ b > a @ c


def test_get_embedder_engines_and_refusals():
    svc = embed.get_embedder("torch-cuda", "encoder-tiny", device="cpu")
    assert svc.device.type == "cpu" and svc.dim == ENCODER_TINY.hidden_size
    vecs = svc.embed_documents(["a", "b"])
    assert vecs.shape == (2, 64) and np.isfinite(vecs).all()
    assert isinstance(embed.get_embedder("hash", dim=32), embed.HashEmbedder)
    with pytest.raises(ConfigError, match="torch-cuda"):
        embed.get_embedder("tpu-jax", "encoder-tiny", device="cpu")
    with pytest.raises(ConfigError, match="unknown encoder"):
        embed.get_embedder("torch-cuda", "bert-huge", device="cpu")
    with pytest.raises(ValueError):
        embed.get_embedder("nope")


def test_get_embedder_loads_a_checkpoint_directory(tmp_path):
    """An e5-named checkpoint directory (safetensors + tokenizer.json)
    loads through the port's reader; its vectors equal the reference
    service's on the same tree."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    tok = Tokenizer(models.WordLevel(
        {"[UNK]": 0, "query": 1, ":": 2, "passage": 3, "hello": 4},
        unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    tensors = _bert_tensors(ENCODER_TINY, seed=2)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    with pytest.MonkeyPatch.context() as mp:
        from generativeaiexamples_tpu_torch.models import configs
        mp.setitem(configs.ENCODER_REGISTRY, "e5-large-v2", ENCODER_TINY)
        svc = embed.get_embedder("torch-cuda", "e5-large-v2",
                                 checkpoint_path=str(tmp_path), device="cpu")
    ref = jembed.EmbeddingService(
        jenc.params_from_named_tensors(
            ((k, v.numpy()) for k, v in tensors.items()),
            _jcfg(ENCODER_TINY)), _jcfg(ENCODER_TINY), svc.tokenizer)
    np.testing.assert_allclose(svc.embed_query("hello"),
                               ref.embed_query("hello"), atol=ATOL, rtol=0)

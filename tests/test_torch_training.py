"""The port's training step (``training.py``) and golden-checkpoint tool
against the JAX package, on the CPU.

One numpy tree drawn by the JAX package's ``init_params`` (float32)
drives both packages. Tolerances: the loss function rtol 1e-6 (the same
float32 log-softmax on both sides); per-step losses over 8 optimizer
steps and the first step's gradients rtol 1e-4 (float32 forward and
backward, two layers of summation-order noise). Parameters are not
compared elementwise after many steps (Adam's first step maps a
near-zero gradient to +-lr)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativeaiexamples_tpu import training as jtraining
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch import training as ttraining
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.models.configs import (LLAMA_TINY,
                                                           LlamaConfig)
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

CFG = LLAMA_TINY
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS_DIR = os.path.join(REPO, "docs")
GOLDEN_TOKENIZER = os.path.join(REPO, "tests", "fixtures", "golden_tiny",
                                "tokenizer.model")
STEPS = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("masked", [0, 5, 64])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(masked)
    logits = (3 * rng.standard_normal((2, 32, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask.reshape(-1)[:masked] = 0
    want = float(jtraining.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask)))
    got = ttraining.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(targets),
                                       torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_cross_entropy_of_bf16_logits_sums_in_float32():
    logits = torch.randn(2, 8, 40).to(torch.bfloat16)
    targets = torch.randint(0, 40, (2, 8))
    mask = torch.ones(2, 8)
    got = ttraining.cross_entropy_loss(logits, targets, mask)
    want = ttraining.cross_entropy_loss(logits.float(), targets, mask)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _sft_batch(seed, B=4, S=24, prompt=9):
    """A batch with the first ``prompt`` positions out of the loss and a
    right-padded tail: ``length`` counts every real token."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, CFG.vocab_size, (B, S + 1)).astype(np.int32)
    length = np.array([S, S - 3, S - 7, S - 1][:B], np.int32)
    mask = np.zeros((B, S), np.int32)
    for b, n in enumerate(length):
        mask[b, prompt:n] = 1
        toks[b, n + 1:] = 0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask,
            "length": length}


@pytest.mark.parametrize("kind", ["lm", "sft"])
def test_sft_steps_match_optax_adamw(kind):
    """8 AdamW(3e-3) steps of the whole tree: torch's AdamW with optax's
    weight decay (1e-4) against ``optax.adamw``; per-step losses and the
    first step's gradients of every leaf equal the reference's."""
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    jp = jllama.init_params(JCFG, jax.random.key(0), dtype=jnp.float32)
    batch = _sft_batch(1)
    if kind == "lm":
        batch = {"tokens": batch["tokens"], "targets": batch["targets"],
                 "mask": np.ones_like(batch["mask"])}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = optax.adamw(3e-3)
    state = opt.init(jp)
    step = jax.jit(jtraining.make_train_step(JCFG, opt))

    def jloss(params):
        B, S = jb["tokens"].shape
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        length = jb.get("length", jnp.sum(jb["mask"], -1))
        logits, _ = jllama.apply(params, JCFG, jb["tokens"], pos,
                                 kv_valid_len=length)
        return jtraining.cross_entropy_loss(logits, jb["targets"],
                                            jb["mask"])
    jgrads = _np(jax.grad(jloss)(jp))

    tp = params_from_numpy(_np(jp), "cpu", torch.float32, cfg=CFG)
    optim = torch.optim.AdamW(ttraining.trainable(tp), lr=3e-3,
                              weight_decay=1e-4)
    tstep = ttraining.make_train_step(CFG, optim)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlosses, tlosses = [], []
    for i in range(STEPS):
        jp, state, loss = step(jp, state, jb)
        jlosses.append(float(loss))
        tlosses.append(float(tstep(tp, tb)))
        if i == 0:
            flat = {k: v for k, v in tp.items() if k != "layers"}
            flat.update(tp["layers"])
            jflat = {k: v for k, v in jgrads.items() if k != "layers"}
            jflat.update(jgrads["layers"])
            assert set(flat) == set(jflat)
            for k, t in flat.items():
                np.testing.assert_allclose(
                    t.grad.numpy(), jflat[k], rtol=1e-4,
                    atol=1e-4 * np.abs(jflat[k]).max())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]


def test_trainable_leaves_out_quantized_leaves():
    from generativeaiexamples_tpu_torch.ops.quant import quantize_params
    p = quantize_params(tllama.init_params(CFG, 0, dtype=torch.float32),
                        "int8")
    leaves = ttraining.trainable(p)
    assert len(leaves) == 4      # embed, final_norm, attn/mlp norms
    assert all(t.requires_grad and t.is_floating_point() for t in leaves)
    assert not p["layers"]["wq"]["scale"].requires_grad


def test_a_mesh_is_refused():
    with pytest.raises(ConfigError, match="A12"):
        ttraining.make_train_step(CFG, None, mesh=object())


# ------------------------------------------------------------ notebook 10

NB_CFG = LlamaConfig(vocab_size=264, hidden_size=64, intermediate_size=128,
                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                     max_position_embeddings=128)
PAIRS = [("What is the MXU?", "A systolic array."),
         ("What links chips?", "ICI links.")]


def _greedy(params, tok, prompt, n=20):
    ids = tok.encode(prompt)
    start = len(ids)
    with torch.no_grad():
        for _ in range(n):
            t = torch.tensor([ids])
            pos = torch.arange(len(ids), dtype=torch.int32)[None]
            logits, _ = tllama.apply(params, NB_CFG, t, pos)
            nxt = int(logits[0, -1].argmax())
            if nxt == tok.eos_id:
                break
            ids.append(nxt)
    return tok.decode(ids[start:])


def test_notebook_10_end_to_end(tmp_path):
    """Notebook 10 through the port: full-parameter SFT with the prompt
    masked out of the loss and ``length`` passed, AdamW 3e-3 for 40
    steps; the loss halves, greedy decoding answers "systolic", and a
    saved-and-reloaded checkpoint gives the same answer."""
    from generativeaiexamples_tpu_torch.models.safetensors import (load_file,
                                                                   save_file)
    tok = ByteTokenizer()
    S = 64

    def encode_pair(instr, resp):
        prompt = tok.encode(f"[INST] {instr} [/INST] ")
        response = tok.encode(resp, add_bos=False) + [tok.eos_id]
        ids = (prompt + response)[:S + 1]
        mask = [0] * len(prompt) + [1] * len(response)
        pad = S + 1 - len(ids)
        return ids + [0] * pad, (mask + [0] * pad)[:S + 1], len(ids)

    rows = [encode_pair(i, r) for i, r in PAIRS]
    batch = {"tokens": torch.tensor([r[0][:-1] for r in rows]),
             "targets": torch.tensor([r[0][1:] for r in rows]),
             "mask": torch.tensor([r[1][1:] for r in rows]),
             "length": torch.tensor([r[2] - 1 for r in rows])}
    params = tllama.init_params(NB_CFG, 0, dtype=torch.float32)
    optim = torch.optim.AdamW(ttraining.trainable(params), lr=3e-3,
                              weight_decay=1e-4)
    step = ttraining.make_train_step(NB_CFG, optim)
    losses = [float(step(params, batch)) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.5, losses
    out = _greedy(params, tok, "[INST] What is the MXU? [/INST] ")
    assert "systolic" in out.lower(), out

    flat = {k: v for k, v in params.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in params["layers"].items()})
    path = str(tmp_path / "sft.safetensors")
    save_file({k: v.detach() for k, v in flat.items()}, path)
    loaded = load_file(path)
    restored = {k: loaded[k] for k in flat if not k.startswith("layers.")}
    restored["layers"] = {k[len("layers."):]: v for k, v in loaded.items()
                          if k.startswith("layers.")}
    assert _greedy(restored, tok, "[INST] What is the MXU? [/INST] ") == out


# ---------------------------------------------------------- golden tool

def test_golden_tool_trains_exports_and_round_trips(tmp_path):
    """The golden tool at a few steps: the loss falls, the export loads
    back through ``import_hf`` bit-equal to the fp16 cast of the trained
    tree, and its directory carries config.json and the tokenizer."""
    from generativeaiexamples_tpu_torch.models.configs import (
        GOLDEN_TINY, config_for_checkpoint)
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint
    from generativeaiexamples_tpu_torch.tools import make_golden_checkpoint \
        as golden
    params, losses = golden.train(DOCS_DIR, GOLDEN_TOKENIZER, steps=6,
                                  batch=4, seq=32, device="cpu",
                                  log=lambda *_: None)
    assert losses[-1] < losses[0], losses
    out = str(tmp_path / "golden")
    golden.export_hf(params, GOLDEN_TINY, out, GOLDEN_TOKENIZER)
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors",
                                       "tokenizer.model"]
    cfg = config_for_checkpoint(out, GOLDEN_TINY)
    assert cfg == GOLDEN_TINY
    back = load_checkpoint(out, cfg, dtype=torch.float16, device="cpu")
    for a, b in zip(tllama.param_tensors(back),
                    tllama.param_tensors(params)):
        assert torch.equal(a, b.to(torch.float16))
    assert not any(t.requires_grad for t in tllama.param_tensors(params))


def test_golden_tool_cli_writes_only_where_asked(tmp_path):
    from generativeaiexamples_tpu_torch.tools import make_golden_checkpoint \
        as golden
    out = str(tmp_path / "g")
    assert golden.main(["--corpus", DOCS_DIR, "--tokenizer",
                        GOLDEN_TOKENIZER, "--steps", "1", "--batch", "2",
                        "--seq", "16", "--device", "cpu", "--out",
                        out]) == 0
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors",
                                       "tokenizer.model"]
    # The corpus and the tokenizer are the caller's to name.
    for missing in (["--corpus", DOCS_DIR], ["--tokenizer",
                                             GOLDEN_TOKENIZER]):
        with pytest.raises(SystemExit):
            golden.main(missing + ["--steps", "1", "--device", "cpu",
                                   "--out", out])

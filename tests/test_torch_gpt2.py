"""ray_tpu_torch.models.gpt2 against ray_tpu.models.gpt2, on the CPU.

The JAX package's weights are carried across with ``load_flax_params`` and
both forwards run on the same seeded token ids, fp32, to 1e-4 on the logits
(12 stacked fp32 products and norms in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2

TOL = 1e-4


@pytest.fixture(scope="module")
def carried():
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.PRNGKey(3)))
    tcfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    model = tgpt2.load_flax_params(tgpt2.GPT2(tcfg, device="cpu"), params)
    return jcfg, params, tcfg, model


def test_logits_match_flax_forward(carried):
    jcfg, params, tcfg, model = carried
    idx = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 16))
    ref = np.asarray(jgpt2.forward(jcfg, jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(idx, dtype=jnp.int32)))
    with torch.inference_mode():
        got = tgpt2.forward(tcfg, model, torch.from_numpy(idx))
    assert got.shape == (2, 16, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_loss_matches_flax_loss(carried):
    jcfg, params, tcfg, model = carried
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 8, tcfg.vocab_size)).astype(np.float32)
    targets = rng.integers(0, tcfg.vocab_size, (2, 8))
    ref = float(jgpt2.loss_fn(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(tgpt2.loss_fn(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert abs(got - ref) < 1e-5


def test_param_count_matches_flax(carried):
    _, params, _, model = carried
    assert tgpt2.num_params(model) == jgpt2.num_params(params)


@pytest.mark.parametrize("change", ["missing", "unknown", "shape"])
def test_load_flax_params_rejects_trees_that_do_not_fit(carried, change):
    _, params, tcfg, _ = carried
    bad = jax.tree.map(np.copy, params)
    if change == "missing":
        del bad["h_1"]["mlp"]["c_fc"]["bias"]
    elif change == "unknown":
        bad["h_0"]["attn"]["rotary"] = {"kernel": np.zeros((2, 2), np.float32)}
    else:
        bad["wpe"]["embedding"] = bad["wpe"]["embedding"][:-1]
    with pytest.raises(ValueError):
        tgpt2.load_flax_params(tgpt2.GPT2(tcfg, device="cpu"), bad)


def test_init_params_uses_flax_initialisers():
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    model = tgpt2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    e = cfg.n_embd
    assert abs(model.wte.weight.std().item() - e ** -0.5) < 0.05 * e ** -0.5
    w = model.h[0].attn.c_attn.weight                   # (out, in)
    std = w.shape[1] ** -0.5
    assert abs(w.std().item() - std) < 0.05 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.all(model.h[0].ln_1.weight == 1) and torch.all(model.ln_f.bias == 0)
    assert torch.all(model.h[1].mlp.c_fc.bias == 0)
    again = tgpt2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    other = tgpt2.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(again.wte.weight, model.wte.weight)
    assert not torch.equal(other.wte.weight, model.wte.weight)


def test_layer_norm_and_names_follow_flax():
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=torch.float32), device="cpu")
    assert model.h[0].ln_1.eps == 1e-6 and model.ln_f.eps == 1e-6
    names = {n for n, _ in model.named_parameters()}
    assert {"wte.weight", "wpe.weight", "h.0.ln_1.weight", "h.1.attn.c_attn.weight",
            "h.0.attn.c_proj.bias", "h.1.mlp.c_fc.weight", "h.0.mlp.c_proj.weight",
            "ln_f.bias"} <= names


@pytest.mark.parametrize("entry", ["GPT2", "init_params", "build_adapter", "engine"])
def test_default_device_without_cuda_raises(monkeypatch, entry):
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "GPT2":
            tgpt2.GPT2(cfg)
        elif entry == "init_params":
            tgpt2.init_params(cfg)
        elif entry == "build_adapter":
            build_adapter("gpt2-tiny")
        else:
            LLMEngine(build_adapter("fake"))

"""ray_tpu_torch.models.gpt2 against ray_tpu.models.gpt2, on the CPU.

The JAX package's weights are carried across with ``load_flax_params`` and
both forwards run on the same seeded token ids, fp32, to 1e-4 on the logits
(12 stacked fp32 products and norms in another summation order). Under a
bf16 config both keep fp32 parameters and return bf16 logits; those agree
to BF16_LOGIT_TOL, which is set by rounding order: each framework rounds
its bf16 products, norms and gelu at other places, and on this model that
alone gives up to about 0.04 at |logit| <= 4.2.

Also the configs a JAX user passes: ``use_flash_attention`` off (the
einsum path) and ``GPT2Config(n_head=16)``, whose head dim 48 the flash
kernels compute padded to 64; a training step's gradients are held to
flax's to TOL, with the kernels' plain versions standing in for the
kernels on the padded tensors they would get on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.parallel.train_step import TrainStep

TOL = 1e-4
BF16_LOGIT_TOL = 0.05


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


def test_bf16_config_keeps_fp32_params_and_gives_bf16_logits_like_flax():
    jcfg = jgpt2.GPT2Config.tiny()                        # bf16, as by default
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jgpt2.init_params(jcfg, key))(jax.random.PRNGKey(3)))
    tcfg = tgpt2.GPT2Config.tiny()
    assert tcfg.dtype == torch.bfloat16
    model = tgpt2.load_flax_params(tgpt2.GPT2(tcfg, device="cpu"), params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.asarray(x).dtype == np.float32 for x in jax.tree.leaves(params))
    idx = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 16))
    ref = jax.jit(lambda p, i: jgpt2.forward(jcfg, p, i))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(idx, dtype=jnp.int32))
    with torch.inference_mode():
        got = model(torch.from_numpy(idx))
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err <= BF16_LOGIT_TOL, err


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


@pytest.mark.parametrize("flash", [True, False])
def test_sixteen_heads_train_a_step_with_flax_gradients(monkeypatch, flash):
    """GPT2Config(n_head=16) at width 768 (head dim 48), one layer: the
    step's gradients equal flax's. With flash on, attention dispatches as on
    the card, to the kernels at head dim 64 (their plain versions stand in
    on the CPU); with it off, it takes the einsum path at head dim 48."""
    calls = []
    if flash:
        monkeypatch.setattr(tattn, "_device_of", lambda q: "cuda")
        monkeypatch.setattr(tattn, "_kernel_fwd", lambda q, k, v: (
            calls.append(q.shape), tattn.plain_causal_attention_fwd(q, k, v))[1])
        monkeypatch.setattr(tattn, "_kernel_bwd", lambda q, k, v, o, lse, do: (
            calls.append(q.shape),
            tattn.plain_causal_attention_bwd(q, k, v, o, lse, do))[1])
    else:
        plain = tattn.plain_causal_attention
        monkeypatch.setattr(tattn, "plain_causal_attention",
                            lambda *a: calls.append(a[0].shape) or plain(*a))
    kw = dict(n_head=16, n_layer=1, vocab_size=96, block_size=32)
    jcfg = jgpt2.GPT2Config(dtype=jnp.float32, use_flash_attention=flash, **kw)
    tcfg = tgpt2.GPT2Config(dtype=torch.float32, use_flash_attention=flash, **kw)
    assert tcfg.n_embd // tcfg.n_head == 48 and not tcfg.dropout
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jgpt2.init_params(jcfg, key))(jax.random.PRNGKey(5)))
    idx = np.random.default_rng(5).integers(0, 96, (2, 16))
    targets = np.roll(idx, -1, axis=1)

    def loss_of(p):
        return jgpt2.loss_fn(jgpt2.forward(jcfg, p, jnp.asarray(idx)),
                             jnp.asarray(targets))

    ref = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_of))(
        jax.tree.map(jnp.asarray, params)))
    ts = TrainStep(tcfg, device="cpu", telemetry=False)
    state = ts.init()
    tgpt2.load_flax_params(state["params"], params)
    batch = ts.shard_batch({"idx": idx, "targets": targets})
    loss, grads = ts.loss_and_grads(state, batch)
    want = tgpt2._flax_tensors(state["params"], ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=TOL,
                                   rtol=0, err_msg=name)
    state, m = ts.step(state, batch)
    assert np.isfinite(m["loss"].item()) and m["loss"].item() == loss.item()
    # the forwards, their remat recomputes and the backwards
    assert calls and all(c == (2, 16, 16, 64 if flash else 48) for c in calls)

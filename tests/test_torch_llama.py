"""ray_tpu_torch.models.llama against ray_tpu.models.llama, on the CPU.

A tiny Llama with 4 query heads and 2 KV heads (so GQA really repeats),
weights carried across from the JAX package with ``load_flax_params``,
token ids from a numpy seed. Tolerances:
  - fp32 logits and gradients to 1e-4 absolute: two stacked fp32 blocks
    and the fp32 head, only the summation order differs (|logit| < 4);
  - bf16 compute: the fp32 head's logits to BF16_LOGIT_TOL, set by rounding
    order: each framework rounds its bf16 products, norms and SwiGLU at
    other places;
  - RoPE in fp32 to 1e-6 (elementwise, one cos/sin evaluation apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl

TOL = 1e-4
ROPE_TOL = 1e-6
BF16_LOGIT_TOL = 0.05
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU ops: one thread is fastest and steady, where eight threads
    on cores shared with other test workers stall on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def carried():
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jl.init_params(JCFG, key))(jax.random.PRNGKey(3)))
    model = tl.load_flax_params(tl.Llama(TCFG, device="cpu"), params)
    return params, model


def _idx(seed=0, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, TCFG.vocab_size, shape)


def test_config_widths_match_jax():
    for name in ("tiny", "llama_160m"):
        j, t = getattr(jl.LlamaConfig, name)(), getattr(tl.LlamaConfig, name)()
        for f in ("vocab_size", "block_size", "n_layer", "n_head", "n_kv_head",
                  "n_embd", "head_dim", "mlp_dim", "rope_theta", "rms_eps"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    assert tl.LlamaConfig.llama_160m().mlp_dim == 2048
    assert tl.LlamaConfig.tiny(intermediate=200).mlp_dim == 200


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("pos_offset", [0, 5])
def test_logits_match_flax_forward(carried, flash, pos_offset):
    params, _ = carried
    cfg = dataclasses.replace(TCFG, use_flash_attention=flash)
    model = tl.load_flax_params(tl.Llama(cfg, device="cpu"), params)
    idx = _idx()
    ref = np.asarray(jax.jit(lambda p, i: jl.forward(JCFG, p, i, pos_offset))(
        params, jnp.asarray(idx, jnp.int32)))
    with torch.inference_mode():
        got = tl.forward(model.config, model, torch.from_numpy(idx), pos_offset)
    assert got.shape == (2, 16, TCFG.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_bf16_config_keeps_fp32_params_and_an_fp32_head_like_flax():
    jcfg = jl.LlamaConfig.tiny()                      # bf16, as by default
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jl.init_params(jcfg, key))(jax.random.PRNGKey(3)))
    tcfg = tl.LlamaConfig.tiny()
    assert tcfg.dtype == torch.bfloat16
    model = tl.load_flax_params(tl.Llama(tcfg, device="cpu"), params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    idx = _idx(1)
    ref = jax.jit(lambda p, i: jl.forward(jcfg, p, i))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(idx, jnp.int32))
    with torch.inference_mode():
        got = model(torch.from_numpy(idx))
    # the untied head computes in fp32 under a bf16 config, on both sides
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    assert err < BF16_LOGIT_TOL, err


def test_rope_matches_jax_and_is_relative():
    rng = np.random.default_rng(0)
    D = 16
    x = rng.standard_normal((2, 6, 3, D)).astype(np.float32)
    pos = np.arange(6) + 7
    jang = jl.rope_angles(D, 1e4, jnp.asarray(pos))
    tang = tl.rope_angles(D, 1e4, torch.from_numpy(pos))
    np.testing.assert_allclose(tang.numpy(), np.asarray(jang), atol=ROPE_TOL, rtol=0)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jang))
    got = tl.apply_rope(torch.from_numpy(x), tang).numpy()
    np.testing.assert_allclose(got, want, atol=ROPE_TOL, rtol=0)
    # relative position: q.k after rotation depends only on the distance,
    # and rotation keeps the norm (tests/test_llama.py's properties)
    q, k = torch.from_numpy(x[:1, :4, :1]), torch.from_numpy(x[1:, :4, :1])
    dots = [torch.einsum("bthd,bshd->ts", tl.apply_rope(q, a), tl.apply_rope(k, a))
            for a in (tl.rope_angles(D, 1e4, torch.arange(4)),
                      tl.rope_angles(D, 1e4, torch.arange(4) + 5))]
    torch.testing.assert_close(dots[0], dots[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tl.apply_rope(q, tl.rope_angles(D, 1e4, torch.arange(4))).norm(),
                               q.norm(), rtol=1e-5, atol=0)
    # pos_offset: the shifted angles are the tail of the full table, exactly
    full = tl.rope_angles(8, 1e4, torch.arange(16))
    assert torch.equal(full[8:], tl.rope_angles(8, 1e4, torch.arange(8) + 8))


def test_rms_norm_rounds_like_flax_in_bf16():
    # the statistic in fp32, the normalised input cast to bf16, then the
    # multiply by the bf16 weight: the same roundings in the same places
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16), 1e-5), np.float32)
    got = tl.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                      1e-5)
    assert got.dtype == torch.bfloat16
    # at most one bf16 ulp apart (rsqrt may round differently)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=0)


def test_gqa_equals_mha_with_repeated_kv_heads(carried):
    """Head h of the GQA model reads KV head h // rep: an MHA model whose
    k/v projections repeat each KV head's columns rep times in a row gives
    the same logits. A tiling (head h reading h % n_kv_head) would not."""
    params, gqa = carried
    mha_cfg = dataclasses.replace(TCFG, n_kv_head=TCFG.n_head)
    mha = tl.Llama(mha_cfg, device="cpu")
    rep, hd = TCFG.n_head // TCFG.n_kv_head, TCFG.head_dim
    with torch.no_grad():
        for name, p in mha.named_parameters():
            src = dict(gqa.named_parameters())[name]
            if name.endswith(("attn.wk.weight", "attn.wv.weight")):
                src = src.unflatten(0, (TCFG.n_kv_head, hd)).repeat_interleave(
                    rep, dim=0).flatten(0, 1)
            p.copy_(src)
    idx = torch.from_numpy(_idx(2))
    with torch.inference_mode():
        torch.testing.assert_close(mha(idx), gqa(idx), rtol=0, atol=TOL)
    assert tl.num_params(mha) > tl.num_params(gqa)


def test_gradients_match_jax_grad(carried):
    params, model = carried
    idx = _idx(4, (2, 12))
    tgt = np.roll(idx, -1, axis=1)

    def jloss(p):
        return jl.loss_fn(jl.forward(JCFG, p, jnp.asarray(idx, jnp.int32)),
                          jnp.asarray(tgt, jnp.int32))

    jgrads = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, params))
    names, ps = zip(*model.named_parameters())
    loss = tl.loss_fn(model(torch.from_numpy(idx)), torch.from_numpy(tgt))
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    np.testing.assert_allclose(loss.item(), float(jloss(params)), rtol=1e-5)
    want = tl._flax.flax_tensors(model, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=TOL, rtol=0,
                                   err_msg=name)


def test_init_matches_flax_initialiser_scales():
    jparams = jax.tree.map(np.asarray, jax.jit(
        lambda key: jl.init_params(JCFG, key))(jax.random.PRNGKey(0)))
    model = tl.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    want = {n: float(t.std()) for n, t in tl._flax.flax_tensors(model, jparams).items()}
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert p.std().item() == pytest.approx(want[name], rel=0.1), name


def test_loader_rejects_a_tree_that_does_not_fit(carried):
    params, _ = carried
    model = tl.Llama(TCFG, device="cpu")
    bad = dict(params)
    bad["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unknown"):
        tl.load_flax_params(model, bad)
    bad = {k: v for k, v in params.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing"):
        tl.load_flax_params(model, bad)

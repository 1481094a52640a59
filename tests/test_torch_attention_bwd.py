"""The port's attention backward against the JAX package's, on the CPU.

``plain_causal_attention_bwd`` is the plain PyTorch version of the two
hand-written CUDA backward kernels (``csrc/flash_attn_bwd.cu``); here it is
held against the JAX package's Pallas backward (``_flash_bwd``) in
interpret mode and against ``jax.grad`` through the interpret-mode flash
kernel, on the same seeded numpy inputs, fp32, to 1e-5 (summation order
only). Ragged lengths are held against torch autograd of the plain
attention. The kernels themselves run on the card only and are held
against this plain version by ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU ops: one thread is fastest and steady, where eight threads
    on cores shared with other test workers stall on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape,block_q,block_k", [
    ((1, 2, 128, 32), 64, 32),
    ((1, 2, 64, 64), None, None),
])
def test_plain_bwd_matches_pallas_interpret(shape, block_q, block_k):
    q, k, v, do = _inputs(shape)
    b, h, t, d = shape
    bq = block_q or jattn._pick_block(t)
    bk = block_k or jattn._pick_block(t)
    flat = [jnp.asarray(x.reshape(b * h, t, d)) for x in (q, k, v, do)]
    o, lse = jattn._flash_fwd(*flat[:3], block_q=bq, block_k=bk, interpret=True)
    refs = jattn._flash_bwd((*flat[:3], o, lse), flat[3], block_q=bq,
                            block_k=bk, interpret=True)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to = torch.from_numpy(np.asarray(o).reshape(shape))
    tlse = torch.from_numpy(np.asarray(lse).reshape(b, h, t))
    got = tattn.flash_causal_attention_bwd(tq, tk, tv, to, tlse, tdo)
    for name, g, ref in zip(("dq", "dk", "dv"), got, refs):
        assert g.shape == shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(ref).reshape(shape),
                                   atol=TOL, rtol=0, err_msg=name)


def test_autograd_matches_jax_grad_through_the_interpret_kernel():
    shape = (1, 2, 128, 32)
    q, k, v, do = _inputs(shape, seed=1)

    def jloss(q, k, v):
        o = jattn.flash_causal_attention(q, k, v, block_q=64, block_k=32,
                                         interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    refs = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tattn.flash_causal_attention(tq, tk, tv)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, ref in zip(("dq", "dk", "dv"), got, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("t", [1, 7, 33])
def test_ragged_lengths_match_autograd_of_plain_attention(t):
    shape = (2, t, 3, 32)                           # (B, T, H, D)
    q, k, v, do = _inputs(shape, seed=10 + t)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tattn.causal_attention(*leaves), leaves,
                              torch.from_numpy(do))
    leaves = [torch.from_numpy(x).transpose(1, 2).requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(tattn.plain_causal_attention(*leaves), leaves,
                              torch.from_numpy(do).transpose(1, 2))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), r.transpose(1, 2).numpy(),
                                   atol=TOL, rtol=0, err_msg=name)


def test_cpu_backward_never_counts_as_launches():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((1, 2, 16, 32)))
    before = (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_BWD_DQ_LAUNCHES,
              tattn.FLASH_BWD_DKV_LAUNCHES)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(tattn.flash_causal_attention(*leaves), leaves, do)
    o, lse = tattn.flash_causal_attention_fwd(q, k, v)
    tattn.flash_causal_attention_bwd(q, k, v, o, lse, do)
    assert (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_BWD_DQ_LAUNCHES,
            tattn.FLASH_BWD_DKV_LAUNCHES) == before


def test_nothing_is_saved_without_grad():
    q = torch.zeros((1, 2, 8, 32), requires_grad=True)
    with torch.inference_mode():
        assert tattn.flash_causal_attention(q, q, q).grad_fn is None
    with torch.no_grad():
        assert tattn.flash_causal_attention(q, q, q).grad_fn is None
    assert tattn.flash_causal_attention(q, q, q).grad_fn is not None


@pytest.mark.parametrize("case", [
    "float16", "head_dim_48", "do_not_contiguous", "o_shape", "lse_dtype",
    "lse_shape", "delta_shape", "do_misaligned",
])
def test_bwd_wrapper_rejects_what_the_kernels_do_not_take(case):
    q = torch.zeros((1, 2, 8, 64))
    k = v = o = do = q
    lse = torch.zeros((1, 2, 8))
    delta = None
    exc = ValueError
    if case == "float16":
        q = k = v = o = do = q.half()
        exc = TypeError
    elif case == "head_dim_48":
        q = k = v = o = do = torch.zeros((1, 2, 8, 48))
    elif case == "do_not_contiguous":
        do = torch.zeros((1, 8, 2, 64)).transpose(1, 2)
    elif case == "o_shape":
        o = torch.zeros((1, 2, 9, 64))
    elif case == "lse_dtype":
        lse = lse.double()
    elif case == "lse_shape":
        lse = torch.zeros((1, 2, 8, 1))
    elif case == "delta_shape":
        delta = torch.zeros((1, 2, 9))
    elif case == "do_misaligned":   # contiguous, 4 bytes past a 16-byte boundary
        do = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(exc):
        tattn._check_bwd_inputs(q, k, v, do, lse, delta, o=o)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 1, 4, 32), device="meta")
    lse = torch.empty((1, 1, 4), device="meta")
    with pytest.raises(ValueError, match="no causal attention"):
        tattn.flash_causal_attention_bwd(q, q, q, q, lse, q)


def _sm90_rounding(q, k, v, do):
    """The bf16 tensor-core kernels' arithmetic on the CPU, in fp32 on
    bf16-valued inputs (B, H, T, D): scores and sums in fp32, the scale
    applied to the scores, p (forward and dk/dv) and ds (dq and dk) rounded
    to bf16 before the second products, outputs rounded to bf16. Returns o,
    lse, dq, dk, dv."""
    d, t = q.shape[-1], q.shape[-2]
    scale = 1.0 / math.sqrt(d)
    bf16 = lambda x: x.to(torch.bfloat16).float()
    s = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), tattn.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = bf16(torch.einsum("bhts,bhsd->bhtd", bf16(p), v) / l)
    lse = (m + torch.log(l)).squeeze(-1)
    delta = (o * do).sum(dim=-1, keepdim=True)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.einsum("bhtd,bhsd->bhts", do, v) - delta)
    dq = bf16(torch.einsum("bhts,bhsd->bhtd", bf16(ds), k) * scale)
    dv = bf16(torch.einsum("bhts,bhtd->bhsd", bf16(p), do))
    dk = bf16(torch.einsum("bhts,bhtd->bhsd", bf16(ds), q) * scale)
    return o, lse, dq, dk, dv


def _bf16_inputs(shape, seed):
    return [torch.from_numpy(x).to(torch.bfloat16).float()
            for x in _inputs(shape, seed)]


def _norm_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


# (head dim, length, numpy seed): every head dim the kernels take, at ragged
# lengths (one partial tile; 100 crosses the 64-key tiles of dq's ring), and
# longer rows whose sums run over several tiles of each kernel (512 is one of
# chip_smoke.py's kernel lengths)
ROUNDING_CASES = [(32, 7, 5), (64, 100, 7), (128, 100, 9), (64, 512, 11), (128, 300, 13)]


@pytest.mark.parametrize("d,t,seed", ROUNDING_CASES)
def test_bf16_kernel_rounding_fits_the_card_tolerances(d, t, seed):
    """The tolerances chip_smoke.py holds the bf16 kernels to (BF16_TOL for
    o and lse, BWD_BF16_TOL for dq, dk and dv) against the fp32 plain
    versions leave room for the design's own roundings, at a ragged
    length."""
    q, k, v, do = _bf16_inputs((1, 2, t, d), seed)
    o, lse, dq, dk, dv = _sm90_rounding(q, k, v, do)
    o_ref, lse_ref = tattn.plain_causal_attention_fwd(q, k, v)
    dq_ref, dk_ref, dv_ref = tattn.plain_causal_attention_bwd(q, k, v, o, lse, do)
    assert (o - o_ref).abs().max().item() <= chip_smoke.BF16_TOL
    assert (lse - lse_ref).abs().max().item() <= chip_smoke.BF16_TOL
    assert _norm_err(dq, dq_ref) <= chip_smoke.BWD_BF16_TOL
    assert _norm_err(dk, dk_ref) <= chip_smoke.BWD_BF16_TOL
    assert _norm_err(dv, dv_ref) <= chip_smoke.BWD_BF16_TOL


@pytest.mark.parametrize("d,t,seed", ROUNDING_CASES)
def test_bf16_kernel_rounding_agrees_with_jax_bf16(d, t, seed):
    """The same emulation against the JAX package's XLA attention run in
    bf16 on the same inputs (it also rounds p to bf16 before p v), forward
    and gradients, within the card's bf16 tolerances."""
    q, k, v, do = _bf16_inputs((1, 2, t, d), seed)
    o, _, dq, dk, dv = _sm90_rounding(q, k, v, do)

    @jax.jit
    def fwd_vjp(*args):   # fp32 in and out, bf16 inside
        q, k, v, do = (x.astype(jnp.bfloat16) for x in args)
        out, vjp = jax.vjp(jattn.xla_causal_attention, q, k, v)
        return [x.astype(jnp.float32) for x in (out, *vjp(do))]

    j_o, j_dq, j_dk, j_dv = (torch.from_numpy(np.array(x))
                             for x in fwd_vjp(*(x.numpy() for x in (q, k, v, do))))
    assert (o - j_o).abs().max().item() <= chip_smoke.BF16_TOL
    assert _norm_err(dq, j_dq) <= chip_smoke.BWD_BF16_TOL
    assert _norm_err(dk, j_dk) <= chip_smoke.BWD_BF16_TOL
    assert _norm_err(dv, j_dv) <= chip_smoke.BWD_BF16_TOL

"""ray_tpu_torch.parallel.train_step against ray_tpu.parallel.train_step, on
the CPU, tiny fp32 config.

The JAX ``TrainStep`` runs on one device; its state is carried across with
``load_flax_state`` (at step 0, and again mid-run after two steps) and both
steps then run on the same seeded batches. Loss and grad_norm are held to
1e-5 relative and the first step's gradients to 1e-5 absolute (fp32, only
the summation order differs). Parameters after a step are held to a bound
derived from the learning rate: Adam's first step moves every weight by
about lr whatever the size of its gradient, so a gradient near 0 whose sign
differs between the two sides moves a weight by up to 2 * lr.

The Llama (4 query heads, 2 KV heads) and GPT-2-MoE families take three
steps against the JAX ``TrainStep`` the same way, the MoE objective with
its aux loss: loss and grad_norm to 1e-4 relative, and after three steps
every parameter tensor to 1e-4 of its norm (fp32; Adam's sign flips on
near-0 gradients move single weights by up to 2 * lr, a tiny share of a
tensor's norm).

Also here: multi_step against repeated step, the weight-decay mask, the
clip against optax's formula, remat on and off, the device rule, and the
telemetry arithmetic against the JAX package's StepRecorder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import gpt2_moe as jgmoe
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import make_mesh
from ray_tpu.parallel.train_step import TrainStep as JTrainStep
from ray_tpu.train import _telemetry as jtel
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import gpt2_moe as tgmoe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel.pipeline import PipelineTrainStep
from ray_tpu_torch.parallel.train_step import TrainStep, clip_by_global_norm
from ray_tpu_torch.train import _telemetry as ttel

LR = 1e-3
RTOL = 1e-5      # loss, grad_norm: fp32, summation order only
FAMILY_RTOL = 1e-4  # Llama and GPT-2-MoE: loss, grad_norm, parameters
GRAD_TOL = 1e-5  # first-step gradients, absolute
JCFG = jgpt2.GPT2Config.tiny(dtype=jnp.float32, n_layer=2)
TCFG = tgpt2.GPT2Config.tiny(dtype=torch.float32, n_layer=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU ops: one thread is fastest and steady, where eight threads
    on cores shared with other test workers stall on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(n, B=4, T=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, TCFG.vocab_size, size=(B, T)).astype(np.int32)
        out.append({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    return out


def _numpy(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps from seed 3: the initial state, the state after two
    steps, the metrics of every step, the first step's gradients and the
    final params, all as numpy."""
    ts = JTrainStep(JCFG, make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    learning_rate=LR, telemetry=False)
    state = ts.init(jax.random.PRNGKey(3))
    batches = _batches(3)
    init = _numpy(state)

    def loss_of(params, batch):
        logits = ts.model.apply({"params": params}, batch["idx"])
        return jgpt2.loss_fn(logits, batch["targets"])

    grads = _numpy(jax.jit(jax.grad(loss_of))(
        state["params"], jax.tree.map(jnp.asarray, batches[0])))
    metrics, mid = [], None
    for i, b in enumerate(batches):
        state, m = ts.step(state, ts.shard_batch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 1:
            mid = _numpy(state)
    return {"init": init, "mid": mid, "metrics": metrics, "grads": grads,
            "final": _numpy(state["params"]), "batches": batches}


def _port(**kw):
    kw.setdefault("learning_rate", LR)
    return TrainStep(TCFG, device="cpu", telemetry=False, **kw)


def test_three_steps_follow_the_jax_train_step(jax_run):
    ts = _port()
    state = tgpt2.load_flax_state(ts, jax_run["init"])
    batches = [ts.shard_batch(b) for b in jax_run["batches"]]

    _, grads = ts.loss_and_grads(state, batches[0])
    ref = tgpt2._flax_tensors(state["params"], jax_run["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)

    got = []
    for b in batches:
        state, m = ts.step(state, b)
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(got, jax_run["metrics"], rtol=RTOL, atol=0)
    assert got[-1][0] < got[0][0] and state["step"] == 3
    assert state["opt_state"]["count"] == 3
    final = tgpt2._flax_tensors(state["params"], jax_run["final"])
    for name, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   atol=2 * LR, rtol=0, err_msg=name)


def test_mid_run_handover_from_the_jax_state(jax_run):
    ts = _port()
    state = tgpt2.load_flax_state(ts, jax_run["mid"])
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    state, m = ts.step(state, ts.shard_batch(jax_run["batches"][2]))
    np.testing.assert_allclose((m["loss"].item(), m["grad_norm"].item()),
                               jax_run["metrics"][2], rtol=RTOL, atol=0)
    final = tgpt2._flax_tensors(state["params"], jax_run["final"])
    for name, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   atol=2 * LR, rtol=0, err_msg=name)


@pytest.mark.parametrize("stacked", [True, False])
def test_multi_step_matches_repeated_step(stacked):
    ts = _port()
    batches = [ts.shard_batch(b) for b in _batches(3, seed=5)]
    if not stacked:
        batches = [batches[0]] * 3
    a, b = ts.init(), ts.init()
    singles = [ts.step(a, x)[1] for x in batches]
    arg = ({k: torch.stack([x[k] for x in batches]) for k in batches[0]}
           if stacked else batches[0])
    _, multi = ts.multi_step(b, arg, 3)
    for key in ("loss", "grad_norm"):
        assert multi[key].shape == (3,)
        torch.testing.assert_close(multi[key], torch.stack([m[key] for m in singles]),
                                   rtol=0, atol=0)
    assert b["step"] == 3
    for (name, p), q in zip(a["params"].named_parameters(), b["params"].parameters()):
        assert torch.equal(p, q), name


FAMILIES = {
    "llama": (jllama.LlamaConfig.tiny(dtype=jnp.float32),
              tllama.LlamaConfig.tiny(dtype=torch.float32), tllama),
    "gpt2_moe": (jgmoe.GPT2MoEConfig.tiny_moe(dtype=jnp.float32),
                 tgmoe.GPT2MoEConfig.tiny_moe(dtype=torch.float32), tgmoe),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_run(request):
    """Three JAX steps of a family from seed 3: the initial state, the
    metrics of every step and the final params, as numpy."""
    jcfg, tcfg, module = FAMILIES[request.param]
    ts = JTrainStep(jcfg, make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    learning_rate=LR, telemetry=False)
    state = ts.init(jax.random.PRNGKey(3))
    batches = _batches(3, B=2, T=16, seed=9)
    init = _numpy(state)
    metrics = []
    for b in batches:
        state, m = ts.step(state, ts.shard_batch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"name": request.param, "tcfg": tcfg, "module": module, "init": init,
            "metrics": metrics, "final": _numpy(state["params"]), "batches": batches}


def test_family_three_steps_follow_the_jax_train_step(family_run):
    run = family_run
    ts = TrainStep(run["tcfg"], device="cpu", telemetry=False, learning_rate=LR)
    assert ts.family is run["module"] and ts._is_moe == (run["name"] == "gpt2_moe")
    state = run["module"].load_flax_state(ts, run["init"])
    got = []
    for b in run["batches"]:
        state, m = ts.step(state, ts.shard_batch(b))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(got, run["metrics"], rtol=FAMILY_RTOL, atol=0)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    final = tgpt2._flax_tensors(state["params"], run["final"])
    errs = {}
    for name, p in state["params"].named_parameters():
        got_p, want_p = p.detach(), final[name]
        if name.endswith("attn.c_attn.bias"):
            # the key third of GPT-2's qkv bias has an exactly-0 gradient
            # (a constant added to every key shifts a query's scores alike),
            # so Adam normalises rounding noise there: the 2 * lr bound
            C = got_p.shape[0] // 3
            np.testing.assert_allclose(got_p[C:2 * C].numpy(), want_p[C:2 * C].numpy(),
                                       atol=2 * LR, rtol=0, err_msg=name)
            keep = torch.cat([torch.arange(C), torch.arange(2 * C, 3 * C)])
            got_p, want_p = got_p[keep], want_p[keep]
        errs[name] = ((got_p - want_p).norm() / want_p.norm()).item()
    assert max(errs.values()) <= FAMILY_RTOL, errs


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_weight_decay_mask_is_ndim_above_one(name):
    """RMSNorm weights, LayerNorm and biases stay out of the decay; dense
    kernels, embeddings and the 3-D expert stacks are decayed."""
    ts = TrainStep(FAMILIES[name][1], device="cpu", telemetry=False,
                   learning_rate=0.5, weight_decay=0.1)
    state = ts.init()
    before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    zero = {n: torch.zeros_like(p) for n, p in before.items()}
    ts.loss_and_grads = lambda state, batch: (torch.tensor(0.0), zero)
    ts.step(state, {})
    ndims = {p.ndim for p in before.values()}
    assert ndims == ({1, 2} if name == "llama" else {1, 2, 3})
    for n, p in state["params"].named_parameters():
        if before[n].ndim > 1:
            torch.testing.assert_close(p.detach(), before[n] * (1 - 0.5 * 0.1))
        else:
            assert torch.equal(p.detach(), before[n]), n


def test_weight_decay_leaves_biases_and_layer_norm_alone():
    # with zero gradients Adam's update is 0, so only decay moves a weight
    ts = _port(learning_rate=0.5, weight_decay=0.1)
    state = ts.init()
    before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    zero = {n: torch.zeros_like(p) for n, p in before.items()}
    ts.loss_and_grads = lambda state, batch: (torch.tensor(0.0), zero)
    ts.step(state, {})
    for name, p in state["params"].named_parameters():
        if before[name].ndim > 1:
            torch.testing.assert_close(p.detach(), before[name] * (1 - 0.5 * 0.1))
        else:
            assert torch.equal(p.detach(), before[name]), name


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in ((8, 4), (4,), (3, 5))]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got, norm = clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    assert (norm.item() < 1.0) == (scale == 0.1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


def test_remat_on_and_off_give_the_same_grads():
    batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in _batches(1)[0].items()}
    results = []
    for remat in (True, False):
        ts = TrainStep(dataclasses.replace(TCFG, remat=remat), device="cpu",
                       telemetry=False)
        results.append(ts.loss_and_grads(ts.init(), batch))
    (la, ga), (lb, gb) = results
    assert la.item() == lb.item()
    for name in ga:
        torch.testing.assert_close(ga[name], gb[name], rtol=0, atol=1e-7)


def test_bf16_config_trains_fp32_master_weights():
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    ts = TrainStep(cfg, device="cpu", telemetry=False, learning_rate=LR)
    state = ts.init()
    batch = ts.shard_batch(_batches(1)[0])
    losses = [ts.step(state, batch)[1]["loss"].item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in state["params"].parameters())
    assert all(m.dtype == torch.float32 for m in state["opt_state"]["mu"].values())


class _AxisSizes:
    """The part of a ``DeviceMesh`` that the constructor reads before it
    refuses a mesh (its axis names and sizes); multi-rank meshes are built
    in tests/test_torch_train_step_mesh.py."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize("case", ["no_cuda", "mesh", "other_family"])
def test_constructor_refuses_what_is_not_ported(monkeypatch, case):
    if case == "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrainStep(TCFG)
    elif case == "mesh":   # what JAX's shardings refuse too, before any collective
        moe = tgmoe.GPT2MoEConfig.tiny_moe(dtype=torch.float32)
        with pytest.raises(ValueError, match="ep = 8 does not divide num_experts = 4"):
            TrainStep(moe, _AxisSizes(dp=1, ep=8), device="cpu")
        with pytest.raises(ValueError, match="n_layer=2 not divisible by pp=4"):
            PipelineTrainStep(TCFG, _AxisSizes(dp=2, pp=4), device="cpu")
    else:   # a config that is not one of the port's families
        with pytest.raises(TypeError, match="LlamaConfig"):
            TrainStep(JCFG, device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_telemetry_summary_matches_the_jax_recorder():
    calls = [(2.0, dict(compile_step=True)),
             (0.25, dict(tokens=1024, examples=8)),
             (0.5, dict(tokens=1024, examples=8)),
             (1.0, dict(steps=4, tokens=4096, examples=32))]
    kw = dict(flops_per_token=6e6, peak_flops=1e12)
    jclk, tclk = FakeClock(), FakeClock()
    jrec = jtel.StepRecorder(clock=jclk, wall_clock=jclk, devices=[], n_devices=1,
                             emit_metrics=False, emit_spans=False, **kw)
    trec = ttel.StepRecorder(clock=tclk, **kw)
    for dt, extra in calls:
        for clk, rec in ((jclk, jrec), (tclk, trec)):
            clk.t += dt
            rec.record_step(dt, **extra)
    tclk.t += 3.0
    jclk.t += 3.0
    assert trec.summary() == jrec.summary()
    assert trec.mfu() == pytest.approx(6e6 * 6144 / 1.75 / 1e12)
    assert ttel.estimate_flops_per_token(TCFG) == jtel.estimate_flops_per_token(JCFG)
    assert ttel.peak_flops_per_device("NVIDIA H100 80GB HBM3") == 989e12
    assert ttel.peak_flops_per_device("cpu") is None


def test_telemetry_at_eight_devices_matches_the_jax_recorder():
    """n_devices = 8: MFU over eight devices' peak, and tokens/s of the
    tokens booked, by the JAX recorder's formula."""
    kw = dict(flops_per_token=6e6, peak_flops=1e12, n_devices=8)
    jclk, tclk = FakeClock(), FakeClock()
    jrec = jtel.StepRecorder(clock=jclk, wall_clock=jclk, devices=[],
                             emit_metrics=False, emit_spans=False, **kw)
    trec = ttel.StepRecorder(clock=tclk, **kw)
    for dt, extra in ((2.0, dict(compile_step=True)), (0.5, dict(tokens=8192, examples=64)),
                      (0.5, dict(tokens=8192, examples=64))):
        for clk, rec in ((jclk, jrec), (tclk, trec)):
            clk.t += dt
            rec.record_step(dt, **extra)
    assert trec.summary() == jrec.summary()
    assert trec.mfu() == jrec.mfu() == pytest.approx(6e6 * 16384 / 1.0 / 8e12)
    assert trec.tokens_per_second() == jrec.tokens_per_second() == 16384.0


def test_train_step_books_its_first_step_as_compile():
    ts = TrainStep(TCFG, device="cpu")
    state = ts.init()
    batch = ts.shard_batch(_batches(1)[0])
    for _ in range(3):
        ts.step(state, batch)
    ts.multi_step(state, batch, 2)
    rec = ts.telemetry
    assert rec.steps == 5 and rec.productive_steps == 4 and rec.compile_s > 0
    assert rec.tokens == 4 * 4 * 32 and rec.examples == 4 * 4
    s = rec.summary()
    assert "mfu" not in s and "hbm_bytes_in_use" not in s   # CPU: absent

"""ray_tpu_torch.serve.llm against ray_tpu.serve.llm, on the CPU.

Three levels, each on the same inputs through both packages:
  - the GPT-2, Llama (4 query heads, 2 KV heads) and GPT-2-MoE adapters
    (JAX weights carried across): prefill, a prefix-hit tail prefill, a
    batched decode and the speculative-verify decode_chunk, logits and K/V
    to 1e-4 (fp32, other summation order);
  - the whole engine on gpt2-tiny, llama-tiny and gpt2-moe-tiny: equal
    greedy token streams; with a draft model (speculative decoding) the
    streams equal the plain ones, in both packages;
  - the engine and the paged KV cache on the model-free FakeAdapter, in the
    scenarios of tests/test_serve_llm.py and tests/test_llm_prefix_spec.py
    (batching, preemption, prefix caching and copy-on-write, backpressure,
    cancel, seeded sampling, interrupted admission, speculative decoding
    with partial, zero and EOS-cut acceptance): equal results and equal
    acceptance, and the caches' integrity sweeps clean after each;
  - the engine's telemetry on one FakeAdapter scenario with preemption, a
    prefix hit and a draft: the ``ray_tpu_llm_*`` series after every step
    and the ``llm.*`` flight events (ids normalised) equal the JAX
    engine's; ``name=``, ``set_identity`` and ``load()`` as the JAX
    engine's;
  - the config flags a JAX user passes (``use_flash_attention=False``)
    build gpt2-tiny and gpt2-moe-tiny adapters that serve the JAX
    engine's greedy streams.
"""

import pickle
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ray_tpu._private import flight_recorder as jfr
from ray_tpu.serve.llm import adapters as jadapters
from ray_tpu.serve.llm import engine as jengine
from ray_tpu.serve.llm import kv_cache as jkv
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch._private import flight_recorder as tfr
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import gpt2_moe as tgmoe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.serve.llm import adapters as tadapters
from ray_tpu_torch.serve.llm import engine as tengine
from ray_tpu_torch.serve.llm import kv_cache as tkv
from ray_tpu_torch.util import metrics as tmetrics

TOL = 1e-4
TINY = {"n_layer": 2, "n_embd": 64, "n_head": 4, "vocab_size": 96, "block_size": 64}
SMALL = {"vocab_size": 96, "block_size": 64}   # llama-tiny, gpt2-moe-tiny widths


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU ops: one thread is fastest and steady, where eight threads
    on cores shared with other test workers stall on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def pair():
    jad = jadapters.build_adapter(
        "gpt2-tiny", {**TINY, "use_flash_attention": False}, seed=0)
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32, **TINY)
    model = tgpt2.load_flax_params(tgpt2.GPT2(cfg, device="cpu"), jad.p)
    return jad, tadapters.GPT2Adapter(cfg, model)


@pytest.fixture(scope="module")
def pairs(pair):
    """(JAX adapter, port adapter) per family, the port's weights carried
    across from the JAX adapter's."""
    jl = jadapters.build_adapter(
        "llama-tiny", {**SMALL, "use_flash_attention": False}, seed=1)
    lcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **SMALL)
    tl = tadapters.LlamaAdapter(
        lcfg, tllama.load_flax_params(tllama.Llama(lcfg, device="cpu"), jl.p))
    jm = jadapters.build_adapter(
        "gpt2-moe-tiny", {**SMALL, "use_flash_attention": False}, seed=2)
    mcfg = tgmoe.GPT2MoEConfig.tiny_moe(dtype=torch.float32, **SMALL)
    tm = tadapters.GPT2MoEAdapter(
        mcfg, tgmoe.load_flax_params(tgmoe.GPT2MoE(mcfg, device="cpu"), jm.p))
    assert tl.n_kv_heads == 2 and tl.n_heads == 4
    return {"gpt2": pair, "llama": (jl, tl), "gpt2_moe": (jm, tm)}


# ------------------------------------------------------------------ adapter


def test_adapter_prefill_matches_jax(pair):
    jad, tad = pair
    tokens = np.random.default_rng(0).integers(0, 96, 11)
    for want, got in zip(jad.prefill(tokens), tad.prefill(tokens)):
        np.testing.assert_allclose(_np(got), want, atol=TOL, rtol=0)


def test_adapter_prefix_hit_tail_matches_jax(pair):
    jad, tad = pair
    full = np.random.default_rng(1).integers(0, 96, 15)
    P = 9
    _, kc, vc = jad.prefill(full[:P])                   # the cached prefix
    want = jad.prefill_ctx(full[P:], P, kc, vc)
    got = tad.prefill_ctx(full[P:], P, torch.from_numpy(kc), torch.from_numpy(vc))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), w, atol=TOL, rtol=0)
    # a hit and a cold prefill of the whole context agree on the last logits
    np.testing.assert_allclose(_np(got[0]), _np(tad.prefill(full)[0]),
                               atol=TOL, rtol=0)


def test_adapter_batched_decode_matches_jax(pair):
    jad, tad = pair
    rng = np.random.default_rng(2)
    lens = np.asarray([5, 9, 2])
    tmax = int(lens.max())
    L, H, D = jad.n_layers, jad.n_kv_heads, jad.head_dim
    # padding past each length holds garbage: both sides must mask it
    k_ctx = rng.standard_normal((3, L, tmax, H, D)).astype(np.float32)
    v_ctx = rng.standard_normal((3, L, tmax, H, D)).astype(np.float32)
    for i, n in enumerate(lens):
        _, k, v = jad.prefill(rng.integers(0, 96, n))
        k_ctx[i, :, :n], v_ctx[i, :, :n] = k, v
    tokens = rng.integers(0, 96, 3)
    want = jad.decode(tokens, lens.copy(), k_ctx, v_ctx, lens.astype(np.int32))
    got = tad.decode(tokens, lens.copy(), torch.from_numpy(k_ctx),
                     torch.from_numpy(v_ctx), torch.from_numpy(lens))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w, atol=TOL, rtol=0)


def _drive(engine_mod, adapter):
    eng = engine_mod.LLMEngine(adapter, num_blocks=64, block_size=4, max_batch=4)
    sp = engine_mod.SamplingParams(max_tokens=8)
    prompts = [[5, 9, 17, 3], list(range(1, 20)), [7, 7, 7, 7, 7, 7, 1, 2]]
    rids = [eng.submit(p, sp) for p in prompts]
    eng.step()                                   # prompt 2's blocks indexed
    rids.append(eng.submit(prompts[1] + [4, 4], sp))   # prefix-cache hit
    eng.run_until_drained()
    eng.cache.assert_no_leaks()
    return [eng.pull(r) for r in rids], eng.cache.prefix_hit_tokens


def test_engine_gpt2_tiny_streams_equal_jax(pair):
    jad, tad = pair
    before = tattn.FLASH_FWD_LAUNCHES
    want = _drive(jengine, jad)
    got = _drive(tengine, tad)
    assert got == want
    assert got[1] > 0                            # the hit path ran
    assert all(done and len(t) == 8 for t, done, _ in got[0])
    assert tattn.FLASH_FWD_LAUNCHES == before    # CPU: plain path only


def _ctx_batch(jad, rng, lens):
    """A padded gathered context [B, L, Tmax, H, D] whose padding past each
    length holds garbage (both sides must mask it)."""
    L, H, D = jad.n_layers, jad.n_kv_heads, jad.head_dim
    tmax = int(lens.max())
    k_ctx = rng.standard_normal((len(lens), L, tmax, H, D)).astype(np.float32)
    v_ctx = rng.standard_normal((len(lens), L, tmax, H, D)).astype(np.float32)
    for i, n in enumerate(lens):
        _, k, v = jad.prefill(rng.integers(0, 96, n))
        k_ctx[i, :, :n], v_ctx[i, :, :n] = k, v
    return k_ctx, v_ctx


def adapter_call_prefill(jad, tad, rng):
    tokens = rng.integers(0, 96, 11)
    return jad.prefill(tokens), tad.prefill(tokens)


def adapter_call_prefix_hit(jad, tad, rng):
    full, P = rng.integers(0, 96, 15), 9
    _, kc, vc = jad.prefill(full[:P])
    return (jad.prefill_ctx(full[P:], P, kc, vc),
            tad.prefill_ctx(full[P:], P, torch.from_numpy(kc), torch.from_numpy(vc)))


def adapter_call_decode(jad, tad, rng):
    lens = np.asarray([5, 9, 2])
    k_ctx, v_ctx = _ctx_batch(jad, rng, lens)
    tokens = rng.integers(0, 96, 3)
    return (jad.decode(tokens, lens.copy(), k_ctx, v_ctx, lens.astype(np.int32)),
            tad.decode(tokens, lens.copy(), torch.from_numpy(k_ctx),
                       torch.from_numpy(v_ctx), torch.from_numpy(lens)))


def adapter_call_decode_chunk(jad, tad, rng):
    lens = np.asarray([5, 9, 2])
    k_ctx, v_ctx = _ctx_batch(jad, rng, lens)
    tokens = rng.integers(0, 96, (3, 4))
    return (jad.decode_chunk(tokens, lens.copy(), k_ctx, v_ctx, lens.astype(np.int32)),
            tad.decode_chunk(tokens, lens.copy(), torch.from_numpy(k_ctx),
                             torch.from_numpy(v_ctx), torch.from_numpy(lens)))


ADAPTER_CALLS = {f.__name__[len("adapter_call_"):]: f for f in (
    adapter_call_prefill, adapter_call_prefix_hit, adapter_call_decode,
    adapter_call_decode_chunk)}


@pytest.mark.parametrize("family,call", [("gpt2", "decode_chunk")] + [
    (f, c) for f in ("llama", "gpt2_moe") for c in sorted(ADAPTER_CALLS)])
def test_family_adapter_matches_jax(pairs, family, call):
    jad, tad = pairs[family]
    want, got = ADAPTER_CALLS[call](jad, tad, np.random.default_rng(3))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w, atol=TOL, rtol=0)


def test_decode_chunk_rows_equal_sequential_decodes(pairs):
    """decode_chunk's logits at chunk position c are decode's after the
    chunk's first c tokens were appended: the verify pass scores what plain
    decoding would have (the port alone, Llama with GQA)."""
    _, tad = pairs["llama"]
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 96, 7)
    chunk = rng.integers(0, 96, 3)
    _, k, v = tad.prefill(prompt)
    k_ctx, v_ctx = k[None], v[None]                        # [1, L, T, H, D]
    lens = torch.tensor([7])
    logits, _, _ = tad.decode_chunk(chunk[None], np.asarray([7]), k_ctx, v_ctx, lens)
    for c in range(3):
        step, k_new, v_new = tad.decode(chunk[c:c + 1], np.asarray([7 + c]),
                                        k_ctx, v_ctx, lens)
        torch.testing.assert_close(step[0], logits[0, c], rtol=0, atol=TOL)
        k_ctx = torch.cat([k_ctx, k_new[:, :, None]], dim=2)
        v_ctx = torch.cat([v_ctx, v_new[:, :, None]], dim=2)
        lens = lens + 1


@pytest.mark.parametrize("family", ["llama", "gpt2_moe"])
def test_engine_streams_equal_jax(pairs, family):
    jad, tad = pairs[family]
    want = _drive(jengine, jad)
    got = _drive(tengine, tad)
    assert got == want
    assert got[1] > 0
    assert all(done and len(t) == 8 for t, done, _ in got[0])


def _spec_streams(engine_mod, target, draft):
    sp = engine_mod.SamplingParams(max_tokens=8)
    prompt = [5, 9, 17, 3]
    cold = engine_mod.LLMEngine(target, num_blocks=64, block_size=4, max_batch=4,
                                prefix_cache=False)
    ref = _drain(cold, [cold.submit(prompt, sp)])
    spec = engine_mod.LLMEngine(target, num_blocks=64, block_size=4, max_batch=4,
                                prefix_cache=True, draft_adapter=draft, spec_k=3)
    outs = _drain(spec, [spec.submit(prompt, sp) for _ in range(3)])
    spec.draft_cache.assert_no_leaks()
    assert spec.draft_cache.num_used_blocks == 0 and spec.spec_rounds_total > 0
    return ref, outs, spec.spec_acceptance(), spec.stats()["spec_rounds_total"]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("draft", ["same", "other"])
def test_spec_streams_equal_plain_and_jax(pairs, family, draft):
    """The target drafts for itself (acceptance 1) or takes the other
    family's model as its draft (acceptance near 0): either way every
    speculative stream equals the plain stream, in both packages."""
    other = {"gpt2": "llama", "llama": "gpt2"}[family]
    jad, tad = pairs[family]
    jdraft, tdraft = pairs[family if draft == "same" else other]
    want = _spec_streams(jengine, jad, jdraft)
    got = _spec_streams(tengine, tad, tdraft)
    ref, outs, acceptance, _ = got
    assert all(o == ref[0] for o in outs)
    assert got == want
    # a draft that is the target agrees everywhere (below 1 only where the
    # budget of 8 tokens cuts the last round short); another model rarely
    assert acceptance > 0.8 if draft == "same" else acceptance < 0.5


def test_fake_adapter_step_cost_sleeps_once_per_call():
    """A fused call costs one simulated model time however many sequences
    or chunk tokens it carries (the spec benches' target:draft ratio)."""
    ad = tadapters.FakeAdapter(vocab_size=97, step_cost_s=0.05, device="cpu")
    kv = torch.zeros((3, 1, 4, 1, 1))
    t0 = time.perf_counter()
    ad.decode_chunk(np.ones((3, 5), np.int64), np.zeros(3), kv, kv, torch.tensor([4, 2, 0]))
    dt = time.perf_counter() - t0
    assert 0.05 <= dt < 0.5


def test_engine_refuses_a_draft_of_another_vocabulary():
    target = tadapters.FakeAdapter(vocab_size=97, device="cpu")
    draft = tadapters.FakeAdapter(vocab_size=96, device="cpu")
    with pytest.raises(ValueError, match="draft vocab 96"):
        tengine.LLMEngine(target, draft_adapter=draft)
    # spec_k = 0 turns speculation off even with a draft
    eng = tengine.LLMEngine(target, draft_adapter=draft, spec_k=0)
    assert eng.draft_cache is None and "spec_acceptance" not in eng.stats()


# ------------------------------------------------ engine on the fake model

JAX = SimpleNamespace(
    LLMEngine=jengine.LLMEngine, SamplingParams=jengine.SamplingParams,
    LLMBackpressure=jengine.LLMBackpressure,
    KVCacheExhausted=jkv.KVCacheExhausted,
    fake=lambda **kw: jadapters.FakeAdapter(**kw))
PORT = SimpleNamespace(
    LLMEngine=tengine.LLMEngine, SamplingParams=tengine.SamplingParams,
    LLMBackpressure=tengine.LLMBackpressure,
    KVCacheExhausted=tkv.KVCacheExhausted,
    fake=lambda **kw: tadapters.FakeAdapter(device="cpu", **kw))


def _drain(eng, rids):
    eng.run_until_drained()
    out = [eng.pull(r) for r in rids]
    assert all(done for _, done, _ in out)
    eng.cache.assert_no_leaks()
    assert eng.cache.num_used_blocks == 0
    return [(toks, reason) for toks, _, reason in out]


def _engine(E, **kw):
    return E.LLMEngine(E.fake(vocab_size=97), **kw)


def scenario_batched_vs_unbatched(E):
    big = _engine(E, num_blocks=64, block_size=4, max_batch=8, max_waiting=32)
    batched = _drain(big, [big.submit([1, 2, 3], E.SamplingParams(max_tokens=12))
                           for _ in range(6)])
    one = _engine(E, num_blocks=64, block_size=4, max_batch=1, max_waiting=32)
    single = _drain(one, [one.submit([1, 2, 3], E.SamplingParams(max_tokens=12))])
    assert all(b == single[0] for b in batched)
    return batched


def scenario_preemption_recompute(E):
    tiny = _engine(E, num_blocks=7, block_size=2, max_batch=4, max_waiting=32)
    outs = _drain(tiny, [tiny.submit([7, 8], E.SamplingParams(max_tokens=10))
                         for _ in range(3)])
    assert tiny.scheduler.preemptions_total > 0
    return outs, tiny.scheduler.preemptions_total


def scenario_prefix_equals_cold(E):
    prompt = list(range(1, 20))
    cold = _engine(E, num_blocks=128, block_size=4, max_batch=4, prefix_cache=False)
    ref = _drain(cold, [cold.submit(prompt, E.SamplingParams(max_tokens=8))])
    warm = _engine(E, num_blocks=128, block_size=4, max_batch=2, prefix_cache=True)
    outs = _drain(warm, [warm.submit(prompt, E.SamplingParams(max_tokens=8))
                         for _ in range(5)])
    assert all(o == ref[0] for o in outs) and warm.cache.prefix_hit_tokens > 0
    return outs, warm.cache.prefix_hit_tokens, warm.cache.cow_copies


def scenario_cow_preempt(E):
    prompt = [7, 8, 9, 10, 11, 12, 13, 14, 15]
    tiny = _engine(E, num_blocks=14, block_size=2, max_batch=4, prefix_cache=True)
    old = tiny.submit(prompt, E.SamplingParams(max_tokens=12))
    tiny.step()
    young = tiny.submit(prompt, E.SamplingParams(max_tokens=12))
    tiny.step()
    while tiny.scheduler.preemptions_total == 0 and tiny.has_work():
        tiny.step()
        tiny.cache.assert_no_leaks()
    assert tiny.scheduler.preemptions_total > 0
    return _drain(tiny, [old, young]), tiny.cache.prefix_hit_tokens


def scenario_backpressure(E):
    eng = _engine(E, num_blocks=16, block_size=4, max_batch=1, max_waiting=2)
    eng.submit([1]), eng.submit([2])
    with pytest.raises(E.LLMBackpressure) as ei:
        eng.submit([3])
    again = pickle.loads(pickle.dumps(ei.value))
    assert isinstance(again, E.LLMBackpressure)
    return ei.value.to_dict(), again.to_dict()


def scenario_cancel_frees_kv(E):
    eng = _engine(E, num_blocks=32, block_size=2, max_batch=4)
    keep = eng.submit([1, 2], E.SamplingParams(max_tokens=6))
    drop = eng.submit([3, 4], E.SamplingParams(max_tokens=50))
    eng.step()
    used = eng.cache.num_used_blocks
    assert eng.cancel(drop)
    dropped = eng.pull(drop)
    return used, dropped, _drain(eng, [keep])


def scenario_seeded_temperature(E):
    outs = []
    for seed in (7, 7, 8):
        eng = _engine(E, num_blocks=32, block_size=4, max_batch=2)
        outs += _drain(eng, [eng.submit([1, 2], E.SamplingParams(
            max_tokens=8, temperature=1.0, top_k=20, seed=seed))])
    assert outs[0] == outs[1] and outs[0] != outs[2]
    return outs


def scenario_interrupted_admission(E):
    eng = _engine(E, num_blocks=32, block_size=2, max_batch=4, prefix_cache=True)
    ref = _drain(eng, [eng.submit([1, 2, 3, 4, 5], E.SamplingParams(max_tokens=6))])
    armed = [True]
    orig = eng.cache.write_prefill

    def exploding_write(seq_id, k, v):
        if armed[0]:
            armed[0] = False
            raise E.KVCacheExhausted("injected mid-admission failure")
        return orig(seq_id, k, v)

    eng.cache.write_prefill = exploding_write
    rid = eng.submit([1, 2, 3, 4, 5], E.SamplingParams(max_tokens=6))
    assert eng.step()["tokens"] == 0
    assert eng.scheduler.get(rid).state == "WAITING"
    eng.cache.assert_no_leaks()
    out = _drain(eng, [rid])
    assert out == ref
    return out


def _spec_engine(E, draft_every, **kw):
    return E.LLMEngine(E.fake(vocab_size=97), draft_adapter=E.fake(
        vocab_size=97, disagree_every=draft_every), **kw)


def _spec_result(eng, out):
    eng.draft_cache.assert_no_leaks()
    assert eng.draft_cache.num_used_blocks == 0
    stats = eng.stats()
    return (out, eng.spec_acceptance(), eng.spec_rounds_total,
            eng.spec_proposed_total, eng.steps_total,
            stats["spec_acceptance"], stats["spec_rounds_total"])


def scenario_spec_partial_acceptance(E):
    base = _engine(E, num_blocks=64, block_size=4, max_batch=4, prefix_cache=False)
    (ref, _), = _drain(base, [base.submit([7, 8, 9], E.SamplingParams(max_tokens=20))])
    spec = _spec_engine(E, 7, num_blocks=64, block_size=4, max_batch=4, spec_k=4)
    out = _drain(spec, [spec.submit([7, 8, 9], E.SamplingParams(max_tokens=20))
                        for _ in range(3)])
    assert all(o == (ref, "length") for o in out)
    assert 0.0 < spec.spec_acceptance() < 1.0 and spec.steps_total < 3 * 20
    return _spec_result(spec, out)


def scenario_spec_zero_acceptance(E):
    base = _engine(E, num_blocks=64, block_size=4, max_batch=2, prefix_cache=False)
    ref = _drain(base, [base.submit([3, 5], E.SamplingParams(max_tokens=10))])
    # disagree_every=1 perturbs EVERY draft token: the worst-case draft
    spec = _spec_engine(E, 1, num_blocks=64, block_size=4, max_batch=2, spec_k=3)
    out = _drain(spec, [spec.submit([3, 5], E.SamplingParams(max_tokens=10))])
    assert out == ref and spec.spec_acceptance() == 0.0
    return _spec_result(spec, out)


def scenario_spec_eos_inside_accepted_run(E):
    base = _engine(E, num_blocks=64, block_size=4, max_batch=2, prefix_cache=False)
    (ref, _), = _drain(base, [base.submit([7, 8, 9], E.SamplingParams(max_tokens=20))])
    sp = E.SamplingParams(max_tokens=20, eos_id=ref[5])    # terminate mid-stream
    results = []
    for draft_every in (0, 7):                             # perfect and partial
        spec = _spec_engine(E, draft_every, num_blocks=64, block_size=4,
                            max_batch=2, prefix_cache=False, spec_k=4)
        out = _drain(spec, [spec.submit([7, 8, 9], sp)])
        assert out == [(ref[:6], "eos")]
        results.append(_spec_result(spec, out))
    return results


def scenario_spec_sampled_take_plain_path(E):
    sp = dict(max_tokens=8, temperature=1.0, seed=7)
    plain = _engine(E, num_blocks=64, block_size=4, max_batch=4)
    ref = _drain(plain, [plain.submit([1, 2], E.SamplingParams(**sp))])
    spec = _spec_engine(E, 0, num_blocks=64, block_size=4, max_batch=4, spec_k=4)
    greedy = spec.submit([1, 2], E.SamplingParams(max_tokens=8))
    sampled = spec.submit([1, 2], E.SamplingParams(**sp))
    out = _drain(spec, [greedy, sampled])
    assert out[1] == ref[0] and spec.spec_proposed_total > 0
    return _spec_result(spec, out)


def scenario_eos_and_pull_markers(E):
    eng = _engine(E, num_blocks=64, block_size=4, max_batch=2)
    (ref, _), = _drain(eng, [eng.submit([7, 8, 9], E.SamplingParams(max_tokens=20))])
    rid = eng.submit([7, 8, 9], E.SamplingParams(max_tokens=20, eos_id=ref[5]))
    out = _drain(eng, [rid])
    assert out == [(ref[:6], "eos")]
    return out, eng.pull("nope"), eng.pull(rid)


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_batched_vs_unbatched, scenario_preemption_recompute,
    scenario_prefix_equals_cold, scenario_cow_preempt, scenario_backpressure,
    scenario_cancel_frees_kv, scenario_seeded_temperature,
    scenario_interrupted_admission, scenario_eos_and_pull_markers,
    scenario_spec_partial_acceptance, scenario_spec_zero_acceptance,
    scenario_spec_eos_inside_accepted_run, scenario_spec_sampled_take_plain_path)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fake_engine_scenario_equals_jax(name):
    assert SCENARIOS[name](PORT) == SCENARIOS[name](JAX)


# -------------------------------------------------------- engine telemetry

JAX.metrics, JAX.recorder = jmetrics, jfr
PORT.metrics, PORT.recorder = tmetrics, tfr
LLM_SERIES = ("ray_tpu_llm_tokens_per_s", "ray_tpu_llm_kv_utilization",
              "ray_tpu_llm_batch_size", "ray_tpu_llm_preemptions_total",
              "ray_tpu_llm_prefix_hit_rate", "ray_tpu_llm_spec_acceptance")


@pytest.fixture
def clean_tables():
    """Both metric tables drained for the test; their earlier deltas put
    back afterwards."""
    saved = [(m, m.drain_records()) for m in (jmetrics, tmetrics)]
    yield
    for m, records in saved:
        m.drain_records()
        m.restore_records(records)


def _llm_series(E, deployment, replica=""):
    """{series: value} of one engine's ray_tpu_llm_* records since the last
    drain (counters as deltas, gauges as their last value)."""
    return {r["name"]: r["value"] for r in E.metrics.drain_records()
            if r["name"].startswith("ray_tpu_llm_")
            and r["labels"] == {"deployment": deployment, "replica": replica}}


def _last_seq(E):
    snap = E.recorder.get_recorder().snapshot()
    return snap[-1][0] if snap else 0


def _llm_events(E, after):
    """(event, detail) of the llm.* events recorded after seq ``after``,
    request ids numbered by first appearance (each package counts its own)."""
    ids = {}
    norm = lambda m: "seq#%d" % ids.setdefault(m.group(0), len(ids))
    return [(e["event"], re.sub(r"seq-\d+", norm, str(e["b"])))
            for e in E.recorder.dump() if e["seq"] > after
            and e["event"].startswith("llm.")]


def telemetry_run(E):
    """Preemption (a 14-block pool), a prefix hit (one prompt twice) and a
    draft (k = 2), stepped one at a time: per step, the engine's series."""
    eng = E.LLMEngine(E.fake(vocab_size=97),
                      draft_adapter=E.fake(vocab_size=97, disagree_every=3),
                      num_blocks=14, block_size=2, max_batch=4, prefix_cache=True,
                      spec_k=2, name="parity")
    prompt = [7, 8, 9, 10, 11, 12, 13, 14, 15]
    sp = E.SamplingParams(max_tokens=12)
    before = _last_seq(E)
    rids = [eng.submit(prompt, sp)]
    series = [(eng.step()["tokens"], _llm_series(E, "parity"))]
    rids += [eng.submit(prompt, sp), eng.submit([3, 4, 5], sp)]
    while eng.has_work():
        series.append((eng.step()["tokens"], _llm_series(E, "parity")))
    series.append((eng.step()["tokens"], _llm_series(E, "parity")))   # idle step
    outs = [eng.pull(r) for r in rids]
    counts = (eng.scheduler.preemptions_total, eng.cache.prefix_hit_tokens,
              eng.spec_rounds_total)
    return series, _llm_events(E, before), outs, counts


def test_engine_series_and_events_equal_jax(clean_tables):
    want_series, want_events, want_outs, want_counts = telemetry_run(JAX)
    got_series, got_events, got_outs, got_counts = telemetry_run(PORT)
    assert got_outs == want_outs and got_counts == want_counts
    assert all(c > 0 for c in got_counts)          # preempted, hit, speculated
    assert len(got_series) == len(want_series)
    seen = set().union(*(s for _, s in got_series))
    assert seen == set(LLM_SERIES)
    produced = False
    for (tokens, got), (_, want) in zip(got_series, want_series):
        assert set(got) == set(want)
        rate = got.pop("ray_tpu_llm_tokens_per_s")    # an EMA of wall-clock rates
        want.pop("ray_tpu_llm_tokens_per_s")
        produced = produced or tokens > 0
        assert rate > 0 if produced else rate == 0.0
        assert got == want
    assert [e for e, _ in got_events] == [e for e, _ in want_events]
    assert got_events == want_events
    names = {e for e, _ in got_events}
    assert names == {"llm.admit", "llm.preempt", "llm.finish", "llm.prefix_hit",
                     "llm.spec_verify"}


def identity_run(E):
    eng = E.LLMEngine(E.fake(vocab_size=97), num_blocks=16, block_size=4,
                      max_batch=1, name="first")
    loads = [eng.load()]
    rids = [eng.submit([1, 2], E.SamplingParams(max_tokens=3)) for _ in range(3)]
    loads.append(eng.load())
    eng.step()
    first = sorted(_llm_series(E, "first"))
    eng.set_identity("second", "r-1")
    eng.step()
    loads.append(eng.load())
    eng.run_until_drained()
    loads.append(eng.load())
    return (first, sorted(_llm_series(E, "second", "r-1")), loads,
            [eng.pull(r)[1] for r in rids])


def test_engine_identity_and_load_equal_jax(clean_tables):
    got, want = identity_run(PORT), identity_run(JAX)
    assert got == want
    assert got[0] and got[1] and got[2][::3] == [0, 0] and got[2][1] == 3
    default = PORT.LLMEngine(PORT.fake(vocab_size=97))
    assert default._tags == {"deployment": "llm", "replica": ""}


@pytest.mark.parametrize("model,config", [
    ("gpt2-tiny", TINY), ("gpt2-moe-tiny", SMALL)])
def test_use_flash_attention_off_serves_the_jax_streams(model, config):
    """The JAX package's serving tests build these adapters with
    ``use_flash_attention`` off; the port takes the same config."""
    cfg = {**config, "use_flash_attention": False}
    jad = jadapters.build_adapter(model, cfg, seed=0)
    tad = tadapters.build_adapter(model, cfg, seed=0, device="cpu")
    assert tad.cfg.use_flash_attention is False and tad.cfg.dropout == 0.0
    family = tgmoe if model == "gpt2-moe-tiny" else tgpt2
    family.load_flax_params(tad.model, jad.p)       # the JAX weights across
    before = tattn.FLASH_FWD_LAUNCHES
    got, want = _drive(tengine, tad), _drive(jengine, jad)
    assert got == want and got[1] > 0
    assert tattn.FLASH_FWD_LAUNCHES == before


# ------------------------------------------------------------- paged cache


def _caches(**kw):
    base = dict(num_blocks=16, block_size=4, n_layers=1, n_kv_heads=1, head_dim=2)
    base.update(kw)
    return (jkv.PagedKVCache(**base),
            tkv.PagedKVCache(**base, device="cpu"))


def _fill(c, sid, tokens):
    """allocate_cached + write the un-hit tail (token t -> KV value t)."""
    served = c.allocate_cached(sid, tokens, extra=1)
    assert served is not None
    tail = np.asarray(tokens[served:], np.float32)
    arr = np.broadcast_to(tail[None, :, None, None],
                          (c.n_layers, len(tail), c.n_kv_heads, c.head_dim)).copy()
    c.write_prefill(sid, arr, arr)
    c.register_prefix(sid, tokens)
    return served


def _state(c, sids):
    out = {"tables": {s: list(c.block_tables[s]) for s in sids if s in c.block_tables},
           "refs": c.ref_counts.tolist(), "cow": c.cow_copies,
           "evictions": c.prefix_evictions, "free": c.num_free_blocks}
    out["kv"] = {s: _np(c.gather(s)[0]).tolist() for s in out["tables"]}
    return out


def script_share_and_survive(c):
    toks = list(range(10))
    served = [_fill(c, "a", toks), _fill(c, "b", toks)]
    mid = _state(c, "ab")
    c.free("a")
    after = _state(c, "b")
    c.free("b")
    served.append(_fill(c, "d", toks))
    return served, mid, after, _state(c, "d")


def script_cow_non_aligned(c):
    toks = [3, 1, 4, 1, 5, 9, 2, 6]
    return _fill(c, "a", toks), _fill(c, "b", toks), _state(c, "ab")


def script_truncate_then_append(c):
    toks = [1, 2, 3, 4, 5]
    _fill(c, "a", toks), _fill(c, "b", toks)
    c.truncate("b", 3)
    one = np.ones((1, 1, 2), np.float32)
    assert c.extend("b", 1)
    c.append("b", one, one)
    return _state(c, "ab")


def script_lru_eviction(c):
    _fill(c, "a", [1, 2, 3])
    c.free("a")
    assert c.allocate("big", c.num_blocks * c.block_size)
    return c.num_cached_blocks, c.prefix_evictions, c.match_prefix([1, 2, 3])


def script_rollback_on_exhaustion(c):
    _fill(c, "a", [1, 2, 3] + [0] * (c.num_blocks * c.block_size - 8))
    return c.allocate_cached("b", [1, 2, 3, 4, 5, 6, 7], extra=1), _state(c, "ab")


def script_gather_batch(c):
    for sid, toks in (("a", [3, 4, 5, 6, 7]), ("b", [9])):
        _fill(c, sid, toks)
    k, _, lens = c.gather_batch(["a", "b"])
    return list(_np(k).shape), _np(lens).tolist(), _np(k)[0, 0, :5, 0, 0].tolist()


CACHE_SCRIPTS = {f.__name__[len("script_"):]: f for f in (
    script_share_and_survive, script_cow_non_aligned, script_truncate_then_append,
    script_lru_eviction, script_rollback_on_exhaustion, script_gather_batch)}


@pytest.mark.parametrize("name", sorted(CACHE_SCRIPTS))
def test_paged_cache_bookkeeping_equals_jax(name):
    jc, tc = _caches(block_size=2 if name != "cow_non_aligned" else 4,
                     enable_prefix_cache=True)
    want = CACHE_SCRIPTS[name](jc)
    got = CACHE_SCRIPTS[name](tc)
    assert got == want
    tc.assert_no_leaks()
    assert tc.k.device.type == "cpu" and isinstance(tc.k, torch.Tensor)

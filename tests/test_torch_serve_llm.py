"""ray_tpu_torch.serve.llm against ray_tpu.serve.llm, on the CPU.

Three levels, each on the same inputs through both packages:
  - the GPT-2 adapter (JAX weights carried across): prefill, a prefix-hit
    tail prefill and a batched decode, logits and K/V to 1e-4 (fp32, other
    summation order);
  - the whole engine on gpt2-tiny: equal greedy token streams;
  - the engine and the paged KV cache on the model-free FakeAdapter, in the
    scenarios of tests/test_serve_llm.py and tests/test_llm_prefix_spec.py
    (batching, preemption, prefix caching and copy-on-write, backpressure,
    cancel, seeded sampling, interrupted admission): equal results, and the
    cache's integrity sweep clean after each.
"""

import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ray_tpu.serve.llm import adapters as jadapters
from ray_tpu.serve.llm import engine as jengine
from ray_tpu.serve.llm import kv_cache as jkv
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.serve.llm import adapters as tadapters
from ray_tpu_torch.serve.llm import engine as tengine
from ray_tpu_torch.serve.llm import kv_cache as tkv

TOL = 1e-4
TINY = {"n_layer": 2, "n_embd": 64, "n_head": 4, "vocab_size": 96, "block_size": 64}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def pair():
    jad = jadapters.build_adapter(
        "gpt2-tiny", {**TINY, "use_flash_attention": False}, seed=0)
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32, **TINY)
    model = tgpt2.load_flax_params(tgpt2.GPT2(cfg, device="cpu"), jad.p)
    return jad, tadapters.GPT2Adapter(cfg, model)


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


def _drive_gpt2(engine_mod, adapter):
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
    want = _drive_gpt2(jengine, jad)
    got = _drive_gpt2(tengine, tad)
    assert got == want
    assert got[1] > 0                            # the hit path ran
    assert all(done and len(t) == 8 for t, done, _ in got[0])
    assert tattn.FLASH_FWD_LAUNCHES == before    # CPU: plain path only


def test_engine_refuses_speculative_decoding():
    ad = tadapters.FakeAdapter(device="cpu")
    with pytest.raises(NotImplementedError, match="decode_chunk"):
        tengine.LLMEngine(ad, spec_k=4)
    with pytest.raises(NotImplementedError):
        tengine.LLMEngine(ad, draft_adapter=ad)


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
    scenario_interrupted_admission, scenario_eos_and_pull_markers)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fake_engine_scenario_equals_jax(name):
    assert SCENARIOS[name](PORT) == SCENARIOS[name](JAX)


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

"""The forward kernel's tile plan, on the CPU.

The fp32 forward's query rows per block are chosen in Python
(``fwd_block_m``) and passed to the C entry point; ``fwd_tiles`` lists the
blocks as the kernel maps them. Checked here without a card: every query
row of every (b, h) slice is one block's, across the launch's chunks; each
block sees every key of its causal rows (keys are not split); the heaviest
tiles launch first; serving shapes fill the card; and the entry point gets
what the plan says, with a stub in place of the compiled library.
"""

import contextlib

import pytest
import torch

from ray_tpu_torch.ops import attention as tattn

SMS = tattn.H100_SMS


@pytest.mark.parametrize("bh", [1, 12, 192, 65535])
@pytest.mark.parametrize("t", [1, 7, 63, 64, 65, 100, 150, 512, 600, 1023, 1024, 1100])
def test_fwd_plan_covers_every_row_once(t, bh):
    """Over the launch's chunks, each (b, h) slice is one chunk's; in a
    chunk every slice gets the same q tiles, one block each, and those
    tiles cover rows 0 .. t-1 once; a block sees every key of its causal
    rows (keys are not split); the keys a block walks never grow along the
    launch (heaviest first)."""
    seen = []
    for start, n in tattn._chunks(bh):
        rows = tattn.fwd_block_m(n, t, torch.float32)
        tiles = tattn.fwd_tiles(n, t, rows)
        n_tiles = -(-t // rows)
        assert tiles.shape == (n_tiles * n, 4)
        slice_, q0, stop, kv_stop = tiles.unbind(1)
        # rows [q0, stop) see keys [0, stop): each visible pair once
        assert torch.equal(kv_stop, stop)
        assert (kv_stop[1:] <= kv_stop[:-1]).all()
        by_rank = tiles.view(n_tiles, n, 4)
        assert torch.equal(by_rank[:, :, 0], torch.arange(n).expand(n_tiles, n))
        assert torch.equal(by_rank[:, :, 1:], by_rank[:, :1, 1:].expand(-1, n, -1))
        counts = torch.zeros(t + 1, dtype=torch.int64)
        first = by_rank[:, 0]
        counts.index_add_(0, first[:, 1], torch.ones(n_tiles, dtype=torch.int64))
        counts.index_add_(0, first[:, 2], -torch.ones(n_tiles, dtype=torch.int64))
        assert (counts.cumsum(0)[:t] == 1).all()
        assert (first[:, 1] < first[:, 2]).all() and (first[:, 2] <= t).all()
        seen.append(torch.arange(n) + start)
    assert torch.equal(torch.cat(seen), torch.arange(bh))


@pytest.mark.parametrize("bh,t,rows", [
    (12, 150, 16), (12, 512, 32), (12, 600, 32), (12, 1024, 32),
    (48, 1024, 64), (12, 4096, 64), (4, 512, 16), (1, 1, 16), (65532, 1, 64),
])
def test_fwd_block_m_fills_the_card(bh, t, rows):
    """The first tile whose grid holds its waves: 64 rows from two blocks
    per SM (a training batch), 32 from one (one request's prompt of 512 to
    1024 tokens over 12 heads), else 16 (a short prompt); a larger tile is
    chosen whenever its waves are there; bf16 keeps its 128 rows."""
    assert tattn.fwd_block_m(bh, t, torch.float32) == rows
    waves = dict(tattn.FP32_TILES)
    assert bh * -(-t // rows) >= waves[rows] * SMS
    assert all(bh * -(-t // m) < waves[m] * SMS
               for m in tattn.FP32_BLOCK_MS if m > rows)
    assert tattn.fwd_block_m(bh, t, torch.bfloat16) == tattn.BF16_BLOCK_M
    # a card with fewer SMs is full sooner
    assert tattn.fwd_block_m(bh, t, torch.float32, sms=1) == \
        next(m for m, w in tattn.FP32_TILES if bh * -(-t // m) >= w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_fwd_entry_point_gets_the_plan(monkeypatch, d, dtype):
    """The wrapper passes each chunk's plan to ``flash_attn_fwd``:
    (b*h, t, d, dtype, block_m, stream) after the five pointers, with
    block_m = fwd_block_m(chunk, t), one launch (and one count) a chunk."""
    calls = []

    def fake(*args):
        calls.append(args[5:])
        return 0

    monkeypatch.setattr(tattn, "_kernel", lambda: (fake, lambda rc: b"stub"))
    monkeypatch.setattr(tattn, "_on_card", lambda q: contextlib.nullcontext(7))
    monkeypatch.setattr(tattn, "_sm_count", lambda device: SMS)
    code = tattn._KERNEL_DTYPES[dtype]
    for shape in [(1, 12, 150, d), (1, 12, 1024, d), (16, 12, 64, d), (1, 1, 1, d),
                  (5462, 12, 1, d)]:
        b, h, t, _ = shape
        q = torch.zeros(shape, dtype=dtype)
        calls.clear()
        before = tattn.FLASH_FWD_LAUNCHES
        o, lse = tattn._kernel_fwd(q, q, q)
        assert o.shape == shape and o.dtype == dtype and lse.shape == (b, h, t)
        want = [(n, t, d, code, tattn.fwd_block_m(n, t, dtype), 7)
                for _, n in tattn._chunks(b * h)]
        assert calls == want
        assert tattn.FLASH_FWD_LAUNCHES - before == len(want)


def test_fwd_failed_launch_raises_with_the_cuda_error(monkeypatch):
    """A launch the card refuses (the C entry's cudaError) raises, naming it."""
    monkeypatch.setattr(tattn, "_kernel", lambda: (lambda *a: 1,
                                                   lambda rc: b"invalid argument"))
    monkeypatch.setattr(tattn, "_on_card", lambda q: contextlib.nullcontext(0))
    monkeypatch.setattr(tattn, "_sm_count", lambda device: SMS)
    q = torch.zeros((1, 2, 8, 64))
    before = tattn.FLASH_FWD_LAUNCHES
    with pytest.raises(RuntimeError, match="invalid argument"):
        tattn._kernel_fwd(q, q, q)
    assert tattn.FLASH_FWD_LAUNCHES == before

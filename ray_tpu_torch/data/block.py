"""Block model: the unit of data movement (reference: python/ray/data/block.py).

A block is either a row block (``list`` of items) or a column block
(``dict[str, np.ndarray]``). Blocks travel between operators as object-store
refs, so a map stage on another worker reads them zero-copy from plasma.

A copy of ``ray_tpu/data/block.py``: blocks stay numpy (or python rows) in
the port too, so the CPU workers that map, shuffle and read them never
import torch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np

Block = Union[List[Any], Dict[str, np.ndarray]]


def block_num_rows(block: Block) -> int:
    if isinstance(block, dict):
        if not block:
            return 0
        return len(next(iter(block.values())))
    return len(block)


def slice_block(block: Block, start: int, end: int) -> Block:
    if isinstance(block, dict):
        return {k: v[start:end] for k, v in block.items()}
    return block[start:end]


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b)]
    if not blocks:
        return []
    if isinstance(blocks[0], dict):
        keys = blocks[0].keys()
        return {k: np.concatenate([np.asarray(b[k]) for b in blocks])
                for k in keys}
    out: List[Any] = []
    for b in blocks:
        out.extend(b)
    return out


def block_schema(block: Block):
    if isinstance(block, dict):
        return {k: np.asarray(v).dtype for k, v in block.items()}
    if block:
        return type(block[0])
    return None


def rows_of(block: Block):
    """Iterate a block as python rows (dict rows for column blocks)."""
    if isinstance(block, dict):
        keys = list(block.keys())
        n = block_num_rows(block)
        for i in range(n):
            yield {k: block[k][i] for k in keys}
    else:
        yield from block

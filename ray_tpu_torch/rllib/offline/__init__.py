"""Offline RL data plane: record episodes to parquet, read them back as a
ray_tpu_torch.data Dataset (the port of ``ray_tpu/rllib/offline``). Writing
and reading parquet needs pyarrow in the processes that do it.

Reference: rllib/offline/offline_data.py:18 (OfflineData wraps
ray.data.read_* for offline algorithms), rllib/offline/json_writer.py /
output writers (we standardize on parquet — the columnar format the data
layer already reads with column/filter pushdown). Rows are per-STEP:
episode_id, t, obs (list<float>), action, reward, done, and the
discounted return-to-go the advantage-weighted algorithms train against
(reference: marwil computes cumulative discounted returns in its
postprocessing, postprocess_advantages).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def record_episodes(env_name: str, policy_fn: Callable[[np.ndarray], int],
                    num_episodes: int, path: str, *, gamma: float = 0.99,
                    seed: int = 0, max_steps: int = 1000) -> dict:
    """Roll `num_episodes` with policy_fn (obs -> action) and write one
    parquet dataset of per-step rows to `path`. Returns summary stats."""
    from ray_tpu_torch import data as rt_data
    from ray_tpu_torch.rllib.env._classic_control import make

    env = make(env_name)
    rows: List[dict] = []
    returns = []
    for ep in range(num_episodes):
        obs, _ = env.reset(seed=seed + ep)
        ep_rows = []
        done = False
        t = 0
        while not done and t < max_steps:
            action = int(policy_fn(np.asarray(obs)))
            nxt, reward, term, trunc, _ = env.step(action)
            done = bool(term or trunc)
            row = {
                "episode_id": ep, "t": t,
                "action": action, "reward": float(reward),
                "done": done,
            }
            # one scalar column per obs dim (obs_0..obs_{d-1}): parquet has
            # no 2-D columns and scalar columns keep filter pushdown usable
            for j, x in enumerate(np.asarray(obs, np.float32).ravel()):
                row[f"obs_{j}"] = float(x)
            ep_rows.append(row)
            obs = nxt
            t += 1
        # discounted return-to-go per step
        g = 0.0
        for row in reversed(ep_rows):
            g = row["reward"] + gamma * g
            row["return_to_go"] = g
        returns.append(sum(r["reward"] for r in ep_rows))
        rows.extend(ep_rows)
    env.close()
    ds = rt_data.from_items(rows)
    files = ds.write_parquet(path)
    return {
        "episodes": num_episodes, "steps": len(rows), "files": len(files),
        "mean_return": float(np.mean(returns)),
    }


def read_experiences(path, *, columns: Optional[List[str]] = None):
    """Offline experiences as a Dataset (reference: OfflineData.__init__
    ray.data.read_parquet)."""
    from ray_tpu_torch import data as rt_data

    return rt_data.read_parquet(path, columns=columns)


def batch_to_numpy(batch: dict) -> dict:
    """Column batch -> dense numpy arrays; obs_0..obs_{d-1} scalar columns
    reassemble into one (B, d) "obs" matrix."""
    out = {}
    obs_cols = {}
    for k, v in batch.items():
        if k.startswith("obs_"):
            obs_cols[int(k[4:])] = np.asarray(v, np.float32)
        else:
            out[k] = np.asarray(v)
    if obs_cols:
        out["obs"] = np.stack(
            [obs_cols[i] for i in sorted(obs_cols)], axis=1)
    return out

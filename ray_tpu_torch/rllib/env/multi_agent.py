"""Multi-agent environments + runner, the port of
``ray_tpu/rllib/env/multi_agent.py`` (reference:
rllib/env/multi_agent_env.py:32 MultiAgentEnv,
rllib/env/multi_agent_env_runner.py:55 MultiAgentEnvRunner).

The env speaks per-agent dicts: reset() -> (obs_dict, info_dict);
step(action_dict) -> (obs, rewards, terminateds, truncateds, infos) dicts,
with terminateds/truncateds carrying the "__all__" key. A
policy_mapping_fn routes each agent id to a policy id; the runner
collects one GAE-processed batch PER POLICY so heterogeneous policies
train independently (shared policies simply map several agents to one
id).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.core._numpy_policy import numpy_forward, sample_actions
from ray_tpu_torch.rllib.env._classic_control import make


class MultiAgentEnv:
    """Base class for dict-of-agents environments."""

    #: ids of every agent that may ever appear
    possible_agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]) -> Tuple[
        Dict[str, np.ndarray], Dict[str, float], Dict[str, bool],
        Dict[str, bool], Dict[str, dict],
    ]:
        raise NotImplementedError

    def observation_space_shape(self, agent_id: str) -> tuple:
        raise NotImplementedError

    def action_space_n(self, agent_id: str) -> int:
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPoles under one multi-agent wrapper — the
    standard smoke env (reference: rllib/env/tests use the same shape).
    The episode ends (__all__) when every sub-episode has ended; finished
    agents stop emitting observations until the joint reset."""

    def __init__(self, num_agents: int = 2, seed: int = 0):
        self.possible_agents = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {
            aid: make("CartPole-v1") for aid in self.possible_agents
        }
        self._done: Dict[str, bool] = {}
        self._seed = seed

    def reset(self, *, seed=None):
        obs, infos = {}, {}
        base = self._seed if seed is None else seed
        for i, (aid, env) in enumerate(self._envs.items()):
            o, info = env.reset(seed=base + i)
            obs[aid] = np.asarray(o, np.float32)
            infos[aid] = info
            self._done[aid] = False
        self._seed = base + len(self._envs)
        return obs, infos

    def step(self, action_dict):
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for aid, action in action_dict.items():
            if self._done.get(aid):
                continue
            o, r, term, trunc, info = self._envs[aid].step(int(action))
            rewards[aid] = float(r)
            terms[aid] = bool(term)
            truncs[aid] = bool(trunc)
            infos[aid] = info
            if term or trunc:
                self._done[aid] = True
            else:
                obs[aid] = np.asarray(o, np.float32)
        all_done = all(self._done.values())
        terms["__all__"] = all_done
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, infos

    def observation_space_shape(self, agent_id):
        return self._envs[agent_id].observation_space.shape

    def action_space_n(self, agent_id):
        return int(self._envs[agent_id].action_space.n)


class MultiAgentEnvRunner:
    """Steps one MultiAgentEnv, routing each agent's observations through
    its mapped policy and returning a GAE batch PER POLICY (reference:
    multi_agent_env_runner.py:55; GAE segmentation follows each agent's
    own episode boundaries)."""

    def __init__(self, env_creator: Callable[[], MultiAgentEnv],
                 policy_mapping_fn: Callable[[str], str], *,
                 gamma: float, lambda_: float, seed: int = 0):
        self.env = env_creator()
        self.policy_of = policy_mapping_fn
        self.gamma = gamma
        self.lambda_ = lambda_
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def spaces(self) -> Dict[str, tuple]:
        """policy_id -> (obs_dim, num_actions), derived from its agents."""
        out = {}
        for aid in self.env.possible_agents:
            pid = self.policy_of(aid)
            dims = (
                int(np.prod(self.env.observation_space_shape(aid))),
                self.env.action_space_n(aid),
            )
            if pid in out and out[pid] != dims:
                raise ValueError(
                    f"policy {pid!r} maps agents with different spaces"
                )
            out[pid] = dims
        return out

    def sample(self, params_by_policy: Dict[str, Any], rollout_len: int
               ) -> Dict[str, Dict[str, np.ndarray]]:
        # per-agent transition streams; flattened per policy at the end
        streams: Dict[str, Dict[str, list]] = {
            aid: {"obs": [], "actions": [], "logp": [], "rewards": [],
                  "values": [], "dones": []}
            for aid in self.env.possible_agents
        }
        self._completed = []
        for _ in range(rollout_len):
            live = list(self.obs.keys())
            if not live:
                self.obs, _ = self.env.reset()
                live = list(self.obs.keys())
            actions: Dict[str, int] = {}
            for aid in live:
                params = params_by_policy[self.policy_of(aid)]
                logits, v = numpy_forward(params, self.obs[aid][None])
                act, logp = sample_actions(self.rng, logits)
                actions[aid] = int(act[0])
                s = streams[aid]
                s["obs"].append(self.obs[aid])
                s["actions"].append(int(act[0]))
                s["logp"].append(float(logp[0]))
                s["values"].append(float(v[0]))
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            for aid in live:
                done = terms.get(aid, False) or truncs.get(aid, False)
                streams[aid]["rewards"].append(rewards.get(aid, 0.0))
                streams[aid]["dones"].append(float(done))
                self._episode_return += rewards.get(aid, 0.0)
            if terms.get("__all__") or truncs.get("__all__"):
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                next_obs, _ = self.env.reset()
            self.obs = next_obs

        out: Dict[str, Dict[str, list]] = {}
        for aid, s in streams.items():
            if not s["obs"]:
                continue
            # bootstrap with V(s_T) when the agent's episode is still live
            last_v = 0.0
            if aid in self.obs and s["dones"] and not s["dones"][-1]:
                params = params_by_policy[self.policy_of(aid)]
                _, v = numpy_forward(params, self.obs[aid][None])
                last_v = float(v[0])
            batch = self._gae(s, last_v)
            pid = self.policy_of(aid)
            dest = out.setdefault(pid, {k: [] for k in batch})
            for k, v in batch.items():
                dest[k].append(v)
        result = {
            pid: {k: np.concatenate(v) for k, v in parts.items()}
            for pid, parts in out.items()
        }
        for pid in result:
            result[pid]["episode_returns"] = np.asarray(
                self._completed, np.float32
            )
        return result

    def _gae(self, s: Dict[str, list], last_v: float
             ) -> Dict[str, np.ndarray]:
        T = len(s["obs"])
        rew = np.asarray(s["rewards"], np.float32)
        val = np.asarray(s["values"], np.float32)
        done = np.asarray(s["dones"], np.float32)
        adv = np.zeros(T, np.float32)
        lastgae = 0.0
        for t in reversed(range(T)):
            nonterminal = 1.0 - done[t]
            next_v = val[t + 1] if t + 1 < T else last_v
            delta = rew[t] + self.gamma * next_v * nonterminal - val[t]
            lastgae = delta + self.gamma * self.lambda_ * nonterminal * lastgae
            adv[t] = lastgae
        return {
            "obs": np.asarray(s["obs"], np.float32),
            "actions": np.asarray(s["actions"], np.int64),
            "logp_old": np.asarray(s["logp"], np.float32),
            "advantages": adv,
            "returns": adv + val,
        }

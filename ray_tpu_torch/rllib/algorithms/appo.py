"""APPO: asynchronous PPO on the IMPALA execution plan, the port of
``ray_tpu/rllib/algorithms/appo.py``.

Reference: rllib/algorithms/appo/appo.py:277 — APPO subclasses IMPALA's
config/execution (decoupled env runners, continuous learner) and swaps the
loss for the target-network clipped surrogate (core/appo_learner.py). The
only engine-visible differences are the extra training knobs and the
learner class.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.use_kl_loss = False
        self.kl_coeff = 1.0
        # target net refresh cadence, in learner updates (reference:
        # appo.py target_network_update_freq, expressed there in env steps)
        self.target_update_freq = 8

    def training(self, *, clip_param=None, use_kl_loss=None, kl_coeff=None,
                 target_update_freq=None, **kwargs) -> "APPOConfig":
        super().training(**kwargs)
        for name, val in [
            ("clip_param", clip_param), ("use_kl_loss", use_kl_loss),
            ("kl_coeff", kl_coeff),
            ("target_update_freq", target_update_freq),
        ]:
            if val is not None:
                setattr(self, name, val)
        return self

    def _learner_path(self) -> str:
        return "ray_tpu_torch.rllib.core.appo_learner:AppoLearner"

    def _extra_learner_kwargs(self) -> dict:
        return {
            "clip_param": self.clip_param,
            "use_kl_loss": self.use_kl_loss,
            "kl_coeff": self.kl_coeff,
            "target_update_freq": self.target_update_freq,
        }

    def build(self) -> "APPO":
        assert self.env_name, "call .environment(env_name) first"
        return APPO(self)


class APPO(IMPALA):
    pass
